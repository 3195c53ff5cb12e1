"""Seconds from the process's start to the window's: imports, env, kernel
builds (a checkout's first run only), trainer, reset, warm-up iterations."""


def read(ctx):
    return ctx["setup_s"]
