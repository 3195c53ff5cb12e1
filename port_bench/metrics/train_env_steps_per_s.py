"""Env-steps of the PPO iterations completed in the window over the time from
the window's start to the end of the last of them (host clock)."""


def read(ctx):
    return len(ctx["iterations"]) * ctx["env_steps_per_iteration"] / ctx["window_s"]
