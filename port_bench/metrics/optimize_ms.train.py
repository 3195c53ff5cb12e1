"""Host ms of the ppo.optimize span per iteration of the window, as the
program's PPO.train times it (its optimize_time)."""


def read(ctx):
    its = ctx["iterations"]
    return 1e3 * sum(m["optimize_time"] for m in its) / len(its)
