"""Host ms of the ppo.sample span per iteration of the window, as the
program's PPO.train times it (its sample_time)."""


def read(ctx):
    its = ctx["iterations"]
    return 1e3 * sum(m["sample_time"] for m in its) / len(its)
