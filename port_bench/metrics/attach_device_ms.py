"""Device time of the operations launched inside the harness's
``bench/attach`` range (the feature cache: hashing is host work, the VAE
on the misses and the slot gathers are device work), per iteration."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.count("bench/attach"):
        return None
    return ctx.trace.device_s("bench/attach") * 1e3 / ctx.trace.count(
        "bench/attach")
