"""Device time of the operations launched inside the harness's
``bench/geometry`` range (the scene's index structures, built before the
step), per iteration."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.count("bench/geometry"):
        return None
    return ctx.trace.device_s("bench/geometry") * 1e3 / ctx.trace.count(
        "bench/geometry")
