"""Device time of the operations launched inside the program's
``step/forward`` range, per step, over the traced window."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.count("step/forward"):
        return None
    return ctx.trace.device_s("step/forward") * 1e3 / ctx.trace.count("step/forward")
