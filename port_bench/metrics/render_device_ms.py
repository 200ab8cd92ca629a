"""Device time of the operations launched inside the program's
``step/render`` range, per step, over the traced window."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.count("step/render"):
        return None
    return ctx.trace.device_s("step/render") * 1e3 / ctx.trace.count("step/render")
