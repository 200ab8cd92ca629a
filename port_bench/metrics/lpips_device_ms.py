"""Device time of the operations launched inside the program's
``step/lpips`` range, per step, over the traced window."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.count("step/lpips"):
        return None
    return ctx.trace.device_s("step/lpips") * 1e3 / ctx.trace.count("step/lpips")
