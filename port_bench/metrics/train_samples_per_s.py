"""Training samples completed in the window over the window's seconds
(host clock; the window ends with a synchronize)."""


def read(ctx):
    return ctx.samples / ctx.window_s
