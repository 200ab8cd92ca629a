"""Mean host time an iteration waits in the loader's ``next()`` (its
prefetch queue) over the window."""

import statistics


def read(ctx):
    return statistics.fmean(ctx.loader_ms) if ctx.loader_ms else None
