"""95th percentile of every iteration's host time in the window (loader,
transfer, attach, step; the step ends reading its metrics, which waits
for the device)."""

import statistics


def read(ctx):
    if len(ctx.iter_ms) < 2:
        return None
    return statistics.quantiles(ctx.iter_ms, n=100)[94]
