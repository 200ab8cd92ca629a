"""The dense splat pair's share of its roofline over the traced window,
in percent: over the launches of the observed steps (every
``run.OBSERVE_EVERY``-th iteration of the window keeps its gaussians and
batch), the summed least times (counts/splat_dense.py, with the
contributing pairs that the reference counts over that step's own
gaussians) over their summed device time. Launches of the other steps,
whose pairs nobody counted, are left out."""

from port_bench.counts import splat_dense


def read(ctx):
    shape = splat_dense.shape_of(ctx.spec)
    if ctx.trace is None or shape is None or not ctx.window_steps:
        return None
    least = spent = 0.0
    for step in ctx.window_steps:
        ops = ctx.trace.nth_launched_in("bench/step", step["index"])
        if not ops or step["gaussians"] is None:
            continue
        pairs = splat_dense.pairs(ctx.spec, step["gaussians"], step["batch"],
                                  ctx.device)
        for direction, kernel in splat_dense.KERNELS.items():
            for name, _, dur, _ in ops:
                if kernel in name:
                    least += splat_dense.least_seconds(direction, *shape,
                                                       pairs)
                    spent += dur * 1e-9
    return 100.0 * least / spent if spent else None
