"""Mean host time of a ``bench/step`` in the traced window less the time
it spends inside the program's ``sync/<site>`` ranges, in ms: the host's
own work of issuing the step, which sets the pace while the device
idles. It is the traced program's: the profiler's own per-operation work
makes up about half of it, so a gain read here counts only where it also
shows untraced, in ``train_samples_per_s``."""


def read(ctx):
    tr = ctx.trace
    steps = [] if tr is None else tr.by_name.get("bench/step", [])
    syncs = [] if tr is None else [
        iv for n, v in tr.by_name.items() if n.startswith("sync/")
        for iv in v]
    if not steps or not syncs:
        return None
    total = 0
    for s, e in steps:
        waited = sum(min(e, se) - max(s, ss) for ss, se in syncs
                     if ss < e and se > s)
        total += e - s - waited
    return total * 1e-6 / len(steps)
