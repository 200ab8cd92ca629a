"""The program's ``sync/<site>`` ranges (each a place where the host
waits for the device) in the traced window, per ``bench/step``."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.count("bench/step"):
        return None
    syncs = [s for n, v in tr.by_name.items() if n.startswith("sync/")
             for s, e in v if tr.t0 <= s and e <= tr.t1]
    if not syncs:
        return None
    return len(syncs) / tr.count("bench/step")
