"""The bytes ``batch_to`` moved to the device in the traced window (the
program's ``h2d_bytes`` samples, stamped on the profiler's clock and kept
between the window's bounds) over the host seconds inside its
``data/batch_to`` ranges, in GB/s."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.count("data/batch_to"):
        return None
    try:
        from unipre3d_tpu_torch.telemetry import SAMPLES
    except ImportError:
        return None
    moved = sum(v for t, v in SAMPLES.get("h2d_bytes", ())
                if tr.t0 <= t <= tr.t1)
    seconds = sum(e - s for s, e in tr.by_name["data/batch_to"]
                  if tr.t0 <= s and e <= tr.t1) * 1e-9
    if not moved or not seconds:
        return None
    return moved / seconds / 1e9
