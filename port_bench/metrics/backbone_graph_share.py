"""The share of the window's iterations whose object backbone replayed
its CUDA graphs: the program's ``graph/replay`` ranges (one a replayed
forward, unipre3d_tpu_torch/models/backbone_graph.py) in the traced
window per ``bench/step``, in %. None where the program opens no such
range."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.count("bench/step"):
        return None
    replays = [s for s, e in tr.by_name.get("graph/replay", [])
               if tr.t0 <= s and e <= tr.t1]
    if not replays:
        return None
    return 100.0 * len(replays) / tr.count("bench/step")
