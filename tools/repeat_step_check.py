"""Does a one-process train run repeat itself on the card, and where does
it first part if not?

    python3 tools/repeat_step_check.py [--plain 4] [--traced 3] \
        [--config mamba3d_pretraining] [--out repeat.json]

Runs ``dryrun_multichip.run_steps`` of a config (by default chip_smoke.py's
float32 Mamba3D hold: synthetic data, lr 1e-8, 3 steps) ``--plain`` times
as it is, then ``--traced`` times with every module's output, the
parameters at each step's start, FPS, kNN, the dense splat's depth-sorted
table and rendered images, the supervision renders and the loss recorded
in execution order. Each traced run is compared with the first record by
record: the first record whose bits differ, the parameters that differ,
the relative differences above 1e-5 in execution order (where a gap grows
at once, a discrete choice shows), and for index tensors how many entries
differ. Prints one JSON line per run; ``--out`` keeps them all.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from unipre3d_tpu_torch import dryrun_multichip as dr  # noqa: E402
from unipre3d_tpu_torch.models import mamba3d  # noqa: E402
from unipre3d_tpu_torch.ops import point_ops  # noqa: E402
from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd  # noqa: E402
from unipre3d_tpu_torch.training import trainer  # noqa: E402
from unipre3d_tpu_torch.training.config import load_config  # noqa: E402


class Recorder:
    """The records of one run: (step, name, digest, tensor on the host)."""

    def __init__(self):
        self.step = 0
        self.records = []

    def add(self, name, out):
        ts = [out] if isinstance(out, torch.Tensor) else [
            t for t in (out.values() if isinstance(out, dict) else out
                        if isinstance(out, (tuple, list)) else [])
            if isinstance(t, torch.Tensor)]
        for i, t in enumerate(ts):
            h = t.detach().contiguous().cpu()
            digest = hashlib.sha1(
                h.view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()
            self.records.append((self.step, f"{name}[{i}]", digest, h))


REC = None


def wrap(module, name):
    real = getattr(module, name)

    def f(*a, **k):
        out = real(*a, **k)
        if REC is not None:
            REC.add(f"{module.__name__.split('.')[-1]}.{name}", out)
        return out
    setattr(module, name, f)


def traced_state(real):
    def create(cfg, **kw):
        model, state = real(cfg, **kw)

        def pre(mod, args, kwargs):
            if REC is None:
                return
            REC.step += 1
            for n, p in mod.named_parameters():
                REC.add(f"param {n}", p)
            for i, a in enumerate(args):
                if isinstance(a, torch.Tensor):
                    REC.add(f"input {i}", a)

        model.register_forward_pre_hook(pre, with_kwargs=True)
        for n, m in model.named_modules():
            if n and not n.startswith("image_network."):
                m.register_forward_hook(
                    lambda mod, a, out, n=n: REC and REC.add(n, out))
        return model, state
    return create


def compare(ref, run):
    """The first record whose bits differ; the parameters whose bits
    differ (count, the five largest relative gaps); the largest gap of
    the other records (relative to the reference's largest magnitude) and
    every one more than 1e-5 apart, in execution order with its share of
    entries more than 1e-5 apart, the first 100: where a gap grows at
    once, a discrete choice shows; and
    for index tensors how many entries differ."""
    first_bits = None
    params, far, index_diffs = [], [], []
    largest = [None, None, 0.0]
    for (s, n, h, t), (s2, n2, h2, t2) in zip(ref, run):
        if (s, n) != (s2, n2) or t.shape != t2.shape:
            return {"order differs at": [s, n, s2, n2]}
        if h == h2:
            continue
        if first_bits is None:
            first_bits = [s, n]
        if not t.is_floating_point():
            index_diffs.append([s, n, int((t != t2).sum()), t.numel()])
            continue
        d = (t.double() - t2.double()).abs()
        scale = t.double().abs().max() + 1e-30
        rel = float(d.max() / scale)
        if not n.startswith("param ") and rel > largest[2]:
            largest = [s, n, rel]
        if n.startswith("param "):
            params.append([s, n, rel, int((d > 0).sum())])
        elif rel > 1e-5:
            far.append([s, n, rel, float((d / scale > 1e-5).double().mean())])
    return {"first bits": first_bits, "params differ": len(params),
            "largest param gaps": sorted(params, key=lambda x: -x[2])[:5],
            "largest other gap": largest, "records > 1e-5": far[:100],
            "index diffs": index_diffs[:40]}


def main():
    global REC
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="mamba3d_pretraining")
    p.add_argument("--plain", type=int, default=4)
    p.add_argument("--traced", type=int, default=3)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("overrides", nargs="*",
                   help="further config overrides (a small CPU check)")
    a = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    over = ["data.dataset_root=synthetic", chip_smoke.DIST_HOLD_LR] + \
        chip_smoke.FLOAT32_PINS + a.overrides
    cfg = load_config(a.config, overrides=over)
    dev = torch.cuda.get_device_name(0) if a.device == "cuda" else a.device
    result = {"config": a.config, "overrides": over, "device": dev,
              "plain": [], "traced": []}
    for _ in range(a.plain):
        r = dr.run_steps(cfg, 1, a.steps, device=a.device)
        result["plain"].append(r["losses"])
        print(json.dumps({"plain losses": r["losses"],
                          "grad norms": r["grad_norms"]}), flush=True)
    for name in ("furthest_point_sample", "knn"):
        wrap(point_ops, name)
    mamba3d.knn = point_ops.knn
    for name in ("sorted_table", "dense_fwd"):
        wrap(sd, name)
    for name in ("render_supervision_views", "compute_loss"):
        wrap(trainer, name)
    dr.create_train_state = traced_state(dr.create_train_state)
    ref = None
    for i in range(a.traced):
        REC = Recorder()
        r = dr.run_steps(cfg, 1, a.steps, device=a.device)
        rec, REC = REC.records, None
        line = {"traced losses": r["losses"], "grad norms": r["grad_norms"],
                "records": len(rec)}
        if ref is None:
            ref = rec
        else:
            line.update(compare(ref, rec))
        result["traced"].append(line)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
