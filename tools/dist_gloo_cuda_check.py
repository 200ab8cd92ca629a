#!/usr/bin/env python3
"""Two ranks on one card against one process: how gloo is handed the
card's tensors, and how far the runs part.

    python3 tools/dist_gloo_cuda_check.py [--repeats 2] [--ones 3]
        [--variants staged,direct,...] [--runs object_f32,scene_f32] [--warm]
        [--hold-gib N] [--out PATH]

Needs one CUDA card. Runs chip_smoke.py's float32 hold runs (the object
run and the full-width SparseUNet scene run, 3 steps each, at
chip_smoke.DIST_HOLD_LR) as two ranks of one gloo group on the card, each
rank a process running ``train_network.main``, under three ways of handing
gloo the collectives' CUDA tensors:

* ``staged``: a host copy made by hand (the collective then runs on the
  host, after a blocking copy out);
* ``direct``: the CUDA tensor itself, as the port does
  (parallel/distributed.py: ``_on_backend``; gloo's own CUDA path);
* ``direct_sync``: the CUDA tensor itself, with ``torch.cuda.synchronize()``
  before and after each ``all_reduce`` and ``broadcast``;
* ``sync_bwd`` / ``sync_main``: the same, only around the collectives that
  autograd's backward thread calls (the BatchNorm cotangents' sums), or
  only around those of the main thread (the forward's sums, the gradient
  all-reduce, the broadcasts).

``--warm`` runs, in each rank before the held runs, what chip_smoke.py's
ranks run before them: the default object run (bf16, the cache, global
batch 32) and ``eval.main`` over both ranks. ``--hold-gib N`` keeps N GiB
of the card allocated in this process while the ranks run, as
chip_smoke.py's own process holds what its earlier phases cached.

Each variant (``--variants``, default the first three) runs ``--repeats``
times, and each run ``--ones`` times in one process (this one). The staged
variant also runs the scene at the default learning rate (1e-4) unless
``--warm``. Prints, per run and variant, each repeat's per-step relative
gap of the loss and the gradient norm, and the parameters' mean
|difference| over lr after the last step, against every one-process run;
and the same between every pair of one-process runs (their own spread);
and, per repeat, the tensors whose Adam first moment after the last step
stands furthest from the first one-process run's.
A variant whose step-1 gaps stand above the one-process runs' own spread in
every repeat reads its collectives' tensors out of order. ``--out PATH``
also writes the whole table there as JSON.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

VARIANTS = ("staged", "direct", "direct_sync", "sync_bwd", "sync_main")
DEFAULT_LR_SCENE = ("scene_f32_lr1e-4", cs.SCENE_ARGV + [
    x for x in cs.DIST_SCENE_HOLD if x != cs.DIST_HOLD_LR])

WORKER = r"""
import json, os, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
a = json.loads(sys.argv[1])
from unipre3d_tpu_torch import parallel, train_network
from unipre3d_tpu_torch.parallel import distributed as tdist
if a["variant"] == "staged":
    tdist._on_backend = lambda t: t.cpu() if t.is_cuda else t.contiguous()
if a["variant"] in ("direct_sync", "sync_bwd", "sync_main"):
    import threading
    want = {"direct_sync": (True, False), "sync_bwd": (False,),
            "sync_main": (True,)}[a["variant"]]

    def synced_call(fn):
        def call(*args, **kw):
            on = (threading.current_thread() is threading.main_thread()) \
                in want
            if on:
                torch.cuda.synchronize()
            out = fn(*args, **kw)
            if on:
                torch.cuda.synchronize()
            return out
        return call
    tdist.dist.all_reduce = synced_call(tdist.dist.all_reduce)
    tdist.dist.broadcast = synced_call(tdist.dist.broadcast)
parallel.maybe_initialize()
r = parallel.process_index()
out = {}
if a["warm"]:
    from unipre3d_tpu_torch import eval as eval_cli
    label, argv = a["warm"]
    train_network.main(argv + [
        "--output-dir", os.path.join(a["base"], f"warm_r{r}"),
        f"opt.iterations={a['steps']}", "logging.loss_log=1",
        "logging.loop_log=100000"])
    torch.distributed.barrier()
    eval_cli.main([os.path.join(a["base"], "warm_r0")])
    torch.distributed.barrier()
for label, argv in a["runs"]:
    run_dir = os.path.join(a["base"], f"{label}_r{r}")
    res = train_network.main(argv + [
        "--output-dir", run_dir, f"opt.iterations={a['steps']}",
        "logging.loss_log=1", "logging.loop_log=100000"])
    out[label] = {"losses": res["losses"], "grad_norms": res["grad_norms"],
                  "dir": run_dir}
    torch.distributed.barrier()
with open(os.path.join(a["base"], f"rank{r}.json"), "w") as f:
    json.dump(out, f)
torch.distributed.destroy_process_group()
"""


def spawn(args, timeout=600):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    os.makedirs(args["base"], exist_ok=True)
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update({"UNIPRE3D_COORDINATOR": f"127.0.0.1:{port}",
                    "UNIPRE3D_NUM_PROCESSES": "2",
                    "UNIPRE3D_PROCESS_ID": str(rank),
                    "PYTHONPATH": REPO + os.pathsep
                    + env.get("PYTHONPATH", "")})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, json.dumps(args)], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SystemExit(f"rank {rank} exited {p.returncode}:\n"
                             f"{o[-4000:]}")
    return json.load(open(os.path.join(args["base"], "rank0.json")))


def gaps(a, b, lr):
    loss, gn, div = cs.run_gaps(a, b, a["dir"], b["dir"], lr)
    return {"loss": loss, "grad_norm": gn, "param_div_lr": div}


def adam_mu(run_dir):
    import numpy as np
    with np.load(os.path.join(run_dir, "model_latest.ckpt")) as z:
        return {k[len("adam_mu/"):]: z[k].astype(np.float64)
                for k in z.files if k.startswith("adam_mu/")}


def rel_l2(a, b):
    import numpy as np
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def tensor_gaps(mu, ref, own, top=8):
    """The tensors whose Adam first moment ``mu`` stands furthest from the
    first one-process run's (``ref``), among those the one-process runs
    agree on to 1e-2 (``own``, their largest rel L2; a gradient that is
    analytically zero is noise in every run): [(name, rel L2, own)]."""
    return sorted(((n, rel_l2(mu[n], ref[n]), own[n]) for n in ref
                   if own[n] < 1e-2), key=lambda t: -t[1])[:top]


def fmt(xs):
    return "[" + ", ".join(f"{x:.2e}" for x in xs) + "]"


def show(label, g):
    print(f"  {label}: loss {fmt(g['loss'])} grad norm "
          f"{fmt(g['grad_norm'])} params {g['param_div_lr']:.2e} lr",
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--ones", type=int, default=3)
    ap.add_argument("--variants", default=",".join(VARIANTS[:3]))
    ap.add_argument("--runs", default="object_f32,scene_f32")
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--hold-gib", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    variants = args.variants.split(",")

    import torch
    from unipre3d_tpu_torch import kernels, train_network
    from unipre3d_tpu_torch.training.config import load_config
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    t0 = time.time()
    for name in ("splat_dense", "splat_binned"):
        kernels.load(name)
    print(f"[build] {time.time() - t0:.1f} s on {smi}", flush=True)
    runs = [r for r in cs.DIST_RUNS if r[0] in args.runs.split(",")]
    warm = cs.DIST_RUNS[0] if args.warm else None
    extra = [] if args.warm else [DEFAULT_LR_SCENE]
    lrs = {label: float(load_config(argv[1], overrides=[
        x for x in argv[2:] if "=" in x]).opt.base_lr)
        for label, argv in runs + extra}
    table = {"own": {}, "ranks": {}, "tensors": {}}
    with tempfile.TemporaryDirectory(prefix="dist_gloo_") as tmp:
        ones, mus = {}, {}
        for label, argv in runs + extra:
            for i in range(args.ones):
                d = os.path.join(tmp, f"{label}_one{i}")
                res = train_network.main(argv + [
                    "--output-dir", d, f"opt.iterations={cs.DIST_STEPS}",
                    "logging.loss_log=1", "logging.loop_log=100000"])
                ones.setdefault(label, []).append(
                    {"losses": res["losses"],
                     "grad_norms": res["grad_norms"], "dir": d})
            table["own"][label] = [
                gaps(a, b, lrs[label])
                for a, b in itertools.combinations(ones[label], 2)]
            print(f"== {label} (lr {lrs[label]:g}), one process vs one "
                  f"process on {smi}", flush=True)
            for g in table["own"][label]:
                show("own", g)
            mus[label] = [adam_mu(o["dir"]) for o in ones[label]]
        held = torch.empty(int(args.hold_gib * 2 ** 30), dtype=torch.uint8,
                           device="cuda") if args.hold_gib else None
        if held is not None:
            print(f"[hold] {args.hold_gib:g} GiB held in this process; "
                  f"reserved {torch.cuda.memory_reserved() / 2 ** 30:.2f} "
                  f"GiB", flush=True)
        for i in range(args.repeats):
            for variant in variants:
                t = time.time()
                plan = runs + (extra if variant == "staged" else [])
                out = spawn({"base": os.path.join(tmp, f"{variant}{i}"),
                             "runs": plan, "steps": cs.DIST_STEPS,
                             "variant": variant, "warm": warm})
                print(f"== {variant} repeat {i} ({time.time() - t:.1f} s"
                      f"{', after the warm-up' if warm else ''}) vs each "
                      f"one-process run on {smi}", flush=True)
                for label, res in out.items():
                    rows = [gaps(res, one, lrs[label])
                            for one in ones[label]]
                    table["ranks"].setdefault(label, {}).setdefault(
                        variant, []).append(rows)
                    for g in rows:
                        show(label, g)
                    ref, rest = mus[label][0], mus[label][1:]
                    if rest:
                        own = {n: max(rel_l2(m[n], ref[n]) for m in rest)
                               for n in ref}
                        top = tensor_gaps(adam_mu(res["dir"]), ref, own)
                        table["tensors"].setdefault(label, {}).setdefault(
                            variant, []).append(top)
                        print(f"  {label} tensors furthest from one "
                              f"process's (Adam first moment, rel L2; one "
                              f"process's own): " + "; ".join(
                                  f"{n} {g:.2e} ({o:.1e})"
                                  for n, g, o in top), flush=True)
                    # the checkpoints count against the machine's disk
                    for f in os.listdir(res["dir"]):
                        if f.endswith(".ckpt"):
                            os.remove(os.path.join(res["dir"], f))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "gaps": table}, f, indent=1)
    print(f"[done] {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
