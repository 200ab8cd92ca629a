"""Readings that the correctness limits are set from (not run by the
benchmark's own runs).

    python3 port_bench/calibrate.py --workload <cell> --seeds S1 S2 ... \
        [--control K] [--half-batch K] [--float32 K] [--out FILE]

For each seed: the program's first steps (the benchmark's own setup and
check steps) against the float32 reference (the lower readings), every
number of check.py, step 1's gaussians and renders per sample among them;
for the first K seeds also the control, the reference computed in fp8
(precision.py), against the float32 reference; the program with half of
each batch left out of its step (the mean taken over the rest); and the
program computing in float32 with the VAE live (a witness of how far two
float32 computations part). A state left unchanged reads 1 on
``update_worst`` by definition and needs no run. One JSON line a (seed,
kind) on standard output, and under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))

from port_bench import check, driver, run  # noqa: E402


def halve(batch):
    """Every tensor's first half along the batch axis."""
    return {k: halve(v) if isinstance(v, dict) else v[:v.shape[0] // 2]
            for k, v in batch.items()}


def half_batch(step):
    return lambda state, batch: step(state, halve(batch))


def program_side(spec, mix, seed, device, wrap_step=None):
    prog = driver.Program(spec, mix, seed, device, wrap_step=wrap_step)
    first = prog.check_steps(run.CHECK_STEPS)
    prog.close()
    weights = driver.predictor_weights(spec, seed, device)
    side = driver.program_readings(first, weights)
    side["grad_norm"] = first["grad_norm"][0]
    return side, first["batches"]


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--half-batch", type=int, default=0)
    p.add_argument("--float32", type=int, default=0,
                   help="for the first K seeds also the program computing in "
                        "float32 with the VAE run live (a witness)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    run.set_environment()
    manifest = run.load_json(BENCH.parent / "BENCHMARK.json")
    cell = run.find(manifest["workloads"], args.workload, "workload")
    entry = run.find(manifest["configs"], cell["config"], "config")
    spec = run.load_json(BENCH.parent / entry["file"])
    mix = run.load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(args.seeds):
            t = time.perf_counter()
            prog, batches = program_side(spec, mix, seed, device)
            ref = driver.reference_readings(spec, mix, seed, batches, device)
            rows = [("program", prog)]
            if i < args.control:
                rows.append(("control", driver.reference_readings(
                    spec, mix, seed, batches, device, rounding="fp8")))
            if i < args.float32:
                f32 = json.loads(json.dumps(spec))
                f32.update(compute_dtype="float32", vae_cache_entries=0)
                f32["program"]["overrides"] += ["tpu.compute_dtype=float32",
                                                "tpu.vae_cache_entries=0"]
                rows.append(("program_float32", program_side(
                    f32, mix, seed, device)[0]))
            if i < args.half_batch:
                rows.append(("half_batch", program_side(
                    spec, mix, seed, device, wrap_step=half_batch)[0]))
            for kind, side in rows:
                ref["splat_renders"] = driver.splat_renders(
                    spec, side.get("gaussians"), batches[0], device)
                values = check.readings(side, ref)
                if kind == "program" and ref["splat_renders"] is not None:
                    # the render stage's control: the plain renderer over
                    # the program's gaussians rounded to bfloat16
                    low = driver.splat_renders(
                        spec, {k: v.bfloat16().float()
                               if v.is_floating_point() else v
                               for k, v in side["gaussians"].items()},
                        batches[0], device)
                    values["splat_control"] = max(check.sample_gaps(
                        low.flatten(0, 1),
                        ref["splat_renders"].flatten(0, 1)))
                line = json.dumps({"workload": args.workload, "seed": seed,
                                   "kind": kind, "values": values,
                                   "grad_norm": side.get("grad_norm"),
                                   "grad_norm_ref": ref["grad_norm"],
                                   "losses_ref": ref["losses"],
                                   "seconds": time.perf_counter() - t})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
            del prog, batches, ref
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
