"""The benchmark of the PyTorch/CUDA port (``unipre3d_tpu_torch``).

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Finds the cell in ``BENCHMARK.json``, its configuration in
``port_bench/configs/<config>.json`` and its traffic in
``port_bench/traffic/<mix>.json``; makes the weights and the traffic from
``--seed`` on the card; builds the port's training state, feature cache,
loader and step (driver.py) and runs the first three iterations, which
warm every shape of the cell and are kept for the correctness check;
then measures the port's pretraining iteration for ``--seconds``. With
``--trace 1`` the window runs under ``torch.profiler`` and the cell's
per-layer metrics are reported, with ``--trace 0`` its end-to-end ones;
each metric is read by ``port_bench/metrics/<metric>.py``. After the
window the plain reference (port_bench/reference/) follows the same three
steps and check.py compares them, against the limits in
``port_bench/limits/<cell>.json``. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit; the same numbers are the last lines of
standard error. A run without a CUDA card, or with fewer than the cell
asks for, exits 1 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
CACHE = REPO / ".port_bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "unipre3d_tpu")
CHECK_STEPS = 3
# in a traced window, iterations k with k % OBSERVE_EVERY == OBSERVE_AT keep
# their gaussians and batch for the readers that need the work of a step
OBSERVE_EVERY, OBSERVE_AT = 12, 4


def set_environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    one OpenMP thread (the host work of the loop is Python and copies:
    idle worker pools only take cores from it). The process keeps the
    cores it was given."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["OMP_NUM_THREADS"] = "1"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(items, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def card_lines() -> list:
    """nvidia-smi's name, power limit, clocks and temperature of the cards."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi: {e}"]
    return [f"nvidia-smi: {line}" for line in out.stdout.strip().splitlines()]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def window(prog, seconds: float, trace: bool, sync):
    """Iterate for ``seconds``, then ``sync``; -> (iteration ms list,
    samples, window s, profiler or None, nan-skipped steps, observed
    steps). In a traced window every OBSERVE_EVERY-th iteration keeps its
    host batch and gaussians (``{"index", "batch", "gaussians"}``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    prof = None
    if trace:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    iter_ms, samples, skipped, steps = [], 0, 0, []
    prog.loader_ms.clear()
    batch = int(prog.spec["batch_size"])
    try:
        with record_function("bench/window"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                t = time.perf_counter()
                k = len(iter_ms)
                if trace and k % OBSERVE_EVERY == OBSERVE_AT:
                    host, seen, metrics = prog.observed_iterate(
                        renders=False)
                    steps.append({"index": k, "batch": host,
                                  "gaussians": seen.get("gaussians")})
                else:
                    _, _, metrics = prog.iterate()
                iter_ms.append((time.perf_counter() - t) * 1e3)
                samples += batch
                skipped += int(metrics["nan_skipped"])
            sync()
            window_s = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    return iter_ms, samples, window_s, prof, skipped, steps


def measure(spec: dict, mix: dict, cell: dict, names: list, units: dict,
            limits, seed: int, seconds: float, trace: bool, device,
            wrap_step=None):
    """One run of a cell on ``device`` -> (the result object, the earlier
    lines of standard output, the check's lines of standard error).
    ``wrap_step`` (tests) replaces the program's step by a broken one."""
    import torch
    from port_bench import check, driver, trace as trace_lib
    readers = {n: load_reader(n) for n in names}
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    prog = driver.Program(spec, mix, seed, device, wrap_step=wrap_step)
    first = prog.check_steps(CHECK_STEPS)
    counts0 = prog.cache_counts()
    sync()
    setup_s = time.perf_counter() - T_START
    iter_ms, samples, window_s, prof, skipped, steps = window(
        prog, seconds, trace, sync)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    counts1 = prog.cache_counts()
    loader_ms = list(prog.loader_ms)
    valid_rows = list(prog.valid_rows)
    prog.close()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"port_bench: the process holds {found}")
    tr = trace_lib.from_profiler(prof) if prof is not None else None
    del prof

    # the program's state goes before the reference runs
    weights = driver.predictor_weights(spec, seed, device)
    prog_side = driver.program_readings(first, weights)
    batches = first["batches"]
    del prog, first, weights
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    counter = {}
    ref_side = driver.reference_readings(spec, mix, seed, batches, device,
                                         counter=counter,
                                         gaussians=prog_side["gaussians"])
    values = check.readings(prog_side, ref_side)
    correct, rows = check.decide(values, limits)

    # what the readers read: the window's clocks, counters and trace, the
    # cell, its reference, the checked batches and the observed window steps
    ctx = SimpleNamespace(
        samples=samples, window_s=window_s, iter_ms=iter_ms,
        loader_ms=loader_ms, setup_s=setup_s, trace=tr,
        chips=int(cell["chips"]),
        cache_window=None if counts0 is None else
        {k: counts1[k] - counts0[k] for k in counts0},
        spec=spec, mix=mix, device=device,
        reference=driver.reference_of(spec), batches=batches,
        window_steps=steps)
    metrics = {}
    for name, read in readers.items():
        value = read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}

    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    lines = card_lines() if on_card else []
    lines += [f"device: {kind}, peak {peak} bytes ({peak / 2**30:.3f} GiB)",
              f"setup_s {setup_s!r}; window {window_s!r} s, "
              f"{len(iter_ms)} iterations, {samples} samples",
              f"losses: program {prog_side['losses']} reference "
              f"{ref_side['losses']}"]
    if tr is not None:
        linked = sum(op[3] is not None for op in tr.ops)
        lines.append(f"trace: {len(tr.ops)} device operations in the "
                     f"window, {linked} with their launch; ranges "
                     f"{ {k: len(v) for k, v in tr.by_name.items()} }")
    q = max(1, len(iter_ms) // 10)
    lines.append(f"iteration ms: first tenth {sum(iter_ms[:q]) / q!r}, "
                 f"last tenth {sum(iter_ms[-q:]) / q!r}")
    if valid_rows:
        lines.append(f"valid rows a scene (grid-sampled cloud), every "
                     f"batch of the run: min {min(valid_rows)} median "
                     f"{sorted(valid_rows)[len(valid_rows) // 2]} max "
                     f"{max(valid_rows)} over {len(valid_rows)} scenes")
    if "valid_rows" in counter or "tile_dropped" in counter:
        lines.append(f"reference, check steps: fine-level valid rows "
                     f"{counter.get('valid_rows')}, the tiled renderer's "
                     f"(tile, gaussian) overlaps past its capacity "
                     f"{counter.get('tile_dropped')}")
    if counts0 is not None:
        lines.append(f"feature cache over the window: {ctx.cache_window}; "
                     f"since start {counts1}")
    result = {"correct": bool(correct), "attempted": len(iter_ms),
              "failed": skipped, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": kind, "count": int(cell["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    lines.append("read, not compared (no limit): " + ", ".join(
        f"{k} {v!r}" for k, v, lim in rows if lim is None))
    rows = [r for r in rows if r[2] is not None]
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    err = [f"check {k} {v!r} limit {lim!r}" for k, v, lim in rows]
    err.append(f"check correct {bool(correct)}")
    return result, lines, err


def main(argv=None) -> int:
    args = parse_args(argv)
    set_environment()
    sys.path.insert(0, str(REPO))
    manifest = load_json(REPO / "BENCHMARK.json")
    cell = find(manifest["workloads"], args.workload, "workload")
    cfg_entry = find(manifest["configs"], cell["config"], "config")
    spec = load_json(REPO / cfg_entry["file"])
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits_path = BENCH / "limits" / f"{cell['name']}.json"
    limits = load_json(limits_path) if limits_path.exists() else None
    mode = "per_layer" if args.trace else "end_to_end"
    names = [m["name"] for m in manifest[mode]
             if cell["name"] in m.get("workloads", [cell["name"]])]
    units = {m["name"]: m["unit"] for m in manifest[mode]}

    import torch
    torch.set_num_threads(1)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 1
    program = importlib.util.find_spec("unipre3d_tpu_torch")
    if program is None or REPO not in Path(program.origin).resolve().parents:
        print(f"port_bench: no unipre3d_tpu_torch in the checkout {REPO}",
              file=sys.stderr)
        return 1
    result, lines, err = measure(spec, mix, cell, names, units, limits,
                                 args.seed, args.seconds, bool(args.trace),
                                 torch.device("cuda", 0))
    print("\n".join(lines), flush=True)
    print("\n".join(err), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
