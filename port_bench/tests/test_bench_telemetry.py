"""The readers of the program's spans and counters (unipre3d_tpu_torch/
telemetry.py), on hand-built traces: each divides by the window's
iterations, keeps to the window's bounds, subtracts the host's waits where
it should, and reads nothing (None) where the program has no such span or
counter, as a program without the telemetry has not. On a card (``cuda``):
in a short traced window of each cell the ``backward/*`` regions hold at
least 95% of the device time launched inside ``step/backward``, and the
``h2d_bytes`` stamps fall inside ``data/batch_to`` ranges."""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from port_bench.trace import Trace

REPO = Path(__file__).resolve().parents[2]
MS = 1_000_000   # ns


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "port_bench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ctx_of(ranges, ops=(), t0=0, t1=1000 * MS, **kw):
    return SimpleNamespace(trace=Trace(list(ranges), list(ops), t0, t1),
                           **kw)


def test_vae_ms_per_miss_is_over_the_windows_misses():
    ranges = [("cache/vae", 0, 10 * MS), ("cache/vae", 20 * MS, 30 * MS)]
    ops = [("conv", 5 * MS, 2 * MS, 5 * MS), ("conv", 25 * MS, 4 * MS,
                                               25 * MS),
           ("gather", 40 * MS, 9 * MS, 40 * MS)]
    ctx = ctx_of(ranges, ops, cache_window={"hits": 1, "l2_hits": 0,
                                            "misses": 3})
    assert reader("vae_ms_per_miss")(ctx) == pytest.approx(6.0 / 3)
    for window in (None, {"hits": 4, "l2_hits": 0, "misses": 0}):
        ctx.cache_window = window
        assert reader("vae_ms_per_miss")(ctx) is None
    assert reader("vae_ms_per_miss")(ctx_of(
        [], ops, cache_window={"hits": 0, "l2_hits": 0, "misses": 3})) is None


def test_backward_device_ms_sums_the_regions_per_step():
    # the device time of step/backward, which the regions tile
    ranges = [("bench/step", 0, 100 * MS), ("bench/step", 200 * MS, 300 * MS),
              ("step/backward", 10 * MS, 60 * MS),
              ("backward/render", 11 * MS, 20 * MS),
              ("backward/transformer", 20 * MS, 59 * MS),
              ("step/backward", 210 * MS, 260 * MS),
              ("backward/render", 211 * MS, 259 * MS)]
    ops = [("a", 12 * MS, 1 * MS, 12 * MS), ("b", 30 * MS, 3 * MS, 30 * MS),
           ("c", 215 * MS, 4 * MS, 215 * MS),
           ("optimizer", 70 * MS, 50 * MS, 70 * MS)]
    assert reader("backward_device_ms")(ctx_of(ranges, ops)) == \
        pytest.approx(8.0 / 2)
    # a program without the regions (the parent's) reads the same
    assert reader("backward_device_ms")(ctx_of(
        [r for r in ranges if not r[0].startswith("backward/")], ops)) == \
        pytest.approx(8.0 / 2)
    assert reader("backward_device_ms")(ctx_of(ranges[:2], ops)) is None


def test_syncs_per_step_counts_the_windows_sync_ranges():
    ranges = [("bench/step", 0, 100 * MS), ("bench/step", 200 * MS, 300 * MS),
              ("sync/optimizer", 50 * MS, 60 * MS),
              ("sync/metrics", 90 * MS, 95 * MS),
              ("sync/optimizer", 250 * MS, 260 * MS),
              ("sync/metrics", 1200 * MS, 1201 * MS)]    # past the window
    assert reader("syncs_per_step")(ctx_of(ranges)) == 1.5
    assert reader("syncs_per_step")(ctx_of(ranges[:2])) is None


def test_step_host_ms_subtracts_the_waits_inside_each_step():
    ranges = [("bench/step", 0, 10 * MS), ("bench/step", 20 * MS, 40 * MS),
              ("sync/optimizer", 2 * MS, 4 * MS),
              ("sync/metrics", 20 * MS, 25 * MS),
              ("sync/cache", 12 * MS, 14 * MS),       # between the steps
              ("step/forward", 1 * MS, 2 * MS)]
    assert reader("step_host_ms")(ctx_of(ranges)) == pytest.approx(
        ((10 - 2) + (20 - 5)) / 2)
    assert reader("step_host_ms")(ctx_of([r for r in ranges if not
                                          r[0].startswith("sync/")])) is None


def test_batch_to_gbps_keeps_the_samples_of_the_window(monkeypatch):
    from unipre3d_tpu_torch import telemetry
    monkeypatch.setattr(telemetry, "SAMPLES", {"h2d_bytes": [
        (5 * MS, 1e6), (95 * MS, 3e6), (2000 * MS, 7e9)]})
    ranges = [("data/batch_to", 4 * MS, 5 * MS),
              ("data/batch_to", 94 * MS, 95 * MS)]
    ctx = ctx_of(ranges, t1=1000 * MS)
    assert reader("batch_to_gbps")(ctx) == pytest.approx(4e6 / 2e-3 / 1e9)
    assert reader("batch_to_gbps")(ctx_of([])) is None
    monkeypatch.setattr(telemetry, "SAMPLES", {})
    assert reader("batch_to_gbps")(ctx) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["object_fresh", "scene_rank"])
def test_backward_regions_hold_the_backward_on_the_card(cuda_card,
                                                        monkeypatch,
                                                        cell_name):
    import torch
    from port_bench import driver, run, trace
    from unipre3d_tpu_torch import telemetry
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "CUDA_CACHE_PATH", "OMP_NUM_THREADS"):
        monkeypatch.delenv(var, raising=False)    # restored afterwards
    run.set_environment()
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = run.find(manifest["workloads"], cell_name, "workload")
    entry = run.find(manifest["configs"], cell["config"], "config")
    spec = json.loads((REPO / entry["file"]).read_text())
    mix = json.loads((REPO / "port_bench" / "traffic" /
                      f"{cell['traffic']}.json").read_text())
    prog = driver.Program(spec, mix, 2147483713, torch.device("cuda", 0))
    try:
        prog.check_steps(2)
        torch.cuda.synchronize()
        prof = run.window(prog, 3.0, True, torch.cuda.synchronize)[3]
    finally:
        prog.close()
    tr = trace.from_profiler(prof)
    in_backward = tr.device_s("step/backward")
    regions = sum(tr.device_s(n) for n in tr.by_name
                  if n.startswith("backward/"))
    print(f"{cell_name}: backward/* regions hold {regions!r} s of the "
          f"{in_backward!r} s launched in step/backward")
    assert in_backward > 0 and regions >= 0.95 * in_backward, (
        regions, in_backward, sorted(tr.by_name))
    stamps = [t for t, _ in telemetry.SAMPLES["h2d_bytes"]
              if tr.t0 <= t <= tr.t1]
    spans = tr.by_name["data/batch_to"]
    assert len(stamps) == len(spans) > 0
    assert all(any(s <= t <= e for s, e in spans) for t in stamps)
