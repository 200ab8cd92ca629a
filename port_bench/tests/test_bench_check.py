"""The correctness check at a size the CPU holds: the plain reference
equals the port's float32 CPU path (its plain kernels); the check passes
that path and fails the fp8 control and each fault that a cell can have
(its state left unchanged; the feature cache's answer altered; a render
altered where the rasterizer produces it; half of a batch left out, the
mean taken over the rest, where a batch holds more than one sample),
with the cell's own limits."""

import copy
import json
from pathlib import Path

import pytest
import torch

from port_bench import check, driver, run
from port_bench.calibrate import half_batch

BENCH = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
SMALL_VAE = {"block_out_channels": [32, 32, 32, 32], "layers_per_block": 1,
             "latent_channels": 4}
VAE_OVERRIDE = ("model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
                "layers_per_block: 1}")
# each configuration at a CPU size: (spec keys, program overrides, mix keys)
SMALL = {
    "transformer_pretraining": (
        {"batch_size": 4, "training_resolution": 32, "depth": 2},
        ["opt.batch_size=4", "data.training_resolution=32",
         "model.backbone_overrides={depth: 2}"], {"objects": 16}),
    "sparseunet_pretraining": (
        {"training_width": 32, "training_height": 32, "input_images": 2,
         "max_points": 2048},
        ["data.training_width=32", "data.training_height=32",
         "data.input_images=2", "data.max_points=2048"],
        {"scenes": 3, "frames": 16}),
}


def small(cell_name):
    """The cell's config and mix at a CPU size, computing in float32 with
    the VAE run live (no bf16 rounding anywhere), and the cell's limits."""
    cell = run.find(MANIFEST["workloads"], cell_name, "workload")
    entry = run.find(MANIFEST["configs"], cell["config"], "config")
    spec = json.loads((BENCH.parent / entry["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    keys, overrides, mix_keys = SMALL[cell["config"]]
    spec.update(keys, compute_dtype="float32", vae_cache_entries=0,
                vae=SMALL_VAE)
    spec["program"]["overrides"] = spec["program"]["overrides"] + overrides \
        + [VAE_OVERRIDE, "tpu.compute_dtype=float32",
           "tpu.vae_cache_entries=0"]
    mix.update(mix_keys)
    limits = json.loads((BENCH / "limits" / f"{cell_name}.json").read_text())
    return cell, spec, mix, limits


def without_features(limits):
    """The limits that apply to a run without the feature cache: it hands
    the step no features to compare."""
    return {k: v for k, v in limits.items() if not k.startswith("vae")}


def with_cache(spec):
    """The float32 run with the feature cache (its buffer rounds the
    features to bfloat16)."""
    spec["vae_cache_entries"] = 512
    spec["program"]["overrides"].remove("tpu.vae_cache_entries=0")
    spec["program"]["overrides"].append("tpu.vae_cache_entries=512")


def readings(spec, mix, seed, wrap_step=None, rounding=None):
    cpu = torch.device("cpu")
    prog = driver.Program(spec, mix, seed, cpu, wrap_step=wrap_step)
    first = prog.check_steps(run.CHECK_STEPS)
    prog.close()
    ref = driver.reference_readings(spec, mix, seed, first["batches"], cpu)
    if rounding:
        side = driver.reference_readings(spec, mix, seed, first["batches"],
                                         cpu, rounding=rounding)
    else:
        side = driver.program_readings(
            first, driver.predictor_weights(spec, seed, cpu))
    ref["splat_renders"] = driver.splat_renders(
        spec, side.get("gaussians"), first["batches"][0], cpu)
    return check.readings(side, ref)


def unchanged_state(step):
    """A step that computes its loss and hands back its state as it was."""
    def broken(state, batch):
        saved = copy.deepcopy((state.step, state.optimizer.mu,
                               state.optimizer.nu, state.optimizer.count,
                               state.ema))
        params = [p.detach().clone() for p in state.optimizer.params]
        metrics = step(state, batch)
        (state.step, state.optimizer.mu, state.optimizer.nu,
         state.optimizer.count, state.ema) = saved
        with torch.no_grad():
            for p, q in zip(state.optimizer.params, params):
                p.copy_(q)
        return metrics
    return broken


def altered_answer(step):
    """The feature cache's answer for the batch's first image zeroed where
    it is produced (the attach's output, which the step reads)."""
    def broken(state, batch):
        batch["vae_features"][0] = 0.0
        return step(state, batch)
    return broken


def altered_render(step):
    """The first supervision render of the step zeroed where the
    rasterizer produces it (the images the loss reads)."""
    from unipre3d_tpu_torch.training import trainer

    def zeroed(fn):
        def call(*args, **kwargs):
            imgs = fn(*args, **kwargs).clone()
            imgs[0] = 0.0
            return imgs
        return call

    names = ("rasterize_dense_batched", "rasterize_projected")

    def broken(state, batch):
        saved = {n: getattr(trainer, n) for n in names}
        for n, fn in saved.items():
            setattr(trainer, n, zeroed(fn))
        try:
            return step(state, batch)
        finally:
            for n, fn in saved.items():
                setattr(trainer, n, fn)
    return broken


CELLS = [c["name"] for c in MANIFEST["workloads"] if c["chips"] == 1]


def faults_of(cell_name):
    _, spec, _, _ = small(cell_name)
    return [unchanged_state, altered_answer, altered_render] + (
        [half_batch] if int(spec["batch_size"]) > 1 else [])


FAULTS = [(c, f) for c in CELLS for f in faults_of(c)]


@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_equals_the_ports_float32_cpu_path(cell_name):
    """Step 1 agrees to rounding (later steps part by Adam's sign steps on
    gradients that are nought to rounding, on the scene through ReLU ties
    and the tiled renderer's capacity too), and the check passes."""
    _, spec, mix, limits = small(cell_name)
    values = readings(spec, mix, 1234)
    for k in ("loss_1", "grad_worst", "grad_median", "bn1_worst",
              "gauss_worst", "head_worst", "render_worst", "splat_worst",
              "grad_cos"):
        assert values[k] < 1e-4, (k, values[k])
    ok, rows = check.decide(values, without_features(limits))
    assert ok, rows


def run_cell(cell, spec, mix, limits, seed, wrap_step=None):
    """A whole run of the cell on the CPU (the harness's look for a card
    skipped): set-up, check steps, a short window, the reference, the
    check -> the result object."""
    names = [m["name"] for m in MANIFEST["end_to_end"]]
    units = {m["name"]: m["unit"] for m in MANIFEST["end_to_end"]}
    result, _, _ = run.measure(spec, mix, cell, names, units, limits, seed,
                               0.5, False, torch.device("cpu"),
                               wrap_step=wrap_step)
    return result


@pytest.mark.parametrize("cell_name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_each_fault_comes_out_not_correct(cell_name, fault):
    cell, spec, mix, limits = small(cell_name)
    if fault is altered_answer:
        with_cache(spec)
    else:
        limits = without_features(limits)
    sound = run_cell(cell, spec, mix, limits, 99)
    assert sound["correct"], sound["checks"]
    broken = run_cell(cell, spec, mix, limits, 99, wrap_step=fault)
    assert not broken["correct"], broken["checks"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_fp8_control_comes_out_not_correct(cell_name):
    _, spec, mix, limits = small(cell_name)
    ok, rows = check.decide(readings(spec, mix, 7, rounding="fp8"), limits)
    assert not ok, rows
