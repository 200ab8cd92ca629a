"""The end-to-end rate and the step tail are taken over every iteration of
the window; the roofline's least time follows the hand count and is read
only over the launches of the steps whose pairs were counted; the
check's per-sample and directional gaps read as defined."""

import importlib.util
import statistics
from pathlib import Path
from types import SimpleNamespace

import pytest

from port_bench.counts import splat_dense

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_rate_counts_every_sample_over_the_whole_window():
    ctx = SimpleNamespace(samples=32 * 7, window_s=2.0)
    assert reader("train_samples_per_s")(ctx) == 112.0


@pytest.mark.parametrize("n", [20, 150, 401])
def test_p95_is_over_every_iteration(n):
    times = [float(i) for i in range(1, n + 1)]
    ctx = SimpleNamespace(iter_ms=times[::-1])
    want = statistics.quantiles(times, n=100)[94]
    assert reader("step_ms.p95")(ctx) == want
    # the slowest iterations move it; dropping them would not
    assert reader("step_ms.p95")(SimpleNamespace(
        iter_ms=times + [1e6] * (n // 10))) > want


def test_hit_rate_counts_host_tier_hits():
    ctx = SimpleNamespace(cache_window={"hits": 3, "l2_hits": 1,
                                        "misses": 96})
    assert reader("cache_hit_rate")(ctx) == pytest.approx(4.0)


@pytest.mark.parametrize("renders,n_pad,pixels,pairs", [
    (2, 128, 16, 10), (128, 128, 128 * 128, 1e8), (4, 512, 64, 0)])
def test_splat_counts_by_hand(renders, n_pad, pixels, pairs):
    fwd_bytes = 4 * (renders * 9 * n_pad + 3 + renders * 3 * pixels
                     + renders * pixels)
    bwd_bytes = 4 * (2 * renders * 9 * n_pad + 2 * renders * 3 * pixels)
    assert splat_dense.launch_bytes("fwd", renders, n_pad, pixels) == \
        fwd_bytes
    assert splat_dense.launch_bytes("bwd", renders, n_pad, pixels) == \
        bwd_bytes
    assert splat_dense.least_seconds("fwd", renders, n_pad, pixels, pairs) \
        == max(fwd_bytes / 3.35e12, pairs * 25 / 67e12)
    assert splat_dense.least_seconds("bwd", renders, n_pad, pixels, pairs) \
        == max(bwd_bytes / 3.35e12, pairs * 64 / 67e12)


def test_splat_shape_of_the_object_config():
    spec = {"num_groups": 128, "batch_size": 32, "imgs_per_obj": 4,
            "training_resolution": 128}
    assert splat_dense.shape_of(spec) == (128, 128, 16384)
    assert splat_dense.shape_of({**spec, "num_groups": 600})[1] == 1024


def test_lpips_flops_follow_the_hand_count():
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from port_bench.reference.lpips import LPIPS, VGG_CHANNELS
    lp = LPIPS()
    x = torch.empty(1, 3, 16, 16, device="meta")
    with FlopCounterMode(display=False) as c:
        lp.vgg(x)
    want, cin, side = 0, 3, 16
    for si, chans in enumerate(VGG_CHANNELS):
        if si:
            side //= 2
        for ch in chans:
            want += 2 * cin * ch * 9 * side * side
            cin = ch
    assert c.get_total_flops() == want


def test_scene_flops_count_on_a_small_scene():
    """The scene's count runs the reference over a real batch (its index
    structures come from the data) and gives a positive count a sample."""
    import json
    import torch
    from port_bench import driver, generator
    from port_bench.counts import model_flops
    from unipre3d_tpu_torch.data import collate
    bench = Path(__file__).resolve().parents[1]
    spec = json.loads((bench / "configs" / "sparseunet_pretraining.json")
                      .read_text())
    mix = json.loads((bench / "traffic" / "rooms.json").read_text())
    spec.update(training_width=32, training_height=32, input_images=2,
                max_points=2048, vae={"block_out_channels": [32] * 4,
                                      "layers_per_block": 1,
                                      "latent_channels": 4})
    mix.update(scenes=1, frames=8)
    ds = generator.make_dataset(mix, spec, 3, torch.device("cpu"))
    assert spec["name"] == "sparseunet_pretraining"
    flops = model_flops.flops_per_sample(
        spec, mix, driver.reference_of(spec), collate([ds[0]]),
        torch.device("cpu"))
    assert flops > 1e9


def test_object_flops_are_counted_from_the_reference_module():
    import json
    from port_bench import driver
    from port_bench.counts import model_flops
    bench = Path(__file__).resolve().parents[1]
    spec = json.loads((bench / "configs" / "transformer_pretraining.json")
                      .read_text())
    plain = model_flops.flops_per_sample(spec, {"lpips": False},
                                         driver.reference_of(spec))
    with_lpips = model_flops.flops_per_sample(spec, {"lpips": True},
                                              driver.reference_of(spec))
    assert 1e11 < plain < with_lpips


def test_trace_finds_the_launches_of_the_kth_range():
    from port_bench.trace import Trace
    ranges = [("bench/step", 0, 10), ("bench/step", 20, 30),
              ("bench/step", 40, 50)]
    ops = [("a", 1, 5, 2), ("b", 22, 5, 25), ("c", 60, 5, 45),
           ("d", 61, 5, None)]
    tr = Trace(ranges, ops, 0, 100)
    assert [o[0] for o in tr.nth_launched_in("bench/step", 1)] == ["b"]
    assert [o[0] for o in tr.nth_launched_in("bench/step", 2)] == ["c"]
    assert tr.nth_launched_in("bench/step", 3) == []


def test_roofline_reads_only_the_counted_steps(monkeypatch):
    """Launches of steps without counted pairs are left out; each counted
    step's pairs apply to its own launches alone."""
    from port_bench.trace import Trace
    spec = {"num_groups": 128, "batch_size": 2, "imgs_per_obj": 1,
            "training_resolution": 4}
    shape = splat_dense.shape_of(spec)
    counted = {0: 100, 2: 5000}
    monkeypatch.setattr(splat_dense, "pairs",
                        lambda spec, g, batch, device: counted[batch])
    ranges = [("bench/step", 0, 10), ("bench/step", 20, 30),
              ("bench/step", 40, 50)]
    ops = [("dense_fwd_kernel", 1, 1000, 2), ("dense_bwd_kernel", 3, 2000, 4),
           ("dense_fwd_kernel", 21, 9999, 22),
           ("dense_fwd_kernel", 41, 3000, 42), ("other", 43, 50, 44)]
    steps = [{"index": 0, "batch": 0, "gaussians": {}},
             {"index": 2, "batch": 2, "gaussians": {}}]
    ctx = SimpleNamespace(spec=spec, trace=Trace(ranges, ops, 0, 100),
                          window_steps=steps, device=None)
    least = (splat_dense.least_seconds("fwd", *shape, 100)
             + splat_dense.least_seconds("bwd", *shape, 100)
             + splat_dense.least_seconds("fwd", *shape, 5000))
    spent = (1000 + 2000 + 3000) * 1e-9
    assert reader("splat_dense_roofline")(ctx) == pytest.approx(
        100 * least / spent)
    assert reader("splat_dense_roofline")(SimpleNamespace(
        spec=spec, trace=ctx.trace, window_steps=[], device=None)) is None


def test_sample_gaps_read_each_sample_and_a_missing_one_as_infinite():
    import math
    import torch
    from port_bench import check
    ref = torch.ones(4, 3)
    prog = ref.clone()
    prog[1] *= 1.1
    gaps = check.sample_gaps(prog, ref)
    assert gaps[0] == 0.0 and gaps[1] == pytest.approx(0.1)
    assert check.sample_gaps(prog[:2], ref)[2:] == [math.inf, math.inf]
    g = {"xyz": ref, "opacity": ref[:, :1]}
    half = {k: v[:2] for k, v in g.items()}
    assert check.gaussian_gaps(half, g) == [0.0, 0.0, math.inf, math.inf]


def test_scene_gaussians_compare_the_kept_rows_and_their_mask():
    import math
    import torch
    from port_bench import check
    mask = torch.tensor([[True, True, False]])
    ref = {"xyz": torch.ones(1, 3, 3), "mask": mask}
    prog = {"xyz": torch.ones(1, 3, 3), "mask": mask.clone()}
    prog["xyz"][0, 2] = 50.0                    # a row the mask leaves out
    assert check.gaussian_gaps(prog, ref) == [0.0]
    prog["mask"] = torch.tensor([[True, False, True]])
    assert check.gaussian_gaps(prog, ref) == [math.inf]


def test_cosine_gap_reads_direction_not_length():
    import torch
    from port_bench import check
    a = torch.tensor([1.0, 2.0, -1.0])
    assert check.cosine_gap(a, 3 * a) == pytest.approx(0.0, abs=1e-12)
    assert check.cosine_gap(a, -a) == pytest.approx(2.0)
    assert check.cosine_gap(a, torch.zeros(3)) == 1.0
