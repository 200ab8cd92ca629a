"""The port's spans, counters and backward marks (unipre3d_tpu_torch/
telemetry.py), on the CPU.

* With no profiler running, ``span`` opens nothing, ``count`` keeps
  nothing and ``mark`` hands back its tensor itself.
* Under a CPU ``torch.profiler``, one object step (the small config of
  tests/test_torch_train_step.py) opens the ranges the benchmark's readers
  and the ledger's breakdown read, nested as the step nests them:
  ``step/forward`` > ``predictor/<backbone>``, the ``backward/*`` regions
  inside ``step/backward`` and one after another, ``sync/optimizer`` and
  ``optimizer/*`` inside ``step/optimizer``; the names the benchmark read
  before the spans existed are all there.
* A scene step (SparseUNet, the small config of
  tests/test_torch_scene_step.py with a small VAE) opens
  ``geometry/build`` and adds the scene's ``backward/image_conv`` region
  after its backbone's.
* A tiny feature cache's ``attach`` opens ``cache/attach`` around
  ``cache/hash``, ``cache/vae`` and ``cache/gather``.
* ``batch_to``'s ``h2d_bytes`` sample carries the bytes it moved and a
  stamp inside its ``data/batch_to`` range, on the profiler's clock; the
  loader's consumer waits in ``data/wait``, its reading thread opening no
  range and keeping no counter.
* The step's loss, gradient (Adam's first moment after one step) and
  parameters are bit for bit the same with a profiler running as without:
  the marks change nothing.
"""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from unipre3d_tpu_torch import telemetry
from unipre3d_tpu_torch.data import (Loader, SyntheticSceneDataset,
                                     batch_to, collate)
from unipre3d_tpu_torch.data.synthetic import random_batch
from unipre3d_tpu_torch.training import trainer
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.training.feature_cache import DeviceVAECache
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = ["data.training_resolution=32", "opt.batch_size=2",
         "data.dataset_root=synthetic", "opt.ema.update_after_step=1",
         "opt.ema.update_every=1",
         "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
         "layers_per_block: 1}",
         "model.backbone_overrides={depth: 2, drop_path_rate: 0.0}"]
SCENE = ["data.training_width=32", "data.training_height=32",
         "data.input_images=2", "data.max_points=1024", "opt.batch_size=1",
         "data.pts_dataset_root=synthetic",
         "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
         "layers_per_block: 1}"]


def ranges_of(prof):
    """The profiler's user ranges -> {name: [(start_ns, end_ns), ...]}."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            s = ev.start_ns()
            out.setdefault(ev.name(), []).append((s, s + ev.duration_ns()))
    return out


def inside(ranges, child, parent):
    """Every ``child`` range lies within some ``parent`` range."""
    return all(any(ps <= cs and ce <= pe for ps, pe in ranges[parent])
               for cs, ce in ranges[child])


@pytest.fixture(scope="module")
def step_pair():
    """One step of two equal states on the same batch, the second under a
    CPU profiler -> (metrics, state) of each and the profiler's ranges."""
    cfg = load_config("transformer_pretraining", overrides=SMALL)
    batch = batch_to(random_batch(cfg, 2), "cpu")
    out = []
    for traced in (False, True):
        model, state = trainer.create_train_state(cfg, device="cpu", seed=3)
        step = trainer.make_train_step(cfg, model)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                metrics = step(state, copy.copy(batch))
        else:
            metrics = step(state, copy.copy(batch))
        out.append((metrics, state, model))
    return out, ranges_of(prof)


def test_nothing_is_kept_without_a_profiler():
    before = {k: len(v) for k, v in telemetry.SAMPLES.items()}
    with telemetry.span("x/y") as opened:
        telemetry.count("x_bytes", 3)
    assert opened is None
    assert "x_bytes" not in telemetry.SAMPLES
    assert {k: len(v) for k, v in telemetry.SAMPLES.items()} == before
    x = torch.ones(3, requires_grad=True)
    assert telemetry.mark(x, "region") is x


def test_step_ranges_nest_as_the_step_does(step_pair):
    _, r = step_pair
    for name in ("step/forward", "step/render", "step/backward",
                 "step/optimizer", "predictor/frozen_vae",
                 "predictor/transformer", "point_ops/fps"):
        assert name in r, (name, sorted(r))
    assert inside(r, "predictor/transformer", "step/forward")
    assert inside(r, "point_ops/fps", "predictor/transformer")
    regions = sorted((s, e, n) for n, v in r.items()
                     if n.startswith("backward/") for s, e in v)
    assert [n for _, _, n in regions] == [
        "backward/render", "backward/activate", "backward/transformer"]
    for _, _, n in regions:
        assert inside(r, n, "step/backward")
    for (_, e0, _), (s1, _, _) in zip(regions, regions[1:]):
        assert e0 <= s1                      # one after another
    for name in ("sync/optimizer", "optimizer/norm", "optimizer/adamw",
                 "optimizer/ema"):
        assert inside(r, name, "step/optimizer")
    assert inside(r, "sync/optimizer", "optimizer/adamw")
    assert len(r["sync/metrics"]) == 1
    assert r["sync/metrics"][0][0] >= r["step/optimizer"][0][1]


def test_scene_step_adds_geometry_and_image_conv():
    cfg = load_config("sparseunet_pretraining", overrides=SCENE)
    ds = SyntheticSceneDataset(cfg, num_scenes=1, seed=0, device="cpu")
    batch = batch_to(collate([ds[0]]), "cpu")
    model, state = trainer.create_train_state(cfg, device="cpu", seed=0)
    step = trainer.make_train_step(cfg, model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batch["geometry"] = trainer.make_geometry_fn(cfg, model)(batch)
        step(state, batch)
    r = ranges_of(prof)
    assert len(r["geometry/build"]) == 1
    assert inside(r, "predictor/sparseunet", "step/forward")
    regions = sorted((s, n) for n, v in r.items()
                     if n.startswith("backward/") for s, _ in v)
    assert [n for _, n in regions] == [
        "backward/render", "backward/activate", "backward/sparseunet",
        "backward/image_conv"]
    for _, n in regions:
        assert inside(r, n, "step/backward")


def test_traced_step_equals_the_untraced_one(step_pair):
    (m0, s0, model0), (m1, s1, model1) = step_pair[0]
    assert m0 == m1
    for a, b in zip(s0.optimizer.mu, s1.optimizer.mu):
        assert torch.equal(a, b)
    for (n, a), (_, b) in zip(model0.named_parameters(),
                              model1.named_parameters()):
        assert torch.equal(a, b), n


def test_attach_opens_its_parts():
    cache = DeviceVAECache(lambda x: x[:, :2] * 2.0, capacity=8, img_h=4,
                           img_w=4, channels=2, dtype=torch.float32,
                           device="cpu")
    images = np.random.default_rng(0).uniform(
        0, 1, (2, 3, 3, 4, 4)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        feats = cache.attach({"gt_images": images}, 2)
    r = ranges_of(prof)
    for name in ("cache/hash", "cache/vae", "cache/gather"):
        assert inside(r, name, "cache/attach"), (name, sorted(r))
    assert "cache/upload" not in r and "cache/spill" not in r
    assert torch.equal(feats, torch.from_numpy(images[:, :2, :2] * 2.0))


def test_counts_fall_inside_their_range_on_the_profilers_clock():
    batch = {"a": np.zeros((3, 5), np.float64),
             "b": {"c": np.zeros(7, np.int32)}}
    telemetry.SAMPLES.pop("h2d_bytes", None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            batch_to(batch, "cpu")
    samples = list(telemetry.SAMPLES.pop("h2d_bytes"))
    assert [v for _, v in samples] == [3 * 5 * 4 + 7 * 4] * 3
    spans = ranges_of(prof)["data/batch_to"]
    assert len(spans) == 3
    for (t, _), (s, e) in zip(samples, sorted(spans)):
        assert s <= t <= e


def test_loader_waits_in_a_range_and_counts_its_thread():
    data = [{"x": np.full(2, i, np.float32)} for i in range(8)]
    kept = {k: len(v) for k, v in telemetry.SAMPLES.items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batches = Loader(data, 2, shuffle=False, num_workers=1).iter_from(0)
        got = [next(batches)["x"][:, 0].tolist() for _ in range(3)]
        batches.close()
    assert got == [[0, 1], [2, 3], [4, 5]]
    assert {k: len(v) for k, v in telemetry.SAMPLES.items()} == kept
    r = ranges_of(prof)
    assert len(r["data/wait"]) == 3 and set(r) == {"data/wait"}
