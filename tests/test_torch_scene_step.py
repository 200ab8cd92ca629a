"""PyTorch port vs the JAX package: the whole scene-pretraining step
(SparseUNet + PointFusion, binned splat route).

One train step of both packages from the same weights (a JAX init
converted by unipre3d_tpu_torch/weights.py) on the same numpy batch, at the
configuration of tests/test_scene.py (32x32, 2 + 2 views, 1024 points,
full SD-VAE and SpUNet) with ``tpu.raster_impl_train=pallas_binned`` and
``tpu.raster_tile_capacity=1024``: a per-tile cap of 4096 duplicates, so no
tile is cut and the JAX binned backward is defined (see
test_torch_splat_binned.py for the cut tiles). The batch's point clouds,
cameras and unprojections come from the synthetic scene dataset (numpy,
equal in both packages); its GT views are seeded noise, so no renderer's
output enters the comparison. Compared: loss, gradients (through Adam's
first moment, 0.1 x the clipped gradient), updated parameters, BatchNorm
running stats and EMA. The JAX step compiles for about two minutes on one
CPU core, so it runs once per test run: in a module fixture and, under
pytest-xdist, in the first worker that needs it, the others loading its
results from a file (``shared_across_workers``).

Tolerances and reasons:
* loss, PSNR: 1e-5 relative;
* BatchNorm running stats (the forward's batch statistics): 1e-4 relative
  to each tensor's largest entry. Module outputs agree to <= 1.7e-5
  relative through the 60 BatchNorms (measured), and a batch mean of a conv
  output near zero is a difference of nearly cancelling sums (measured
  1.0e-5);
* gradients at this width and depth are not comparable entry by entry in
  float32: a handful of the ~10^6 ReLU inputs land within rounding of 0
  (two at this seed, at enc2_block1.bn1 and dec2_block0.bn1), take
  opposite decisions in the two packages, and move the gradient of every
  layer below them by 1-3% of the layer's largest entry (measured: every
  one of six init seeds tried has such ties; a 1e-6 perturbation of the
  input moves the port's own gradients by only 4e-5, so this is ties, not
  conditioning). Asserted here: the gradient norm to 5e-3 relative
  (measured 8.6e-4) and the whole gradient to 5e-2 relative in L2
  (measured 1.9e-2). Entry-by-entry parity (1e-4 per tensor) of the same
  backward, PointFusion duplicates included, is held at a smaller width
  where no tie occurs (test_torch_sparse.py::
  test_scene_predictor_matches_jax);
* parameters after Adam's first step, as deltas from the common start:
  with eps 1e-15 the step is -lr (sign(g) + decay p0) on every entry, so
  where both packages' gradients share their sign beyond doubt (|g_jax| >
  2 |g_port - g_jax|; measured 37% of the entries, asserted > 30%) the
  deltas agree to 1e-3 lr plus two float32 ulps of the parameter (the
  rounding of p0 + delta) and point against the gradient; elsewhere both
  moved by at most lr (+ decay). The EMA copy of step 1 equals the
  parameters exactly.
"""

import math
import os

import jax
import numpy as np
import pytest
import torch
from filelock import FileLock

from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu.training.config import load_config as jload_config
from unipre3d_tpu_torch import train_network
from unipre3d_tpu_torch.data import SyntheticSceneDataset, batch_to, collate
from unipre3d_tpu_torch.training import trainer
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_utils import (  # noqa: F401
    one_torch_thread, release_memory, run_dir, trimmed_heap)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCENE = ["data.training_width=32", "data.training_height=32",
         "data.input_images=2", "data.max_points=1024", "opt.batch_size=1",
         "data.pts_dataset_root=synthetic", "opt.ema.update_after_step=1",
         "tpu.raster_impl_train=pallas_binned"]
LR = 1e-4


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def adam_state(opt_state):
    return next(leaf for leaf in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(leaf, "mu"))


def scene_batch(cfg):
    ds = SyntheticSceneDataset(cfg, num_scenes=1, seed=0, device="cpu")
    batch = collate([ds[0]])
    batch["gt_images"] = np.random.default_rng(1).uniform(
        0, 1, batch["gt_images"].shape).astype(np.float32)
    return batch


def shared_across_workers(tmp_path_factory, name, compute):
    """``compute()`` -> {group: {key: tensor}}, once per test run. Under
    pytest-xdist the first worker to get here computes it under a file lock
    in the directory the workers share and saves it there as ``.npz``; the
    others wait on the lock and load that file instead of computing again,
    and the computing worker hands the reference's freed heap back to the
    OS. In one process it just computes."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return compute()
    path = tmp_path_factory.getbasetemp().parent / f"{name}.npz"
    with FileLock(f"{path}.lock"):
        if not path.exists():
            flat = {f"{g}|{k}": v.numpy()
                    for g, d in compute().items() for k, v in d.items()}
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            with open(tmp, "wb") as f:
                np.savez(f, **flat)
            os.replace(tmp, path)
            del flat
            release_memory()
    out = {}
    with np.load(path) as z:
        for key in z.files:
            g, k = key.split("|", 1)
            out.setdefault(g, {})[k] = torch.from_numpy(z[key])
    return out


def jax_scene_step(jcfg, batch):
    """The JAX side of the step: the converted init (params and BN stats),
    p0 (params), metrics, Adam's first moment, params + BN stats and EMA
    after the step, as {group: {name: tensor}}."""
    jmodel, tx, jstate = jtrainer.create_train_state(
        jcfg, jax.random.PRNGKey(0), batch)
    init = jax_to_state_dict(np_tree(jstate.params),
                             np_tree(jstate.batch_stats))
    p0 = jax_to_state_dict(np_tree(jstate.params))
    jstate, jm = jax.jit(jtrainer.make_train_step(jcfg, jmodel, tx))(
        jstate, batch)
    return dict(
        init=init, p0=p0,
        jm={k: torch.tensor(float(v)) for k, v in jm.items()},
        jmu=jax_to_state_dict(np_tree(adam_state(jstate.opt_state).mu)),
        jp=jax_to_state_dict(np_tree(jstate.params),
                             np_tree(jstate.batch_stats)),
        jema=jax_to_state_dict(np_tree(jstate.ema_params)))


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    over = SCENE + ["tpu.raster_tile_capacity=1024"]
    jcfg = jload_config("sparseunet_pretraining", overrides=over)
    tcfg = load_config("sparseunet_pretraining", overrides=over)
    batch = scene_batch(tcfg)
    # the JAX step's jit is the file's cost (minutes, GiBs): once per run
    j = shared_across_workers(tmp_path_factory, "jax_scene_step",
                              lambda: jax_scene_step(jcfg, batch))
    tmodel, tstate = trainer.create_train_state(
        tcfg, device="cpu", state_dict=j["init"])
    tb = batch_to(batch, "cpu")
    tb["geometry"] = trainer.make_geometry_fn(tcfg, tmodel)(tb)
    tm = trainer.make_train_step(tcfg, tmodel)(tstate, tb)
    names = [n for n, _ in trainer.split_frozen(tmodel)[0]]
    return dict(
        names=names, p0=j["p0"], jm={k: float(v) for k, v in j["jm"].items()},
        tm=tm, jmu=j["jmu"], tmu=dict(zip(names, tstate.optimizer.mu)),
        jp=j["jp"], tp=tmodel.state_dict(), jema=j["jema"], tema=tstate.ema)


def test_scene_step_loss_and_metrics(step):
    assert step["tm"]["nan_skipped"] == 0.0
    for k in ("loss", "psnr", "grad_norm"):
        assert math.isfinite(step["jm"][k]), k
    for k in ("loss", "psnr"):
        assert step["tm"][k] == pytest.approx(step["jm"][k], rel=1e-5), k
    assert step["tm"]["grad_norm"] == pytest.approx(step["jm"]["grad_norm"],
                                                    rel=5e-3)


def test_scene_step_gradients(step):
    names = step["names"]
    assert len(names) > 180 and any(n.startswith(
        "point_network.encoder.enc3") for n in names)
    diff = sum(float(((step["tmu"][n] - step["jmu"][n]) ** 2).sum())
               for n in names)
    ref = sum(float((step["jmu"][n] ** 2).sum()) for n in names)
    assert (diff / ref) ** 0.5 < 5e-2


def test_scene_step_params_bn_stats_and_ema(step):
    sure_total = total = 0
    for n in step["names"]:
        p0, jmu, tmu = step["p0"][n], step["jmu"][n], step["tmu"][n]
        d_t, d_j = step["tp"][n] - p0, step["jp"][n] - p0
        # entries whose gradient sign both packages share beyond doubt: the
        # update -lr (sign(g) + decay p0) must agree to the rounding of p1
        sure = (jmu.abs() > 2 * (tmu - jmu).abs()) & (jmu.abs() > 1e-12)
        tol = 1e-3 * LR + 2.4e-7 * p0.abs()
        assert bool(((d_t - d_j).abs() <= tol)[sure].all()), n
        assert bool((torch.sign(d_t) == -torch.sign(jmu))[sure].all()), n
        # elsewhere (a near-zero gradient) both moved by at most the step
        assert float(d_t.abs().max()) <= LR * 1.02, n
        sure_total += int(sure.sum())
        total += sure.numel()
        torch.testing.assert_close(step["tema"][n], step["tp"][n], rtol=0,
                                   atol=0)
        assert float((step["jema"][n] - step["jp"][n]).abs().max()) == 0.0, n
    assert sure_total > 0.3 * total        # measured 0.37
    stats = [k for k in step["jp"] if "running_" in k]
    assert len(stats) == sum("running_" in k for k in step["tp"]) > 100
    for k in stats:
        assert float((step["tp"][k] - step["jp"][k]).abs().max()
                     / step["jp"][k].abs().max()) < 1e-4, k


def test_scene_step_finite_where_tiles_are_cut():
    """At the capacity of tests/test_scene.py (128: a cap of 512
    duplicates a tile) tiles are cut from the first step. The JAX binned
    backward is NaN there; the port's gradient is finite and the update is
    applied."""
    cfg = load_config("sparseunet_pretraining",
                      overrides=SCENE + ["tpu.raster_tile_capacity=128"])
    batch = batch_to(scene_batch(cfg), "cpu")
    model, state = trainer.create_train_state(cfg, device="cpu", seed=0)
    m = trainer.make_train_step(cfg, model)(state, batch)
    assert m["cap_dropped"] > 0 and m["dups"] > m["cap_dropped"]
    assert math.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
    assert m["nan_skipped"] == 0.0 and state.optimizer.count == 1


def test_auto_route_at_scene_size_is_not_ported():
    """The auto route above 4096 gaussians takes the tiled renderer (the
    name dates from when this route raised, the renderer missing): the
    model's gaussians render to finite supervision views, with no
    binned-splat work (no duplicate counts)."""
    cfg = load_config("sparseunet_pretraining", overrides=SCENE[:-1])
    model, _ = trainer.create_train_state(cfg, device="cpu", seed=0)
    batch = batch_to(scene_batch(cfg), "cpu")
    stats = {}
    with torch.no_grad():
        g = trainer.predict(model, batch, 2)
        assert g["xyz"].shape[1] > trainer.DENSE_MAX_N
        img = trainer.render_supervision_views(g, batch, cfg, [1.0] * 3,
                                               stats)
    assert img.shape == (1, 2, 3, 32, 32) and not stats
    assert bool(torch.isfinite(img).all()) and float(img.min()) < 0.99


def test_cli_trains_scene_on_cpu(run_dir):
    res = train_network.main(
        ["--config-name", "sparseunet_pretraining", "--device", "cpu",
         "--output-dir", str(run_dir), "opt.iterations=2",
         "logging.loss_log=1", "tpu.compute_dtype=float32",
         "tpu.vae_cache_entries=0",
         "tpu.raster_tile_capacity=1024"] + SCENE)
    assert len(res["losses"]) == 2
    assert all(math.isfinite(x) for x in res["losses"] + res["grad_norms"])
    assert res["nan_skipped"] == [0.0, 0.0]
    assert len(res["geometry_ms"]) == 2 and min(res["valid_rows"]) > 1000
    assert res["cap_dropped"] == [0, 0] and min(res["dups"]) > 0
