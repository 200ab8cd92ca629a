"""PyTorch port vs the JAX package: the whole PTv3 scene-pretraining step
(``ptv3_pretraining``, binned splat route), the CLI, and the weights.

One train step of both packages from the same weights (a JAX init
converted by unipre3d_tpu_torch/weights.py) on the same numpy batch, at the
size tests/test_scene.py[ptv3] runs (32x32, 2 + 2 views, 1024 points,
full SD-VAE and full-width PTv3: 5,120 rows in five stages) with
``tpu.raster_impl_train=pallas_binned`` and
``tpu.raster_tile_capacity=1024`` (no tile is cut, see
test_torch_scene_step.py). DropPath and the order shuffle are off
(``drop_path: 0``, ``shuffle_orders: false``): their draws cannot match
across packages (tests/test_torch_ptv3.py holds the swap). The JAX step
is jitted once per test run (``shared_across_workers``).

Tolerances and reasons:
* loss, PSNR: 1e-5 relative (measured 1.1e-6, 1.3e-6);
* gradients, unclipped (from Adam's first moment), per tensor in relative
  L2: within max(1e-3, 3x the distance JAX's own gradient moves when its
  parameters are scaled by 1 + 1e-6) -- the rule of
  tests/test_torch_object_backbones.py for gradients that
  near-ties make chaotic (PTv3's poolings take a max over up to eight
  children). Measured: at most 0.18 of that bound (at
  ``image_conv.layers_1.weight``: 1.8e-4 against JAX's own 6.2e-5), and
  5.8e-5 in relative L2 over all tensors (JAX's own move 5.5e-5). The 21
  tensors whose gradient is the rounding noise of an analytically zero one
  (biases ahead of a BatchNorm: below 1e-3 of the largest gradient and
  moving by > 10% under the perturbation) must be noise on both sides;
* BatchNorm running stats: 1e-4 relative to each tensor's largest entry
  (measured 4.6e-6). The EMA copy of step 1 equals the parameters exactly.
"""

import math

import jax
import numpy as np
import pytest
import torch

from unipre3d_tpu.models.gaussian_predictor import \
    build_predictor as jbuild_predictor
from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu.training.config import load_config as jload_config
from unipre3d_tpu_torch import train_network
from unipre3d_tpu_torch.data import batch_to
from unipre3d_tpu_torch.models import ptv3 as tptv3
from unipre3d_tpu_torch.models.gaussian_predictor import build_predictor
from unipre3d_tpu_torch.training import trainer
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_scene_step import (adam_state, np_tree, scene_batch,
                                   shared_across_workers)
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCENE = ["data.training_width=32", "data.training_height=32",
         "data.input_images=2", "data.max_points=1024", "opt.batch_size=1",
         "data.pts_dataset_root=synthetic", "opt.ema.update_after_step=1",
         "tpu.raster_impl_train=pallas_binned",
         "tpu.raster_tile_capacity=1024"]
NO_DRAWS = "model.backbone_overrides={drop_path: 0.0, shuffle_orders: false}"
TOL_STEP_GRAD = 1e-3


def unclipped(mu, grad_norm):
    """The gradient from Adam's first moment after one step (0.1 x the
    gradient clipped to norm 1), unclipped."""
    scale = 10.0 * max(float(grad_norm), 1.0)
    if isinstance(mu, list):
        return [m * scale for m in mu]
    return {k: v * scale for k, v in jax_to_state_dict(np_tree(mu)).items()}


def jax_ptv3_step(jcfg, batch):
    """The JAX side: the converted init, metrics, the unclipped gradient,
    the same from the parameters scaled by 1 + 1e-6, and params + BN stats
    and EMA after the step, as {group: {name: tensor}}."""
    jmodel, tx, jstate = jtrainer.create_train_state(
        jcfg, jax.random.PRNGKey(0), batch)
    init = jax_to_state_dict(np_tree(jstate.params),
                             np_tree(jstate.batch_stats))
    step = jax.jit(jtrainer.make_train_step(jcfg, jmodel, tx))
    moved = jstate._replace(params=jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-6), jstate.params))
    jstate, jm = step(jstate, batch)
    moved, jm_moved = step(moved, batch)
    return dict(
        init=init, jm={k: torch.tensor(float(v)) for k, v in jm.items()},
        jgrad=unclipped(adam_state(jstate.opt_state).mu, jm["grad_norm"]),
        jgrad_moved=unclipped(adam_state(moved.opt_state).mu,
                              jm_moved["grad_norm"]),
        jp=jax_to_state_dict(np_tree(jstate.params),
                             np_tree(jstate.batch_stats)),
        jema=jax_to_state_dict(np_tree(jstate.ema_params)))


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    over = SCENE + [NO_DRAWS]
    jcfg = jload_config("ptv3_pretraining", overrides=over)
    tcfg = load_config("ptv3_pretraining", overrides=over)
    batch = scene_batch(tcfg)
    j = shared_across_workers(tmp_path_factory, "jax_ptv3_step",
                              lambda: jax_ptv3_step(jcfg, batch))
    tmodel, tstate = trainer.create_train_state(
        tcfg, device="cpu", state_dict=j["init"])
    tb = batch_to(batch, "cpu")
    tb["geometry"] = trainer.make_geometry_fn(tcfg, tmodel)(tb)
    tm = trainer.make_train_step(tcfg, tmodel)(tstate, tb)
    names = [n for n, _ in trainer.split_frozen(tmodel)[0]]
    return dict(names=names, geometry=tb["geometry"],
                jm={k: float(v) for k, v in j["jm"].items()}, tm=tm,
                jg=j["jgrad"], jg_moved=j["jgrad_moved"],
                tg=dict(zip(names, unclipped(tstate.optimizer.mu,
                                             tm["grad_norm"]))),
                jp=j["jp"], tp=tmodel.state_dict(), jema=j["jema"],
                tema=tstate.ema)


def rel_l2(a, b):
    return float((b - a).norm() / (a.norm() + 1e-30))


def test_ptv3_step_loss_and_metrics(step):
    assert step["tm"]["nan_skipped"] == 0.0
    assert isinstance(step["geometry"], tptv3.PTv3Geometry)
    assert step["geometry"].fine_mask.shape == (1, 1024 + 4096)
    for k in ("loss", "psnr", "grad_norm"):
        assert math.isfinite(step["jm"][k]), k
    for k in ("loss", "psnr"):
        assert step["tm"][k] == pytest.approx(step["jm"][k], rel=1e-5), k
    assert step["tm"]["cap_dropped"] == 0 and step["tm"]["dups"] > 0


def test_ptv3_step_gradients(step):
    names, jg, tg, moved = step["names"], step["jg"], step["tg"], \
        step["jg_moved"]
    assert set(names) == set(jg) and len(names) > 400
    assert "point_network.encoder.enc3_block5.cpe_kernel" in names
    gmax = max(float(v.abs().max()) for v in jg.values())
    for n in names:
        own = rel_l2(jg[n], moved[n])
        if float(jg[n].abs().max()) < 1e-3 * gmax and own > 0.1:
            assert float(tg[n].abs().max()) < 1e-3 * gmax, n
        else:
            assert rel_l2(jg[n], tg[n]) < max(TOL_STEP_GRAD, 3 * own), (n, own)
    flat = lambda g: torch.cat([g[n].flatten() for n in names])  # noqa: E731
    assert rel_l2(flat(jg), flat(tg)) < max(
        TOL_STEP_GRAD, 3 * rel_l2(flat(jg), flat(moved)))


def test_ptv3_step_bn_stats_and_ema(step):
    for n in step["names"]:
        torch.testing.assert_close(step["tema"][n], step["tp"][n], rtol=0,
                                   atol=0)
        assert float((step["jema"][n] - step["jp"][n]).abs().max()) == 0.0, n
    stats = [k for k in step["jp"] if "running_" in k]
    # embedding, fusion, four poolings, four unpoolings with their skips
    assert len(stats) == sum("running_" in k for k in step["tp"]) == 28
    for k in stats:
        assert float((step["tp"][k] - step["jp"][k]).abs().max()
                     / step["jp"][k].abs().max()) < 1e-4, k


def test_cli_trains_ptv3_on_cpu(tmp_path):
    """The entry point on the published PTv3 (DropPath and the order
    shuffle on, drawn from the step's generator): two finite steps, no NaN
    skip, the geometry built before each step."""
    res = train_network.main(
        ["--config-name", "ptv3_pretraining", "--device", "cpu",
         "--output-dir", str(tmp_path), "opt.iterations=2",
         "logging.loss_log=1", "tpu.compute_dtype=float32",
         "tpu.vae_cache_entries=0"] + SCENE)
    assert len(res["losses"]) == 2
    assert all(math.isfinite(x) for x in res["losses"] + res["grad_norms"])
    assert res["nan_skipped"] == [0.0, 0.0]
    assert len(res["geometry_ms"]) == 2 and min(res["valid_rows"]) > 1000
    assert len(res["stage_rows"]) == 2 and len(res["stage_rows"][0]) == 5
    assert res["cap_dropped"] == [0, 0] and min(res["dups"]) > 0


def test_full_width_ptv3_weights_load_strict():
    """The JAX tree of the full-width PTv3 GaussianSplatPredictor (full
    SD-VAE, published widths) maps onto the port's model with
    ``strict=True``: no key missing, none unexpected, every shape equal.
    Shapes come from ``jax.eval_shape`` of the JAX init (no weights are
    computed)."""
    cfg = load_config("ptv3_pretraining",
                      overrides=["data.pts_dataset_root=synthetic"])
    jcfg = jload_config("ptv3_pretraining",
                        overrides=["data.pts_dataset_root=synthetic"])
    jmodel = jbuild_predictor(jcfg)
    B, V, M, H, W = 1, 2, 64, 32, 32
    pc = {"coord": np.zeros((B, M, 3), np.float32),
          "grid_coord": np.zeros((B, M, 3), np.int32),
          "feat": np.zeros((B, M, 6), np.float32),
          "mask": np.ones((B, M), bool),
          "min_coord": np.zeros((B, 3), np.float32)}
    args = (pc, np.zeros((B, V, 3, H, W), np.float32), None,
            np.zeros((B, V, H, W, 4), np.float32))
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": rng, "droppath": rng}, *args))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    sd = jax_to_state_dict(zeros["params"], zeros["batch_stats"])
    model = build_predictor(cfg)
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    enc = model.point_network.encoder
    assert isinstance(enc, tptv3.PointTransformerV3)
    assert enc.enc_channels == (32, 64, 128, 256, 512)
    assert tuple(enc.enc3_block5.cpe_kernel.shape) == (27, 256, 256)
    assert sum(k.endswith("cpe_kernel") for k in sd) == 14 + 8
