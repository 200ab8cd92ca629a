"""PyTorch port vs the JAX package: the whole object-pretraining step.

One train step of both packages from the same weights (a JAX init
converted by unipre3d_tpu_torch/weights.py) on the same numpy batch, at the
small size (32x32, batch 2, 256 points, 3 views, VAE [32,32,32,32] x1,
depth 2, no DropPath). Compared: loss, gradients (through Adam's first
moment, 0.1 x the clipped gradient), updated parameters, BatchNorm running
stats and EMA; then a second step for the EMA decay branch. Also the
optimizer alone against optax, the CLI and the dataset on the CPU.

Tolerances and reasons:
* loss, PSNR, gradient norm: 1e-5 relative (measured ~2e-6);
* gradients: 1e-4 relative to each tensor's largest, as the dense splat's
  (the JAX kernel's MXU polynomial power and bf16-split prefix vs the
  port's direct evaluation; measured <= 5e-5). Biases ahead of a BatchNorm
  have an analytically zero gradient: both sides must be noise (< 1e-3 of
  the largest gradient);
* parameters after Adam's first step move by lr * sign(g): equal to 1e-6
  except where the gradient is itself rounding noise (|g| < 1e-3 of the
  tensor's largest), where the sign may differ;
* BatchNorm running stats: 1e-5 relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch, _tiny_cfg
from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu.training.config import apply_overrides
from unipre3d_tpu_torch import train_network
from unipre3d_tpu_torch.data import Loader, SyntheticDataset, batch_to
from unipre3d_tpu_torch.models.layers import drop_path
from unipre3d_tpu_torch.training import trainer
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_splat_stream import one_torch_thread  # noqa: F401
from test_torch_utils import trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = ["data.training_resolution=32", "opt.batch_size=2",
         "data.dataset_root=synthetic", "opt.ema.update_after_step=1",
         "opt.ema.update_every=1",
         "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
         "layers_per_block: 1}",
         "model.backbone_overrides={depth: 2, drop_path_rate: 0.0}"]
LR = 1e-4


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def adam_state(opt_state):
    return next(leaf for leaf in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(leaf, "mu"))


@pytest.fixture(scope="module")
def steps():
    """Two steps of each package; returns per-step snapshots."""
    jcfg = _tiny_cfg(tiny_vae=True)
    apply_overrides(jcfg, SMALL[-3:])
    batch = _synthetic_batch(jcfg, 2)
    jmodel, tx, jstate = jtrainer.create_train_state(
        jcfg, jax.random.PRNGKey(0), batch)
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jmodel, tx))
    tcfg = load_config("transformer_pretraining", overrides=SMALL)
    tmodel, tstate = trainer.create_train_state(
        tcfg, device="cpu", state_dict=jax_to_state_dict(
            np_tree(jstate.params), np_tree(jstate.batch_stats)))
    tstep = trainer.make_train_step(tcfg, tmodel)
    names = [n for n, _ in trainer.split_frozen(tmodel)[0]]
    tb = batch_to(batch, "cpu")
    out = []
    for _ in range(2):
        jstate, jm = jstep(jstate, batch)
        tm = tstep(tstate, tb)
        out.append(dict(
            jm={k: float(v) for k, v in jm.items()}, tm=tm,
            jmu=jax_to_state_dict(np_tree(adam_state(jstate.opt_state).mu)),
            tmu=dict(zip(names, [m.clone() for m in tstate.optimizer.mu])),
            jp=jax_to_state_dict(np_tree(jstate.params),
                                 np_tree(jstate.batch_stats)),
            tp={k: v.clone() for k, v in tmodel.state_dict().items()},
            jema=jax_to_state_dict(np_tree(jstate.ema_params)),
            tema={k: v.clone() for k, v in tstate.ema.items()}))
    return names, out


def test_step_loss_and_metrics(steps):
    _, out = steps
    # step 2 starts from parameters that differ where step 1's gradient was
    # noise (see below): 1e-4 there
    for s, tol in zip(out, (1e-5, 1e-4)):
        for k in ("loss", "psnr", "grad_norm"):
            assert s["tm"][k] == pytest.approx(s["jm"][k], rel=tol), k


def test_step_gradients(steps):
    names, out = steps
    s = out[0]
    gmax = max(float(v.abs().max()) for v in s["jmu"].values())
    for n in names:
        j, t = s["jmu"][n], s["tmu"][n]
        if float(j.abs().max()) < 1e-3 * gmax:     # analytically zero
            assert float(t.abs().max()) < 1e-3 * gmax, n
        else:
            assert float((t - j).abs().max() / j.abs().max()) < 1e-4, n


def test_step_updated_params_bn_stats_and_ema_copy(steps):
    names, out = steps
    s = out[0]
    gmax = max(float(v.abs().max()) for v in s["jmu"].values())
    for n in names:
        diff = (s["tp"][n] - s["jp"][n]).abs()
        jmax = float(s["jmu"][n].abs().max())
        # an analytically zero gradient (biases ahead of a BatchNorm) is
        # noise everywhere
        noise = s["jmu"][n].abs() < (1e-3 * jmax if jmax >= 1e-3 * gmax
                                     else float("inf"))
        assert float(torch.where(noise, 0.0, diff).max()) < 1e-6, n
        assert float(diff.max()) <= 2 * LR * 1.001, n
        # update_after_step=1: step 1 copies the parameters into the EMA
        torch.testing.assert_close(s["tema"][n], s["tp"][n], rtol=0, atol=0)
    stats = [k for k in s["jp"] if "running_" in k]
    assert len(stats) == 4
    for k in stats:
        assert float((s["tp"][k] - s["jp"][k]).abs().max()
                     / s["jp"][k].abs().max()) < 1e-5, k


def test_second_step_ema_decays(steps):
    names, out = steps
    s1, s2 = out
    beta = 0.9999
    for n in names:
        # the port's own rule, exactly
        want = s1["tema"][n] * beta + s2["tp"][n] * (1.0 - beta)
        torch.testing.assert_close(s2["tema"][n], want, rtol=0, atol=0)
        # and JAX's, up to the step-1 parameter differences (a copy instead
        # of a decay would be off by ~lr everywhere)
        bound = (s1["tp"][n] - s1["jp"][n]).abs() + \
            (1 - beta) * (s2["tp"][n] - s2["jp"][n]).abs() + \
            4 * torch.finfo(torch.float32).eps * s2["jema"][n].abs() + 1e-7
        assert bool(((s2["tema"][n] - s2["jema"][n]).abs() <= bound).all()), n


def test_optimizer_matches_optax_with_nan_skip_and_schedule():
    """Clip, AdamW, the staircase StepLR and the NaN skip against the JAX
    package's optax chain, update by update (float32: 1e-6 relative)."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = [torch.from_numpy(p0["a"].copy()), torch.from_numpy(p0["b"].copy())]
    opt = trainer.AdamW(tp, base_lr=1e-2, step_lr=2, lr_gamma=0.5)
    tx, _ = jtrainer.make_optimizer(
        load_config("transformer_pretraining", overrides=[
            "opt.step_lr=2", "opt.lr_gamma=0.5", "opt.base_lr=0.01"]))
    js = tx.init(jp)
    for k in range(6):
        scale = 0.3 if k % 2 else 3.0          # below and above clip 1.0
        g = {n: (rng.normal(size=v.shape) * scale).astype(np.float32)
             for n, v in p0.items()}
        if k == 3:
            g["b"][1] = np.nan
        upd, js = tx.update({n: jnp.asarray(v) for n, v in g.items()}, js, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, upd)
        tg = [torch.from_numpy(g["a"]), torch.from_numpy(g["b"])]
        norm = torch.sqrt(sum((t * t).sum() for t in tg))
        applied = opt.update(tg, norm)
        assert applied == (k != 3)
        for t, n in zip(tp, ("a", "b")):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-7)
    assert opt.count == 5 and opt.lr() == pytest.approx(1e-2 * 0.25)


def test_drop_path_uses_its_generator():
    x = torch.ones(4096, 3)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = drop_path(x, 0.25, g1, training=True)
    b = drop_path(x, 0.25, g2, training=True)
    torch.testing.assert_close(a, b)
    kept = (a[:, 0] > 0).float().mean()
    assert abs(float(kept) - 0.75) < 0.03
    assert set(torch.unique(a).tolist()) <= {
        0.0, torch.tensor(1.0 / 0.75).item()}
    assert drop_path(x, 0.25, g1, training=False) is x


def test_synthetic_dataset_and_loader_are_seeded():
    cfg = load_config("transformer_pretraining", overrides=SMALL)
    a = SyntheticDataset(cfg, num_objects=3, num_views=5, device="cpu")
    b = SyntheticDataset(cfg, num_objects=3, num_views=5, device="cpu")
    np.testing.assert_array_equal(a.gt_images, b.gt_images)
    assert a.gt_images.shape == (3, 5, 3, 32, 32)
    # the objects are visible: not all background
    assert (a.gt_images.reshape(3, 5, -1).max(-1) > 0.3).all()
    batch = next(Loader(a, 4, seed=1).epoch(0))
    again = next(Loader(b, 4, seed=1).epoch(0))
    for k in batch:
        np.testing.assert_array_equal(batch[k], again[k])
    assert batch["gt_images"].shape == (4, 5, 3, 32, 32)
    assert batch["point_cloud"].shape == (4, 1024, 3)


def test_cli_trains_on_cpu(tmp_path):
    res = train_network.main(
        ["--config-name", "transformer_pretraining", "--device", "cpu",
         "--output-dir", str(tmp_path), "opt.iterations=2",
         "logging.loss_log=1", "tpu.compute_dtype=float32",
         "tpu.vae_cache_entries=0"] + SMALL)
    assert len(res["losses"]) == 2
    assert all(math.isfinite(x) for x in res["losses"] + res["psnrs"])
