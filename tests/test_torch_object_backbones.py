"""PyTorch port vs the JAX package: the PointMLP, Mamba3D and PCM object
backbones, module by module and through one whole object train step each.

Same numpy inputs through both packages, weights converted from a JAX init
by unipre3d_tpu_torch/weights.py; float32 on the CPU unless stated.

* Each encoder at the JAX package's test sizes, in train mode: its outputs
  within 1e-4 of their largest magnitude, every parameter gradient within
  ``TOL_ENC_GRAD = 3e-4`` relative to its largest entry (float32 sums in
  other orders through 8-20 BatchNorms; measured up to 1.05e-4, PointMLP's
  stage-0 BatchNorm biases, whose gradients reach 8e2), BatchNorm running
  stats within 1e-5. Biases ahead of a BatchNorm and the groupers' affine
  beta (which feeds a Dense ahead of one) have an analytically zero
  gradient: both sides must be noise, < 1e-3 of the largest gradient.
  PCM's FPS-windowed path at a window of 64 points.
* One float32 object train step per backbone through the whole predictor
  at full backbone width (the JAX package reads no backbone overrides for
  these three, so both packages' constructors are patched alike, ``CUT``):
  depth cut (PointMLP one residual block a stage, Mamba3D 2 blocks, PCM one
  mamba block a stage over 4 of its orders), DropPath and Dropout at rate
  0; tiny VAE, batch 1, 256 points, 32x32. The loss within 1e-5 relative.
  Gradients (from Adam's first moment, 0.1 x the clipped gradient, with
  the clip undone), per parameter tensor and over all of them in relative
  L2: within
  ``TOL_STEP_GRAD = 1e-3``, or within 3x the distance JAX's own gradient
  moves when its parameters are scaled by 1 + 1e-6 where that is larger.
  Gradients below 1e-3 of the largest that move by over 10% under that
  perturbation are the rounding noise of an analytically zero gradient
  (biases ahead of a BatchNorm): the port's must be as small.
  At random init PointMLP's and PCM's max-pools over K neighbours hold
  near-ties that a 1e-6 perturbation flips: JAX's own gradients then move
  by up to ~100% below the flipped pools (measured for PointMLP at full
  depth), as the scene step's ReLU ties do (test_torch_scene_step.py), and
  no implementation can be held closer than that. The JAX step compiles
  for tens of seconds, so it runs once per test run
  (``shared_across_workers``).
* bfloat16, module by module a few ops deep (MambaMixer, LNPBlock,
  ConvBNReLURes in train mode, PCM's MambaBlock): each output's dtype
  equals JAX's and its values agree within ``TOL_MODULE = 2e-2`` of its
  largest magnitude (tests/test_torch_compute_dtype.py gives the reasons).
  The whole Mamba3D predictor (full width, 2 blocks) by the criteria of
  that file's ``test_predictor_gap_is_a_multiple_of_jax_own_bf16_gap``:
  the port-vs-JAX bfloat16 gap at most 3x JAX's own bfloat16-vs-float32
  gap per gaussian field, and the port's own bfloat16-vs-float32 gap at
  least 0.25x it (which a port that ignores its dtype fails).
* Held differences and quirks: the port raises on ``backbone_overrides``
  for these three (JAX ignores them); Mamba3D's gaussians all take the
  learned CLS position as centre; SegHead's Dropout drops at its rate in
  train mode, from the step's generator.
* The CLI trains each configuration for two steps on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch, _tiny_cfg
from unipre3d_tpu.models import mamba3d as jm3d
from unipre3d_tpu.models import mamba_mixer as jmix
from unipre3d_tpu.models import pcm as jpcm
from unipre3d_tpu.models import pointmlp as jpmlp
from unipre3d_tpu.models.gaussian_predictor import \
    build_predictor as jbuild_predictor
from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu_torch import train_network
from unipre3d_tpu_torch.data import batch_to
from unipre3d_tpu_torch.models import mamba3d as tm3d
from unipre3d_tpu_torch.models import mamba_mixer as tmix
from unipre3d_tpu_torch.models import pcm as tpcm
from unipre3d_tpu_torch.models import pointmlp as tpmlp
from unipre3d_tpu_torch.models.gaussian_predictor import build_predictor
from unipre3d_tpu_torch.training import trainer
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_scene_step import adam_state, shared_across_workers
from test_torch_utils import (  # noqa: F401
    one_torch_thread, run_dir, trimmed_heap)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BACKBONES = ("pointmlp", "mamba3d", "pcm")
TINY_VAE = ("model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
            "layers_per_block: 1}")
SMALL = ["data.training_resolution=32", "opt.batch_size=1",
         "data.dataset_root=synthetic", "opt.ema.update_after_step=1",
         TINY_VAE]
TOL_MODULE = 2e-2
TOL_STEP_GRAD = 1e-3
TOL_ENC_GRAD = 3e-4
GAP_MULTIPLE = 3.0
GAP_FLOOR = 0.25
BF16 = torch.bfloat16
GAUSSIAN_KEYS = ("xyz", "opacity", "scaling", "rotation", "features_dc",
                 "features_rest")


def rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-12)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def as_np(t):
    return t.detach().float().numpy()


def flat_outputs(out):
    """Every tensor of an encoder's output (nested tuples and lists)."""
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in flat_outputs(o)]
    return [out]


# --------------------------------------------------------------------------
# encoders at small size, train mode, float32
# --------------------------------------------------------------------------

def encoder_cases():
    """name -> (JAX module, port module, input [B, N, C]). The windowed
    PCM case folds stage 0's 128 points into 2 windows of 64, one mamba
    block a stage (``CUT``'s depth)."""
    rng = np.random.default_rng(0)
    pts4 = rng.uniform(-0.5, 0.5, (2, 64, 4)).astype(np.float32)
    pts3 = rng.uniform(-0.5, 0.5, (2, 128, 3)).astype(np.float32)
    pts_w = rng.uniform(-0.5, 0.5, (1, 256, 3)).astype(np.float32)
    mlp = dict(in_channels=4, embed_dim=8, de_dims=(16, 16, 8, 8),
               k_neighbors=(4, 4, 4, 4))
    m3d = dict(trans_dim=64, depth=2, num_group=16, group_size=8,
               drop_path_rate=0.0)
    pcm = dict(embed_dim=32, drop_path_rate=0.0)
    pcm_w = dict(pcm, **CUT["pcm"])
    return {
        "pointmlp": (jpmlp.PointMLPEncoder(**mlp),
                     tpmlp.PointMLPEncoder(**mlp), pts4),
        "mamba3d": (jm3d.Mamba3DEncoder(**m3d), tm3d.Mamba3DEncoder(**m3d),
                    pts3),
        "pcm": (jpcm.PointMambaEncoder(in_channels=4, **pcm),
                tpcm.PointMambaEncoder(in_channels=4, **pcm), pts4),
        "pcm_windows": (
            jpcm.PointMambaEncoder(in_channels=3, use_windows=True,
                                   windows_size=64, **pcm_w),
            tpcm.PointMambaEncoder(in_channels=3, use_windows=True,
                                   windows_size=64, **pcm_w), pts_w),
    }


@pytest.mark.parametrize("name", ["pointmlp", "mamba3d", "pcm",
                                  "pcm_windows"])
def test_encoder_train_mode_forward_grads_and_bn_stats(name):
    jenc, tenc, pts = encoder_cases()[name]
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda: jenc.init({"params": key, "droppath": key},
                                          jnp.asarray(pts)))()
    params, stats = variables["params"], variables["batch_stats"]
    outs = jax.jit(lambda v: jenc.apply(v, jnp.asarray(pts), train=True,
                                        mutable=["batch_stats"]))(
        variables)[0]
    ws = [np.random.default_rng(i).normal(size=o.shape).astype(np.float32)
          for i, o in enumerate(flat_outputs(outs))]

    def jloss(p):
        out, upd = jenc.apply({"params": p, "batch_stats": stats},
                              jnp.asarray(pts), train=True,
                              mutable=["batch_stats"])
        return sum(jnp.sum(o * w) for o, w in zip(flat_outputs(out), ws)), \
            (flat_outputs(out), upd["batch_stats"])

    (_, (jout, jstats)), jgrad = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    tenc.load_state_dict(jax_to_state_dict(np_tree(params), np_tree(stats)))
    tenc.train()
    tout = flat_outputs(tenc(torch.from_numpy(pts)))
    assert len(tout) == len(jout)
    sum((o * torch.from_numpy(w)).sum()
        for o, w in zip(tout, ws)).backward()
    for a, b in zip(jout, tout):
        assert a.shape == tuple(b.shape)
        assert rel_err(a, as_np(b)) < 1e-4
    jg = jax_to_state_dict(np_tree(jgrad))
    gmax = max(np.abs(v.numpy()).max() for v in jg.values())
    for n, p in tenc.named_parameters():
        if np.abs(jg[n].numpy()).max() < 1e-3 * gmax:   # analytically 0
            assert p.grad is None or float(p.grad.abs().max()) < 1e-3 * gmax
        else:
            assert rel_err(jg[n], p.grad.numpy()) < TOL_ENC_GRAD, n
    js = jax_to_state_dict({}, np_tree(jstats))
    for n, buf in tenc.named_buffers():
        assert rel_err(js[n], buf.numpy()) < 1e-5, n


# --------------------------------------------------------------------------
# one whole object train step per backbone, float32, full backbone width
# --------------------------------------------------------------------------

# the step tests' cut of depth (width untouched) and rate-0 DropPath and
# Dropout, applied alike to both packages' constructors
CUT = {
    "pointmlp": dict(pre_blocks=(1, 1, 1, 1), pos_blocks=(1, 1, 1, 1),
                     de_blocks=(1, 1, 1, 1)),
    "mamba3d": dict(depth=2, drop_path_rate=0.0),
    "pcm": dict(mamba_blocks=(1, 1, 1, 1),
                mamba_layers_orders=("xyz", "zyx", "hilbert", "z-trans"),
                drop_path_rate=0.0),
}


def cut_jax(mp, backbone):
    """The JAX backbone constructors with the ``CUT`` defaults (the JAX
    predictor reads no overrides for these three) and SegHead's Dropout at
    rate 0."""
    import dataclasses
    mod, name = {"pointmlp": (jpmlp, "PointMLPEncoder"),
                 "mamba3d": (jm3d, "Mamba3DEncoder"),
                 "pcm": (jpcm, "PointMambaEncoder")}[backbone]
    cls = getattr(mod, name)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    ns = {"__annotations__": {k: fields[k].type for k in CUT[backbone]},
          **CUT[backbone]}
    mp.setattr(mod, name, type(name, (cls,), ns))
    mp.setattr(jpcm, "SegHead", type("SegHead", (jpcm.SegHead,), {
        "__annotations__": {"dropout": float}, "dropout": 0.0}))


def cut_port(mp, backbone):
    """The same for the port's constructors."""
    import functools
    from unipre3d_tpu_torch.models import gaussian_predictor as tgp
    if backbone == "pcm":
        mp.setattr(tpcm, "PointMambaEncoder", functools.partial(
            tpcm.PointMambaEncoder, **CUT["pcm"]))
    else:
        name = {"pointmlp": "PointMLPEncoder",
                "mamba3d": "Mamba3DEncoder"}[backbone]
        mp.setattr(tgp, name, functools.partial(getattr(tgp, name),
                                                **CUT[backbone]))
    mp.setattr(tpcm, "SegHead", functools.partial(tpcm.SegHead,
                                                  dropout=0.0))


def jax_config(backbone):
    jcfg = _tiny_cfg(backbone=backbone, batch=1, tiny_vae=True)
    jcfg.model.backbone_overrides = None
    return jcfg


def jax_object_step(backbone):
    """The JAX side: the converted init, metrics and Adam's first moment
    after one step; and Adam's first moment after the same step from the
    parameters scaled by 1 + 1e-6 (``jmu_moved``: how far JAX's own
    gradients move under a perturbation at float32's rounding), as
    {group: {name: tensor}}."""
    jcfg = jax_config(backbone)
    batch = _synthetic_batch(jcfg, 1, n_points=256, n_views=3)
    with pytest.MonkeyPatch.context() as mp:
        cut_jax(mp, backbone)
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
                              jm_moved["grad_norm"]))


def unclipped(mu, grad_norm):
    """The gradient from Adam's first moment after one step: mu = 0.1 x the
    gradient clipped to norm 1. Unclipped, so that the clip factor (which a
    gradient norm held only to rounding moves) scales no comparison."""
    scale = 10.0 * max(float(grad_norm), 1.0)
    if isinstance(mu, list):
        return [m * scale for m in mu]
    return {k: v * scale for k, v in jax_to_state_dict(np_tree(mu)).items()}


def rel_l2(a, b):
    return float((b - a).norm() / (a.norm() + 1e-30))


@pytest.mark.parametrize("backbone", BACKBONES)
def test_object_train_step_matches_jax(tmp_path_factory, backbone):
    j = shared_across_workers(tmp_path_factory, f"jax_{backbone}_step",
                              lambda: jax_object_step(backbone))
    jcfg = jax_config(backbone)
    batch = _synthetic_batch(jcfg, 1, n_points=256, n_views=3)
    tcfg = load_config(f"{backbone}_pretraining", overrides=SMALL)
    with pytest.MonkeyPatch.context() as mp:
        cut_port(mp, backbone)
        tmodel, tstate = trainer.create_train_state(tcfg, device="cpu",
                                                    state_dict=j["init"])
    tm = trainer.make_train_step(tcfg, tmodel)(tstate,
                                               batch_to(batch, "cpu"))
    jm = {k: float(v) for k, v in j["jm"].items()}
    assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-5)
    assert tm["nan_skipped"] == 0.0
    names = [n for n, _ in trainer.split_frozen(tmodel)[0]]
    jg, jg_moved = j["jgrad"], j["jgrad_moved"]
    assert set(names) == set(jg)
    tg = dict(zip(names, unclipped(tstate.optimizer.mu, tm["grad_norm"])))
    gmax = max(float(v.abs().max()) for v in jg.values())
    for n in names:
        a, b = jg[n], tg[n]
        own = rel_l2(a, jg_moved[n])
        if float(a.abs().max()) < 1e-3 * gmax and own > 0.1:
            # the rounding noise of an analytically zero gradient
            assert float(b.abs().max()) < 1e-3 * gmax, n
        else:
            assert rel_l2(a, b) < max(TOL_STEP_GRAD, 3 * own), (n, own)
    flat = lambda g: torch.cat([g[n].flatten() for n in names])  # noqa
    assert rel_l2(flat(jg), flat(tg)) < max(
        TOL_STEP_GRAD, 3 * rel_l2(flat(jg), flat(jg_moved)))


# --------------------------------------------------------------------------
# bfloat16
# --------------------------------------------------------------------------

def bf16_pair(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF16)


def test_bf16_mamba_mixer():
    x = np.random.default_rng(1).normal(size=(2, 20, 32)).astype(np.float32)
    xj, xt = bf16_pair(x)
    jm = jmix.MambaMixer(32, dtype=jnp.bfloat16)
    p = jm.init(jax.random.PRNGKey(0), xj)["params"]
    ja = jax.jit(lambda p, x: jm.apply({"params": p}, x))(p, xj)
    tm = tmix.MambaMixer(32, dtype=BF16)
    tm.load_state_dict(jax_to_state_dict(np_tree(p)))
    with torch.no_grad():
        tb = tm(xt)
    assert ja.dtype == jnp.bfloat16 and tb.dtype == BF16
    assert rel_err(ja, as_np(tb)) < TOL_MODULE


def test_bf16_lnp_block():
    rng = np.random.default_rng(2)
    center = rng.uniform(-0.5, 0.5, (2, 16, 3)).astype(np.float32)
    feat = rng.normal(size=(2, 17, 64)).astype(np.float32)
    fj, ft = bf16_pair(feat)
    jm = jm3d.LNPBlock(64, dtype=jnp.bfloat16)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(center), fj)["params"]
    ja = jm.apply({"params": p}, jnp.asarray(center), fj)
    tm = tm3d.LNPBlock(64, dtype=BF16)
    tm.load_state_dict(jax_to_state_dict(np_tree(p)))
    with torch.no_grad():
        tb = tm(torch.from_numpy(center), ft)
    assert ja.dtype == jnp.bfloat16 and tb.dtype == BF16
    assert rel_err(ja, as_np(tb)) < TOL_MODULE


def test_bf16_conv_bn_relu_res_train_mode():
    x = np.random.default_rng(3).normal(size=(4, 24, 32)).astype(np.float32)
    xj, xt = bf16_pair(x)
    jm = jpmlp.ConvBNReLURes(32, dtype=jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(0), xj)
    ja, upd = jm.apply(v, xj, train=True, mutable=["batch_stats"])
    tm = tpmlp.ConvBNReLURes(32, dtype=BF16).train()
    tm.load_state_dict(jax_to_state_dict(np_tree(v["params"]),
                                         np_tree(v["batch_stats"])))
    with torch.no_grad():
        tb = tm(xt)
    assert ja.dtype == jnp.bfloat16 and tb.dtype == BF16
    assert rel_err(ja, as_np(tb)) < TOL_MODULE
    js = jax_to_state_dict({}, np_tree(upd["batch_stats"]))
    for n, buf in tm.named_buffers():
        assert buf.dtype == torch.float32
        assert rel_err(js[n], buf.numpy()) < 1e-4, n


def test_bf16_pcm_mamba_block():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 20, 32)).astype(np.float32)
    res = rng.normal(size=(2, 20, 32)).astype(np.float32)
    xj, xt = bf16_pair(x)
    jm = jpcm.MambaBlock(32, dtype=jnp.bfloat16)
    p = jm.init(jax.random.PRNGKey(0), xj, jnp.asarray(res))["params"]
    jh, jr = jm.apply({"params": p}, xj, jnp.asarray(res))
    tm = tpcm.MambaBlock(32, dtype=BF16)
    tm.load_state_dict(jax_to_state_dict(np_tree(p)))
    with torch.no_grad():
        th, tr = tm(xt, torch.from_numpy(res))
    assert jh.dtype == jnp.bfloat16 and th.dtype == BF16
    assert jr.dtype == jnp.float32 and tr.dtype == torch.float32
    assert rel_err(jh, as_np(th)) < TOL_MODULE
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


def jax_mamba3d_forwards():
    """JAX's Mamba3D predictor (full width, tiny VAE) in float32 and in
    bfloat16 from one float32 init, eval mode."""
    jcfg = jax_config("mamba3d")
    batch = _synthetic_batch(jcfg, 1, n_points=256, n_views=2)
    args = (jnp.asarray(batch["point_cloud"]),
            jnp.asarray(batch["gt_images"][:, :1]),
            jnp.asarray(batch["view_to_world_transforms"][:, :1]))
    key = jax.random.PRNGKey(0)
    with pytest.MonkeyPatch.context() as mp:
        cut_jax(mp, "mamba3d")
        jm = jbuild_predictor(jcfg)
        variables = jax.jit(lambda: jm.init(
            {"params": key, "droppath": key}, *args))()
        out = dict(init=jax_to_state_dict(np_tree(variables["params"]),
                                          np_tree(variables["batch_stats"])))
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            m = jbuild_predictor(jcfg, dtype=dt)
            o = jax.jit(lambda v, *a: m.apply(v, *a, train=False))(
                variables, *args)
            out[name] = {k: torch.from_numpy(np.array(o[k], np.float32))
                         for k in GAUSSIAN_KEYS}
    return out


def test_bf16_mamba3d_predictor_gap_is_a_multiple_of_jax_own(
        tmp_path_factory):
    j = shared_across_workers(tmp_path_factory, "jax_mamba3d_bf16",
                              jax_mamba3d_forwards)
    batch = _synthetic_batch(jax_config("mamba3d"), 1, n_points=256,
                             n_views=2)
    cfg = load_config("mamba3d_pretraining", overrides=SMALL)
    targs = [torch.from_numpy(batch["point_cloud"]),
             torch.from_numpy(batch["gt_images"][:, :1]),
             torch.from_numpy(batch["view_to_world_transforms"][:, :1])]
    tg = {}
    for name, dt in (("f32", torch.float32), ("bf16", BF16)):
        with pytest.MonkeyPatch.context() as mp:
            cut_port(mp, "mamba3d")
            m = build_predictor(cfg, dtype=dt)
        m.load_state_dict(j["init"])
        with torch.no_grad():
            tg[name] = m.eval()(*targs)
    for k in GAUSSIAN_KEYS:
        assert tg["bf16"][k].dtype == torch.float32
        jax_gap = rel_err(j["f32"][k], j["bf16"][k])
        port_gap = rel_err(j["bf16"][k], tg["bf16"][k].numpy())
        own_gap = rel_err(tg["f32"][k].numpy(), tg["bf16"][k].numpy())
        assert port_gap <= GAP_MULTIPLE * jax_gap, (k, port_gap, jax_gap)
        assert own_gap >= GAP_FLOOR * jax_gap, (k, own_gap, jax_gap)


# --------------------------------------------------------------------------
# held differences, quirks, CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", BACKBONES)
def test_backbone_overrides_raise(backbone):
    """JAX builds these three at full width whatever the overrides; the
    port refuses them instead of ignoring them."""
    cfg = load_config(f"{backbone}_pretraining", overrides=SMALL + [
        "model.backbone_overrides={depth: 2}"])
    with pytest.raises(ValueError, match="no backbone_overrides"):
        build_predictor(cfg)


def test_mamba3d_gaussians_take_the_cls_position_as_centre():
    cfg = load_config("mamba3d_pretraining", overrides=SMALL)
    model = build_predictor(cfg).eval()
    with torch.no_grad():
        model.point_network.encoder.cls_pos.normal_()
        pts = torch.rand(2, 256, 3) - 0.5
        out, center = model.point_network(pts)
        g = model.activate(out, center)
    assert center.shape == (2, 1, 384)
    cls = model.point_network.encoder.cls_pos[0, 0, :3]
    torch.testing.assert_close(
        g["xyz"], torch.tanh(out[..., :3]) + cls, rtol=0, atol=1e-6)
    assert g["xyz"].shape == (2, 128, 3)


def test_seg_head_dropout_rate_and_generator():
    """The SegHead's dropout: half the entries zeroed, the rest doubled,
    the mask a function of the generator's state, nothing in eval mode."""
    h = torch.rand(4, 64, 16) + 1.0
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    kept = tpcm.dropout(h, 0.5, gen(), True)
    zero = kept == 0
    assert abs(float(zero.float().mean()) - 0.5) < 0.02
    torch.testing.assert_close(kept[~zero], 2 * h[~zero])
    torch.testing.assert_close(tpcm.dropout(h, 0.5, gen(), True), kept)
    assert torch.equal(tpcm.dropout(h, 0.5, gen(), False), h)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_cli_trains_on_cpu(run_dir, backbone):
    """Full-size backbone, 1024 points, tiny VAE; float32 (bfloat16 is
    slow on the CPU; chip_smoke.py trains the default run on the card)."""
    res = train_network.main(
        ["--config-name", f"{backbone}_pretraining", "--device", "cpu",
         "--output-dir", str(run_dir), "opt.iterations=2",
         "logging.loss_log=1", "data.training_resolution=32",
         "opt.batch_size=1", "data.dataset_root=synthetic",
         "tpu.compute_dtype=float32", "tpu.vae_cache_entries=0", TINY_VAE])
    assert len(res["losses"]) == 2
    assert all(math.isfinite(x) for x in res["losses"] + res["grad_norms"])
    assert res["nan_skipped"] == [0.0, 0.0]
    assert (run_dir / "model_latest.ckpt").exists()

