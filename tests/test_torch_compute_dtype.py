"""PyTorch port vs the JAX package in the bfloat16 compute dtype.

Both packages compute in bfloat16 from the same float32 weights (a JAX
float32 init converted by unipre3d_tpu_torch/weights.py) on the same numpy
inputs, at the small size of tests/test_torch_models.py (32x32 views,
batch 2, VAE [32, 32, 32, 32] x 1, transformer depth 2 without DropPath).

Module by module, a few ops deep: a transformer ``Block``, the
mini-PointNet with its BatchNorms in train mode, a VAE resnet block and
attention block, a SubMConv block with ``MaskedBatchNorm`` in train mode
(with the gradients of its sparse conv), and the object fusion. Each
output's dtype equals JAX's, and its values agree within
``TOL_MODULE = 2e-2`` of the output's largest magnitude: a few bfloat16
ulps (8 significant bits, 2^-8 = 3.9e-3 relative), since the two packages
round at different points (torch adds a bias inside the product and
evaluates GELU, SiLU and the softmax's input in float before one rounding,
XLA rounds after each op). The float32 running stats of the BatchNorms,
0.99 x the old ones + 0.01 x a bfloat16 batch's statistics: 1e-4. The
sparse conv's gradients: ``TOL_GRAD = 3e-2`` (a bfloat16 product of
bfloat16 cotangents).

The whole predictor cannot be held at one tolerance: bfloat16 moves
JAX's own activated gaussians from its float32 ones by up to 0.33 of a
field's largest magnitude (the rotation; xyz 0.11, opacity 0.04 at this
size and seed), and the port's bfloat16 run moves by as much, in other
directions: two bfloat16 runs that round at different points land as far
from each other as from float32, so the port's bfloat16 gaussians are no
nearer JAX's bfloat16 ones than JAX's float32 ones are (measured: 1.2-1.9
times farther, per field). Held instead, per field, two bounds on gaps
measured in the same test against JAX's own bfloat16-vs-float32 gap: the
port-vs-JAX bfloat16 gap is at most ``GAP_MULTIPLE = 3`` times it
(measured: at most 1.9 times), and the port's own bfloat16-vs-float32 gap
is at least ``GAP_FLOOR = 0.25`` times it (measured: 0.55-1.2 times). The
second bound fails a port that computes in float32 whatever dtype it is
given (its own gap is 0). The loss of one bfloat16 train step: within
``TOL_LOSS = 2e-2`` relative of JAX's bfloat16 step and of the port's own
float32 step (chip_smoke.py holds the full-width step on the card to the
same), and at least ``GAP_FLOOR`` times JAX's own bfloat16-vs-float32
loss gap away from the port's float32 step (measured: 0.81 times at one
thread, the tests' setting; 3.2 times at four); finite
gradients and no NaN skip.

Float32 stays float32: at ``dtype=torch.float32`` every module's output is
float32 and equals, bit for bit, what the torch modules the port used
before the compute dtype existed (``nn.Linear``, ``nn.LayerNorm``,
``nn.Conv2d``, ``nn.GroupNorm``) give on the same weights.
"""

import copy
from typing import Any

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from __graft_entry__ import _synthetic_batch, _tiny_cfg
from unipre3d_tpu.models import fusion as jfusion
from unipre3d_tpu.models import sparseunet as jspunet
from unipre3d_tpu.models import vae as jvae
from unipre3d_tpu.models.gaussian_predictor import ImageConv
from unipre3d_tpu.models.gaussian_predictor import \
    build_predictor as jbuild_predictor
from unipre3d_tpu.models.layers import Block, PointGroupEncoder
from unipre3d_tpu.ops import sparse as jsp
from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu.training.config import apply_overrides
from unipre3d_tpu.utils.camera import intrinsics_from_fov
from unipre3d_tpu_torch.data import batch_to
from unipre3d_tpu_torch.models import fusion as tfusion
from unipre3d_tpu_torch.models import layers as tlayers
from unipre3d_tpu_torch.models import sparseunet as tspunet
from unipre3d_tpu_torch.models import vae as tvae
from unipre3d_tpu_torch.models.gaussian_predictor import build_predictor
from unipre3d_tpu_torch.ops import sparse as tsp
from unipre3d_tpu_torch.training import trainer
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = ["data.training_resolution=32", "opt.batch_size=2",
         "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
         "layers_per_block: 1}",
         "model.backbone_overrides={depth: 2, drop_path_rate: 0.0}"]
TOL_MODULE = 2e-2
TOL_STATS = 1e-4
TOL_GRAD = 3e-2
GAP_MULTIPLE = 3.0
GAP_FLOOR = 0.25
TOL_LOSS = 2e-2
BF16 = torch.bfloat16
GAUSSIAN_KEYS = ("xyz", "opacity", "scaling", "rotation", "features_dc",
                 "features_rest")


def rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-12)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def bf16_pair(x):
    """The same bfloat16 values on both sides (both round to nearest
    even)."""
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF16)


def as_np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def setup():
    """JAX float32 init of the small object predictor; the port's
    predictor in bfloat16 on the same weights."""
    jcfg = _tiny_cfg(tiny_vae=True)
    apply_overrides(jcfg, SMALL[-1:])
    batch = _synthetic_batch(jcfg, 2)
    _, _, state = jtrainer.create_train_state(jcfg, jax.random.PRNGKey(0),
                                              batch)
    params, stats = np_tree(state.params), np_tree(state.batch_stats)
    tmodel = build_predictor(load_config("transformer_pretraining",
                                         overrides=SMALL), dtype=BF16)
    tmodel.load_state_dict(jax_to_state_dict(params, stats))
    return jcfg, batch, params, stats, tmodel.eval()


def test_transformer_block(setup):
    _, _, params, _, tmodel = setup
    xj, xt = bf16_pair(np.random.default_rng(0).normal(
        size=(2, 129, 384)).astype(np.float32))
    ja = Block(384, 6, dtype=jnp.bfloat16).apply(
        {"params": params["point_network"]["encoder"]["block0"]}, xj)
    with torch.no_grad():
        tb = tmodel.point_network.encoder.block0(xt)
    assert ja.dtype == jnp.bfloat16 and tb.dtype == BF16
    assert rel_err(ja, as_np(tb)) < TOL_MODULE


def test_mini_pointnet_batchnorm_train_mode(setup):
    _, _, params, stats, tmodel = setup
    groups = np.random.default_rng(1).normal(
        scale=0.1, size=(2, 128, 32, 3)).astype(np.float32)
    enc_p = params["point_network"]["encoder"]["encoder"]
    enc_s = stats["point_network"]["encoder"]["encoder"]
    ja, upd = PointGroupEncoder(384, dtype=jnp.bfloat16).apply(
        {"params": enc_p, "batch_stats": enc_s}, jnp.asarray(groups),
        train=True, mutable=["batch_stats"])
    tenc = copy.deepcopy(tmodel.point_network.encoder.encoder).train()
    with torch.no_grad():
        tb = tenc(torch.from_numpy(groups))
    assert ja.dtype == jnp.bfloat16 and tb.dtype == BF16
    assert rel_err(ja, as_np(tb)) < TOL_MODULE
    js = jax_to_state_dict({}, np_tree(upd["batch_stats"]))
    for name, buf in tenc.named_buffers():
        assert buf.dtype == torch.float32
        assert rel_err(js[name], buf.numpy()) < TOL_STATS, name


@pytest.mark.parametrize("block", ["resnet", "attention"])
def test_vae_blocks(setup, block):
    _, _, params, _, tmodel = setup
    enc = params["image_network"]["encoder"]
    tenc = tmodel.image_network.encoder
    if block == "resnet":
        jmod, p = jvae.ResnetBlock2D(32, dtype=jnp.bfloat16), \
            enc["down_0_resnet_0"]
        tmod, hw = tenc.down_blocks[0].resnets[0], 16
    else:
        jmod, p = jvae.AttnBlock(32, dtype=jnp.bfloat16), \
            enc["mid"]["attentions_0"]
        tmod, hw = tenc.mid_block.attentions[0], 8
    x = np.random.default_rng(2).normal(size=(2, hw, hw, 32)).astype(
        np.float32)
    xj, xt = bf16_pair(x)
    ja = jmod.apply({"params": p}, xj)                       # NHWC
    with torch.no_grad():
        tb = tmod(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert ja.dtype == jnp.bfloat16 and tb.dtype == BF16
    assert rel_err(ja, as_np(tb)) < TOL_MODULE


def voxel_set(M=300, n_valid=260, grid=10, seed=3):
    """One scene's canonical voxel set (distinct coordinates, a padded
    tail) and its 3^3 neighbour table, in both packages."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(grid ** 3, M, replace=False)
    coords = np.stack(np.unravel_index(cells, (grid,) * 3), 1).astype(
        np.int32)
    mask = np.arange(M) < n_valid
    nofeat = np.zeros((M, 1), np.float32)
    jsv, _ = jsp.canonicalize(jnp.asarray(coords), jnp.asarray(nofeat),
                              jnp.asarray(mask))
    tsv, _ = tsp.canonicalize(torch.from_numpy(coords),
                              torch.from_numpy(nofeat),
                              torch.from_numpy(mask))
    nbr_j = jsp.find_neighbors(jsv, jsp.kernel_offsets(3))
    nbr_t = tsp.find_neighbors(tsv, tsp.kernel_offsets(3))
    np.testing.assert_array_equal(np.asarray(nbr_j), nbr_t.numpy())
    return nbr_j[None], nbr_t[None], jsv.mask[None], tsv.mask[None]


def test_subm_conv_block_with_masked_batchnorm():
    """The scene ``fusion_mlps`` (SubMConv k3 with bias + MaskedBatchNorm +
    ReLU) in train mode, and the gradients of its input and kernel through
    the mirror-flip backward, in bfloat16."""
    C = 16
    nbr_j, nbr_t, mask_j, mask_t = voxel_set()
    x = np.random.default_rng(4).normal(size=(1, 300, C)).astype(np.float32)
    cot = np.random.default_rng(5).normal(size=(1, 300, C)).astype(
        np.float32)
    jblock = jspunet.SubMConvBlock(C, dtype=jnp.bfloat16)
    xj, xt = bf16_pair(x)
    variables = jblock.init(jax.random.PRNGKey(1), xj, nbr_j, mask_j)
    p, s = np_tree(variables["params"]), np_tree(variables["batch_stats"])

    def jloss(p, xj):
        y, upd = jblock.apply({"params": p, "batch_stats": s}, xj, nbr_j,
                              mask_j, train=True, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, upd)

    (_, (jy, jupd)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, xj)
    tblock = tspunet.SubMConvBlock(C, C, dtype=BF16).train()
    tblock.load_state_dict(jax_to_state_dict(p, s))
    xt.requires_grad_(True)
    ty = tblock(xt, nbr_t, mask_t)
    (ty.float() * torch.from_numpy(cot)).sum().backward()
    assert jy.dtype == jnp.bfloat16 and ty.dtype == BF16
    assert rel_err(jy, as_np(ty)) < TOL_MODULE
    js = jax_to_state_dict({}, np_tree(jupd["batch_stats"]))
    for name, buf in tblock.named_buffers():
        assert buf.dtype == torch.float32
        assert rel_err(js[name], buf.numpy()) < TOL_STATS, name
    assert jgx.dtype == jnp.bfloat16 and xt.grad.dtype == BF16
    assert rel_err(jgx, as_np(xt.grad)) < TOL_GRAD
    jg = jax_to_state_dict(np_tree(jgp))
    w = tblock.conv.weight
    assert w.dtype == torch.float32 and w.grad.dtype == torch.float32
    assert rel_err(jg["conv.weight"], w.grad.numpy()) < TOL_GRAD


class JaxObjectFusion(fnn.Module):
    """The object path's fusion with the predictor's own modules: the
    pre-normalized map's rows through ``ImageConv.proj_rows`` after the
    gather, then the fusion MLP."""
    dtype: Any = jnp.bfloat16

    def setup(self):
        self.image_conv = ImageConv(384, feat_ch=32, dtype=self.dtype)
        self.fusion_mlps = fnn.Sequential([fnn.Dense(384, dtype=self.dtype),
                                           fnn.relu])

    def __call__(self, x, center, feats, c2w, K):
        return jfusion.feature_fusion(x, center, feats, c2w, K,
                                      self.fusion_mlps,
                                      self.image_conv.proj_rows)


def test_object_fusion(setup):
    _, batch, params, _, tmodel = setup
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 129, 384)).astype(np.float32)
    center = rng.uniform(-0.5, 0.5, (2, 128, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 32, 32, 32)).astype(np.float32)
    c2w = batch["view_to_world_transforms"][:, :1]
    K = intrinsics_from_fov(49.13434264120263, 32)
    xj, xt = bf16_pair(x)
    fj, ft = bf16_pair(feats)
    ja = JaxObjectFusion().apply(
        {"params": {"image_conv": params["image_conv"],
                    "fusion_mlps": params["fusion_mlps"]}},
        xj, jnp.asarray(center), fj, jnp.asarray(c2w), jnp.asarray(K))
    with torch.no_grad():
        tb = tfusion.feature_fusion(
            xt, torch.from_numpy(center), ft, torch.from_numpy(c2w),
            torch.from_numpy(K), tmodel.fusion_mlps,
            tmodel.image_conv.proj_rows)
    assert ja.dtype == jnp.bfloat16 and tb.dtype == BF16
    assert rel_err(ja, as_np(tb)) < TOL_MODULE


def test_predictor_gap_is_a_multiple_of_jax_own_bf16_gap(setup):
    jcfg, batch, params, stats, tmodel = setup
    args = (jnp.asarray(batch["point_cloud"]),
            jnp.asarray(batch["gt_images"][:, :1]),
            jnp.asarray(batch["view_to_world_transforms"][:, :1]))
    variables = {"params": params, "batch_stats": stats}
    out = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jm = jbuild_predictor(jcfg, dtype=dt)
        out[dt] = jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
            variables, *args)
    t32 = build_predictor(load_config("transformer_pretraining",
                                      overrides=SMALL))
    t32.load_state_dict(jax_to_state_dict(params, stats))
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    with torch.no_grad():
        tg = tmodel(*targs)
        tf = t32.eval()(*targs)
    for k in GAUSSIAN_KEYS:
        assert tg[k].dtype == torch.float32   # activate casts to float32
        jax_gap = rel_err(out[jnp.float32][k], out[jnp.bfloat16][k])
        port_gap = rel_err(out[jnp.bfloat16][k], tg[k].numpy())
        own_gap = rel_err(tf[k].numpy(), tg[k].numpy())
        assert port_gap <= GAP_MULTIPLE * jax_gap, (k, port_gap, jax_gap)
        assert own_gap >= GAP_FLOOR * jax_gap, (k, own_gap, jax_gap)


def test_train_step_loss(setup):
    jcfg, batch, params, stats, _ = setup
    jloss = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jmodel, tx, jstate = jtrainer.create_train_state(
            jcfg, jax.random.PRNGKey(0), batch, dtype=dt)
        jstate = jstate._replace(params=params, ema_params=params,
                                 batch_stats=stats,
                                 opt_state=tx.init(jtrainer.split_frozen(
                                     params)[0]))
        _, jm = jax.jit(jtrainer.make_train_step(jcfg, jmodel, tx))(jstate,
                                                                      batch)
        jloss[dt] = float(jm["loss"])
    tcfg = load_config("transformer_pretraining", overrides=SMALL + [
        "data.dataset_root=synthetic"])
    tmodel, tstate = trainer.create_train_state(
        tcfg, device="cpu", state_dict=jax_to_state_dict(params, stats),
        dtype=BF16)
    tm = trainer.make_train_step(tcfg, tmodel)(tstate, batch_to(batch, "cpu"))
    j16 = jloss[jnp.bfloat16]
    assert abs(tm["loss"] - j16) <= TOL_LOSS * j16
    fmodel, fstate = trainer.create_train_state(
        tcfg, device="cpu", state_dict=jax_to_state_dict(params, stats))
    fm = trainer.make_train_step(tcfg, fmodel)(fstate, batch_to(batch, "cpu"))
    assert abs(tm["loss"] - fm["loss"]) <= TOL_LOSS * fm["loss"]
    jax_gap = abs(j16 - jloss[jnp.float32])
    assert abs(tm["loss"] - fm["loss"]) >= GAP_FLOOR * jax_gap, \
        (tm["loss"], fm["loss"], jax_gap)
    assert np.isfinite(tm["grad_norm"]) and tm["nan_skipped"] == 0.0
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    assert all(bool(torch.isfinite(m).all()) for m in tstate.optimizer.mu)


def test_float32_modules_equal_the_plain_torch_modules():
    rng = np.random.default_rng(7)
    torch.manual_seed(0)
    x = torch.from_numpy(rng.normal(size=(4, 9, 24)).astype(np.float32))
    img = torch.from_numpy(rng.normal(size=(2, 32, 8, 8)).astype(np.float32))
    pairs = [(tlayers.Dense(24, 16), nn.Linear(24, 16), x),
             (tlayers.LayerNorm(24), nn.LayerNorm(24, eps=tlayers.LN_EPS),
              x),
             (tvae.Conv2d(32, 16, 3, padding=1),
              nn.Conv2d(32, 16, 3, padding=1), img),
             (tvae.GroupNorm(32), nn.GroupNorm(32, 32, eps=tvae.GN_EPS),
              img)]
    for ours, plain, inp in pairs:
        with torch.no_grad():
            for p in ours.parameters():
                p.normal_()
        plain.load_state_dict(ours.state_dict())
        a, b = ours(inp), plain(inp)
        assert a.dtype == torch.float32
        assert torch.equal(a, b), type(ours).__name__


def test_float32_predictor_stays_float32(setup):
    """Every module's output of the float32 predictor is float32 and the
    gaussians equal a second build's; the bfloat16 predictor's modules
    return bfloat16 where JAX's do."""
    jcfg, batch, params, stats, tmodel16 = setup
    cfg = load_config("transformer_pretraining", overrides=SMALL)
    sd = jax_to_state_dict(params, stats)
    args = [torch.from_numpy(batch["point_cloud"]),
            torch.from_numpy(batch["gt_images"][:, :1]),
            torch.from_numpy(batch["view_to_world_transforms"][:, :1])]
    seen = {}

    def record(name):
        def hook(_, __, out):
            if torch.is_tensor(out):
                seen[name] = out.dtype
        return hook

    outs = []
    for dtype in (torch.float32, None):
        m = build_predictor(cfg) if dtype is None else \
            build_predictor(cfg, dtype=dtype)
        m.load_state_dict(sd)
        m.eval()
        hooks = [mod.register_forward_hook(record(n))
                 for n, mod in m.named_modules() if n]
        with torch.no_grad():
            outs.append(m(*args))
        for h in hooks:
            h.remove()
        assert set(seen.values()) == {torch.float32}
        seen.clear()
    for k in GAUSSIAN_KEYS:
        assert torch.equal(outs[0][k], outs[1][k]), k
    hooks = [mod.register_forward_hook(record(n))
             for n, mod in tmodel16.named_modules() if n]
    with torch.no_grad():
        tmodel16(*args)
    for h in hooks:
        h.remove()
    assert seen["point_network.encoder.block0"] == BF16
    assert seen["point_network.encoder.block0.norm1"] == BF16
    assert seen["point_network.encoder.encoder.bn1"] == BF16
    assert seen["image_network.encoder.down_blocks.0.resnets.0.norm1"] == BF16
