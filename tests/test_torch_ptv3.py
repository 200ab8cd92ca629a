"""PyTorch port vs the JAX package: PTv3's ops, block, geometry and backbone.

Inputs are made from a seed with numpy and handed to both packages;
weights come from a JAX init through ``weights.jax_to_state_dict``. The
JAX PTv3 has no Pallas kernel (its attention is ``jnp.einsum`` and a
softmax, its pooling a scatter-max), so it runs as it is.

Tolerances and reasons:
* index structures (pooling clusters, serialization orders and inverses,
  the whole PTv3 geometry) and ``segment_reduce``'s max: exactly equal;
  its sums and means 1e-6 (measured 3.0e-8);
* float32 forward outputs: 1e-4 of each tensor's largest entry (products
  summed in another order). Measured: the ops and the block at most
  2.7e-7; the narrow predictor's gaussians at most 8.4e-5 (opacity, with
  the fusion), its BatchNorm stats 1.5e-5, the unit quaternion 1.6e-4
  against 5e-4 (test_torch_sparse.py says why). PTv3's float32 outputs sit
  this far from JAX's because its own float32 rounding is of that order
  (chip_smoke.py's PTv3 parity prints how far a float64 backbone moves
  the loss of the same narrow PTv3);
* float32 gradients: 1e-3 relative per tensor, max error over the largest
  entry (measured at most 7.6e-7 for the ops and the block, 2.7e-4 for
  the predictor's parameters and 5.0e-5 for its input features). Biases
  ahead of a BatchNorm have an analytically zero gradient: both sides must
  be noise (< 1e-3 of the largest gradient). No segment-max near-tie moved
  a gradient at this width and seed, so the perturbation rule of
  tests/test_torch_object_backbones.py is not needed here
  (tests/test_torch_ptv3_step.py needs it at full width);
* bfloat16 (the rules of tests/test_torch_compute_dtype.py): the block's
  output dtype equals JAX's and its values agree within 2e-2 of the
  largest magnitude (measured 4.6e-3); the whole predictor per gaussian
  field: the port-vs-JAX bfloat16 gap at most 3x JAX's own
  bfloat16-vs-float32 gap, and the port's own bfloat16-vs-float32 gap at
  least 0.25x it (measured 0.91-1.50x and 0.73-1.44x).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unipre3d_tpu.models import ptv3 as jptv3
from unipre3d_tpu.models.sparseunet import point_fusion_merge as jmerge
from unipre3d_tpu.ops import sparse as jsp
from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu.training.config import load_config as jload_config
from unipre3d_tpu_torch.data import SyntheticSceneDataset, collate
from unipre3d_tpu_torch.models import ptv3 as tptv3
from unipre3d_tpu_torch.models import scene_geometry as tgeo
from unipre3d_tpu_torch.models.gaussian_predictor import build_predictor
from unipre3d_tpu_torch.ops import sparse as tsp
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_scene_step import shared_across_workers
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL_OUT = 1e-4
TOL_GRAD = 1e-3
TOL_BF16 = 2e-2
GAP_MULTIPLE = 3.0
GAP_FLOOR = 0.25
TINY = ["data.training_width=32", "data.training_height=32",
        "data.input_images=2", "data.max_points=1024", "opt.batch_size=2",
        "data.pts_dataset_root=synthetic"]
# five stages at a narrow width (head dim 16 as at full width); the
# embedding keeps 32 channels, the width of the fused image features
NARROW = ("enc_channels: [32, 16, 16, 32, 32], "
          "enc_num_head: [2, 1, 1, 2, 2], enc_depths: [2, 1, 1, 1, 1], "
          "dec_channels: [16, 16, 16, 32], dec_num_head: [1, 1, 1, 2], "
          "dec_depths: [2, 1, 1, 1], pixel_capacity: 512, drop_path: 0.0")
SMALL_VAE = ("model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
             "layers_per_block: 1}")
GAUSSIAN_KEYS = ("xyz", "opacity", "scaling", "rotation", "features_dc",
                 "features_rest")


def eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def close(ref, got, tol, msg=""):
    assert rel(ref, got) <= tol, (msg, rel(ref, got))


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def t64(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def voxel_set(rng, cap, n_valid, extent, n_dup=0):
    """A canonical voxel set of ``cap`` rows, ``n_valid`` valid, with
    ``n_dup`` duplicate coordinates (as PointFusion's merge makes)."""
    coords = rng.integers(0, extent, (cap, 3)).astype(np.int32)
    if n_dup:
        coords[n_valid - n_dup:n_valid] = coords[:n_dup]
    mask = np.arange(cap) < n_valid
    coords[~mask] = 0
    sv, _ = jsp.canonicalize(jnp.asarray(coords),
                             jnp.zeros((cap, 0), jnp.float32),
                             jnp.asarray(mask))
    return np.asarray(sv.coords), np.asarray(sv.mask)


# ---------------------------------------------------------------- pooling

@pytest.mark.parametrize("capacity", [240, 64])
def test_pool_clusters_matches_jax(capacity):
    """Exact clusters, with parents past the capacity dropped (64)."""
    rng = np.random.default_rng(capacity)
    coords, mask = voxel_set(rng, 400, 330, 16, n_dup=20)
    j = jsp.pool_clusters(jnp.asarray(coords), jnp.asarray(mask), capacity)
    t = tsp.pool_clusters(torch.from_numpy(coords), torch.from_numpy(mask),
                          capacity)
    for a, b, name in zip(j, t, j._fields):
        eq(a, b, name)
    n_par = len(np.unique(coords[mask] >> 1, axis=0))
    assert (n_par > capacity) == (capacity == 64)
    dropped = tgeo._distinct_parents(torch.from_numpy(coords),
                                     torch.from_numpy(mask))
    assert int(dropped) == n_par


@pytest.mark.parametrize("reduce", ["max", "sum", "mean"])
def test_segment_reduce_matches_jax(reduce):
    """Values with deliberate ties within segments (bf16 makes ties
    common), skipped rows and an empty segment: the forward, and the
    gradient of a random cotangent (tied maxima share it evenly)."""
    rng = np.random.default_rng(3)
    M, C, cap = 60, 5, 12
    vals = rng.normal(size=(M, C)).astype(np.float32)
    seg = rng.integers(0, cap, M).astype(np.int32)
    seg[seg == 7] = 8                        # segment 7 empty
    seg[::9] = -1
    # ties: rows of one segment share their values in some channels
    for s in range(cap):
        rows = np.flatnonzero(seg == s)
        if len(rows) > 1:
            vals[rows[1:], :3] = vals[rows[0], :3]
    cot = rng.normal(size=(cap, C)).astype(np.float32)

    def jf(v):
        return (jsp.segment_reduce(v, jnp.asarray(seg), cap, reduce)
                * cot).sum()
    jout = jsp.segment_reduce(jnp.asarray(vals), jnp.asarray(seg), cap, reduce)
    jgrad = jax.grad(jf)(jnp.asarray(vals))
    tv = torch.from_numpy(vals).requires_grad_(True)
    tout = tsp.segment_reduce(tv, torch.from_numpy(seg), cap, reduce)
    (tout * torch.from_numpy(cot)).sum().backward()
    if reduce == "max":
        eq(jout, tout.detach(), "out")
    else:
        close(jout, tout.detach(), 1e-6, "out")
    close(jgrad, tv.grad, 1e-6, "grad")
    assert float(np.abs(np.asarray(jout)[7]).max()) == 0.0
    if reduce == "max":
        # a tie splits the gradient: some entry gets a fraction of its cot
        g = tv.grad.numpy()
        assert np.any((np.abs(g) > 0) & (np.abs(g) < np.abs(cot).max())
                      & ~np.isin(np.abs(g), np.abs(cot)))
    # a batch axis gives each scene's reduction (the second scene's rows
    # reversed: its sums add in another order)
    tb = tsp.segment_reduce(torch.from_numpy(np.stack([vals, vals[::-1]])),
                            torch.from_numpy(np.stack([seg, seg[::-1]])),
                            cap, reduce)
    torch.testing.assert_close(tb[0], tout.detach(), rtol=0, atol=0)
    close(tout.detach(), tb[1], 0.0 if reduce == "max" else 1e-6)


def test_segment_reduce_max_tie_rule():
    """JAX's ``.at[[0, 0, 1]].max([3, 3, 1])`` gradient is [0.5, 0.5, 1]."""
    v = torch.tensor([[3.0], [3.0], [1.0]], requires_grad=True)
    tsp.segment_reduce(v, torch.tensor([0, 0, 1]), 2, "max").sum().backward()
    assert v.grad.flatten().tolist() == [0.5, 0.5, 1.0]
    jg = jax.grad(lambda x: jsp.segment_reduce(
        x, jnp.asarray([0, 0, 1]), 2, "max").sum())(jnp.asarray(
            [[3.0], [3.0], [1.0]]))
    assert np.asarray(jg).flatten().tolist() == [0.5, 0.5, 1.0]
    # bf16 values with a bf16 floor
    vb = torch.tensor([[-2.0], [5.0]], dtype=torch.bfloat16)
    out = tsp.segment_reduce(vb, torch.tensor([0, -1]), 2, "max")
    assert out.dtype == torch.bfloat16
    assert out.float().flatten().tolist() == [-2.0, 0.0]


# ---------------------------------------------------------- serialization

def test_serialize_matches_jax():
    """Both orders, with duplicate coordinates (their order decides which
    patch a row lands in), invalid rows and coordinates past 1023 (clipped
    before encoding): exact."""
    rng = np.random.default_rng(5)
    B, M = 2, 300
    coords = rng.integers(0, 40, (B, M, 3)).astype(np.int32)
    coords[:, 50:90] = coords[:, 0:40]
    coords[0, 5] = [1100, 3, 2000]
    mask = rng.uniform(size=(B, M)) < 0.8
    orders = ("z", "z-trans")
    j = jax.vmap(lambda c, m: jptv3.serialize(c, m, orders))(
        jnp.asarray(coords), jnp.asarray(mask))
    t = tptv3.serialize(torch.from_numpy(coords), torch.from_numpy(mask),
                        orders)
    eq(j.order, t.order, "order")
    eq(j.inverse, t.inverse, "inverse")
    assert t.order.shape == (B, 2, M) and t.order.dtype == torch.int64
    # invalid rows last, duplicates in row order
    n_valid = mask.sum(1)
    for b in range(B):
        assert bool(torch.from_numpy(mask[b])[t.order[b, 0, :n_valid[b]]]
                    .all())


# -------------------------------------------------------- patch attention

def attention_case(seed, B=2, M=150, C=32, n_valid=(60, 150)):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, M, 3 * C)).astype(np.float32)
    coords = rng.integers(0, 12, (B, M, 3)).astype(np.int32)
    mask = np.arange(M)[None, :] < np.asarray(n_valid)[:, None]
    ser = jax.vmap(lambda c, m: jptv3.serialize(c, m, ("z", "z-trans")))(
        jnp.asarray(coords), jnp.asarray(mask))
    cot = rng.normal(size=(B, M, C)).astype(np.float32)
    return qkv, np.asarray(ser.order), np.asarray(ser.inverse), mask, cot


@pytest.mark.parametrize("heads", [1, 2])
def test_patch_attention_matches_jax(heads):
    """Scene 0 has 60 valid rows of 150: its sorted sequence holds a patch
    of invalid rows only and one of padding only, whose rows must come out
    zero with finite gradients."""
    qkv, order, inverse, mask, cot = attention_case(heads)

    def jfn(q):
        out = jax.vmap(jptv3.patch_attention,
                       in_axes=(0, 0, 0, 0, None, None))(
            q, jnp.asarray(order[:, 1]), jnp.asarray(inverse[:, 1]),
            jnp.asarray(mask), heads, 48)
        return out, (out * cot).sum()
    (jout, _), jvjp = jax.vjp(jfn, jnp.asarray(qkv))
    jgrad, = jvjp((jnp.zeros_like(jout), jnp.ones(())))
    tq = torch.from_numpy(qkv).requires_grad_(True)
    tout = tptv3.patch_attention(tq, t64(order[:, 1]), t64(inverse[:, 1]),
                                 torch.from_numpy(mask), heads, 48)
    (tout * torch.from_numpy(cot)).sum().backward()
    close(jout, tout.detach(), TOL_OUT, "out")
    close(jgrad, tq.grad, TOL_GRAD, "grad")
    assert bool(torch.isfinite(tq.grad).all())
    assert float(tout.detach()[0, 60:].abs().max()) == 0.0
    assert float(tq.grad[0, 60:].abs().max()) == 0.0


# ------------------------------------------------------------------ block

def block_case(seed, B=2, M=200, C=32):
    rng = np.random.default_rng(seed)
    sv = [voxel_set(rng, M, n, 9, n_dup=10) for n in (150, 200)]
    coords = np.stack([c for c, _ in sv])
    mask = np.stack([m for _, m in sv])
    feat = rng.normal(size=(B, M, C)).astype(np.float32) * mask[..., None]
    nbr = jax.jit(jax.vmap(lambda c, m: jsp.find_neighbors(
        jsp.SparseVoxels(c, jnp.zeros((M, 0)), m), jsp.kernel_offsets(3))))(
        jnp.asarray(coords), jnp.asarray(mask))
    ser = jax.jit(jax.vmap(lambda c, m: jptv3.serialize(
        c, m, ("z", "z-trans"))))(jnp.asarray(coords), jnp.asarray(mask))
    cot = rng.normal(size=(B, M, C)).astype(np.float32)
    return feat, np.asarray(nbr), ser, mask, cot


def torch_ser(ser):
    return tptv3.Serialized(t64(ser.order), t64(ser.inverse))


@pytest.fixture(scope="module")
def block():
    feat, nbr, ser, mask, cot = block_case(0)
    jblock = jptv3.PTv3Block(32, 2, 48, 4.0, 0.0, order_index=1)
    args = (jnp.asarray(feat), jnp.asarray(nbr), ser, jnp.asarray(mask))
    params = jax.jit(lambda: jblock.init(jax.random.PRNGKey(1),
                                         *args))()["params"]
    return dict(feat=feat, nbr=nbr, ser=ser, mask=mask, cot=cot, args=args,
                params=params, sd=jax_to_state_dict(np_tree(params)))


def test_ptv3_block_matches_jax(block):
    """The block's output and the gradients w.r.t. its input and every
    parameter (xCPE on duplicate voxels, the second order)."""
    jblock = jptv3.PTv3Block(32, 2, 48, 4.0, 0.0, order_index=1)

    def jf(params, feat):
        out = jblock.apply({"params": params}, feat, *block["args"][1:])
        return (out * block["cot"]).sum(), out
    (_, jout), (jgp, jgf) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(block["params"],
                                           block["args"][0])
    tblock = tptv3.PTv3Block(32, 2, 48, 4.0, 0.0, order_index=1)
    tblock.load_state_dict(block["sd"])
    tf = torch.from_numpy(block["feat"]).requires_grad_(True)
    tout = tblock(tf, t64(block["nbr"]), torch_ser(block["ser"]),
                  torch.from_numpy(block["mask"]))
    (tout * torch.from_numpy(block["cot"])).sum().backward()
    close(jout, tout.detach(), TOL_OUT, "out")
    close(jgf, tf.grad, TOL_GRAD, "d feat")
    jg = jax_to_state_dict(np_tree(jgp))
    tg = dict(tblock.named_parameters())
    assert set(jg) == set(tg) and len(jg) == 18
    for n, g in jg.items():
        close(g, tg[n].grad, TOL_GRAD, n)


def test_ptv3_block_bf16_matches_jax(block):
    """bfloat16: the output's dtype is JAX's (the xCPE's float32 bias
    promotes inside the block, LayerNorm returns bfloat16) and its values
    agree within 2e-2 of the largest magnitude."""
    jblock = jptv3.PTv3Block(32, 2, 48, 4.0, 0.0, order_index=1,
                             dtype=jnp.bfloat16)
    jf = jnp.asarray(block["feat"], jnp.bfloat16)
    jout = jax.jit(lambda p, f: jblock.apply({"params": p}, f,
                                             *block["args"][1:]))(
        block["params"], jf)
    tblock = tptv3.PTv3Block(32, 2, 48, 4.0, 0.0, order_index=1,
                             dtype=torch.bfloat16)
    tblock.load_state_dict(block["sd"])
    tout = tblock(torch.from_numpy(block["feat"]).to(torch.bfloat16),
                  t64(block["nbr"]), torch_ser(block["ser"]),
                  torch.from_numpy(block["mask"]))
    assert jout.dtype == jnp.bfloat16 and tout.dtype == torch.bfloat16
    close(np.asarray(jout, np.float32), tout.float().detach(), TOL_BF16)


def test_ptv3_block_drop_path_draws_from_generator(block):
    """In training, DropPath draws its per-scene masks from the generator
    it is given: the same seed gives the same output, which differs from
    the eval output (a kept branch is scaled by 1 / keep)."""
    tblock = tptv3.PTv3Block(32, 2, 48, 4.0, 0.5, order_index=1)
    tblock.load_state_dict(block["sd"])
    tblock.train()
    args = (torch.from_numpy(block["feat"]), t64(block["nbr"]),
            torch_ser(block["ser"]), torch.from_numpy(block["mask"]))
    a = tblock(*args, generator=torch.Generator().manual_seed(3))
    b = tblock(*args, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    tblock.eval()
    c = tblock(*args)
    assert not torch.equal(a, c)


# ------------------------------------------------------ geometry, backbone

@pytest.fixture(scope="module")
def scene_batch():
    """Two synthetic scenes at the tiny size as one numpy batch; the GT
    views are seeded noise."""
    cfg = load_config("ptv3_pretraining", overrides=TINY)
    ds = SyntheticSceneDataset(cfg, num_scenes=2, seed=0, device="cpu")
    batch = collate([ds[0], ds[1]])
    batch["gt_images"] = np.random.default_rng(0).uniform(
        0, 1, batch["gt_images"].shape).astype(np.float32)
    return batch


def jax_inline_geometry(pc, unproj, use_fusion, pixel_capacity=512,
                        n_stages=5, orders=("z", "z-trans")):
    return jax.jit(lambda p, u: _jax_inline_geometry(
        p, u, use_fusion, pixel_capacity, n_stages, orders))(pc, unproj)


def _jax_inline_geometry(pc, unproj, use_fusion, pixel_capacity, n_stages,
                         orders):
    """The index structures the JAX PTv3 forward builds inline
    (unipre3d_tpu/models/ptv3.py:213-320), step by step with the JAX
    package's functions: the canonical order, the stem table, the fusion
    merge, then per stage the pooling, its table and its serialization."""
    pc = jax.tree_util.tree_map(jnp.asarray, pc)
    B, M = pc["mask"].shape
    sv, order0 = jax.vmap(jsp.canonicalize)(pc["grid_coord"], pc["feat"],
                                            pc["mask"])
    world = jnp.take_along_axis(pc["coord"], order0[..., None], axis=1)
    nbr5 = jax.vmap(jsp.find_neighbors, in_axes=(0, None))(
        sv, jsp.kernel_offsets(5))
    out = dict(order0=order0, mask0=sv.mask, nbr5=nbr5)
    if use_fusion:
        V, H, W = unproj.shape[1:4]
        img = jnp.zeros((B, V, pc["feat"].shape[-1], H, W))
        sv, world = jax.vmap(jmerge, in_axes=(0, 0, 0, 0, 0, None, None))(
            sv, world, img, unproj, pc["min_coord"], 0.02, pixel_capacity)
    out.update(world=world, fine_mask=sv.mask)
    nbrs = [jax.vmap(jsp.find_neighbors, in_axes=(0, None))(
        sv, jsp.kernel_offsets(3))]
    sers = [jax.vmap(lambda c, m: jptv3.serialize(c, m, orders))(
        sv.coords, sv.mask)]
    caps, clusters = [sv.mask.shape[1]], []
    coords, mask = sv.coords, sv.mask
    for _ in range(1, n_stages):
        cap = -(-max(caps[-1] // 3, 48) // 48) * 48
        caps.append(cap)
        cl = jax.vmap(lambda c, m: jsp.pool_clusters(c, m, cap))(coords, mask)
        clusters.append(cl)
        nbrs.append(jax.vmap(jsp.find_neighbors, in_axes=(0, None))(
            jsp.SparseVoxels(cl.coords, jnp.zeros((B, cap, 0)), cl.mask),
            jsp.kernel_offsets(3)))
        sers.append(jax.vmap(lambda c, m: jptv3.serialize(c, m, orders))(
            cl.coords, cl.mask))
        coords, mask = cl.coords, cl.mask
    out.update(nbr3_fine=nbrs[0], clusters=clusters, nbrs=nbrs[1:],
               sers=sers)
    return out


@pytest.mark.parametrize("use_fusion", [True, False])
def test_build_ptv3_geometry_equals_inline(scene_batch, use_fusion):
    """The geometry built before the step equals the structures the JAX
    forward builds inline, field by field; each pooling's dropped parents
    are counted."""
    pc = scene_batch["point_cloud"]
    unproj = scene_batch["unprojected_coords"]
    j = jax_inline_geometry(pc, unproj, use_fusion)
    t = tgeo.build_ptv3_geometry(
        {k: torch.from_numpy(v) for k, v in pc.items()},
        torch.from_numpy(unproj), grid_size=0.02, pixel_capacity=512,
        orders=("z", "z-trans"), n_stages=5, patch_size=48,
        pool_capacity_div=3, use_fusion=use_fusion)
    for k in ("order0", "mask0", "nbr5", "world", "fine_mask", "nbr3_fine"):
        eq(j[k], getattr(t, k), k)
    assert (t.pix_rep is None) == (not use_fusion)
    assert len(t.clusters) == len(t.nbrs) == 4 and len(t.sers) == 5
    for s in range(4):
        for a, b, name in zip(j["clusters"][s], t.clusters[s],
                              ("coords", "mask", "parent_idx")):
            eq(a, b, f"cluster {s} {name}")
        eq(j["nbrs"][s], t.nbrs[s], f"nbr {s}")
    for s in range(5):
        eq(j["sers"][s].order, t.sers[s].order, f"order {s}")
        eq(j["sers"][s].inverse, t.sers[s].inverse, f"inverse {s}")
    caps = [j["fine_mask"].shape[1]] + [c.mask.shape[1] for c in j["clusters"]]
    assert caps == [t.fine_mask.shape[1]] + [c.mask.shape[1]
                                             for c in t.clusters]
    assert caps == list(tgeo.ptv3_stage_caps(caps[0], 5, 48, 3))
    assert caps[0] == 1024 + (512 if use_fusion else 0)
    assert tuple(t.pool_dropped.shape) == (2, 4)
    assert int(t.pool_dropped.min()) >= 0


def jax_predictor(over, dtype=jnp.float32):
    jcfg = jload_config("ptv3_pretraining", overrides=over)
    return jtrainer.build_predictor(jcfg, dtype=dtype)


def predictor_over(use_fusion, extra=""):
    return TINY + [SMALL_VAE, f"opt.use_fusion={use_fusion}",
                   "model.backbone_overrides={" + NARROW
                   + ", shuffle_orders: false" + extra + "}"]


def masked_sum(out, mask, cots, xp):
    return sum((xp.where(mask.reshape(mask.shape + (1,) * (
        out[k].ndim - 2)), out[k], 0.0) * cots[k]).sum()
        for k in GAUSSIAN_KEYS)


def jax_predictor_refs(scene_batch, use_fusion):
    """The JAX side of the narrow PTv3 predictor from one init, as
    {group: {name: tensor}}: the converted weights (``sd``), a random
    cotangent per gaussian field (``cots``), the float32 train-mode
    forward (``out``), its BatchNorm stats (``stats``), the cotangent's
    gradients w.r.t. the parameters (``grad``) and the input features
    (``dfeat``); with the fusion also the bfloat16 forward (``out_bf16``)
    and the float32 forward of the model built with the orders reversed
    (``out_reversed``; the orders shape no parameter)."""
    over = predictor_over(use_fusion)
    jmodel = jax_predictor(over)
    args = jtrainer.model_inputs(scene_batch, 2, "scene")
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda: jmodel.init(
        {"params": rng, "droppath": rng}, *args))()
    shapes = jax.eval_shape(lambda v: jmodel.apply(v, *args), variables)
    cot_rng = np.random.default_rng(4)
    cots = {k: cot_rng.normal(size=shapes[k].shape).astype(np.float32)
            for k in GAUSSIAN_KEYS}

    def f(params, feat):
        pc = dict(args[0], feat=feat)
        out, stats = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            pc, *args[1:], train=True, mutable=["batch_stats"])
        return masked_sum(out, out["mask"], cots, jnp), (out, stats)
    (_, (out, stats)), (grad, dfeat) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(variables["params"],
                                          args[0]["feat"])
    host = lambda d: {k: torch.from_numpy(np.asarray(v, np.float32))  # noqa
                      for k, v in d.items()}
    refs = dict(
        sd=jax_to_state_dict(np_tree(variables["params"]),
                             np_tree(variables["batch_stats"])),
        cots=host(cots), out=host(out),
        stats=jax_to_state_dict({}, np_tree(stats["batch_stats"])),
        grad={n: g for n, g in jax_to_state_dict(np_tree(grad)).items()
              if not n.startswith("image_network.")},
        dfeat=host({"feat": dfeat}))
    if use_fusion:
        def forward(m):
            return host(jax.jit(lambda v: m.apply(
                v, *args, train=True, mutable=["batch_stats"])[0])(variables))
        refs["out_bf16"] = forward(jax_predictor(over, jnp.bfloat16))
        refs["out_reversed"] = forward(jax_predictor(
            predictor_over(True, ", orders: [z-trans, z]")))
    return refs


@pytest.fixture(scope="module")
def fused(tmp_path_factory, scene_batch):
    """``jax_predictor_refs`` with the PointFusion, once per test run
    (three tests read it; ``shared_across_workers``)."""
    return shared_across_workers(
        tmp_path_factory, "jax_ptv3_predictor",
        lambda: jax_predictor_refs(scene_batch, True))


def port_inputs(scene_batch):
    b = {k: torch.from_numpy(v) for k, v in scene_batch["point_cloud"].items()}
    return (b, torch.from_numpy(scene_batch["gt_images"][:, :2]),
            torch.from_numpy(scene_batch["unprojected_coords"]))


def port_predictor(over, sd, dtype=torch.float32):
    m = build_predictor(load_config("ptv3_pretraining", overrides=over),
                        dtype=dtype)
    m.load_state_dict(sd)
    return m.train()


@pytest.mark.parametrize("use_fusion", [True, False])
def test_ptv3_predictor_matches_jax(scene_batch, fused, use_fusion):
    """The whole PTv3 predictor in float32 at a narrow width that keeps all
    five stages, in train mode (batch statistics), with and without the
    PointFusion: the gaussians, the BatchNorm running stats, and the
    gradients of a random cotangent w.r.t. every parameter and the input
    features."""
    c = fused if use_fusion else jax_predictor_refs(scene_batch, False)
    jout = c["out"]
    tmodel = port_predictor(predictor_over(use_fusion), c["sd"])
    b, img, unproj = port_inputs(scene_batch)
    b["feat"].requires_grad_(True)
    tout = tmodel(b, img, unprojected_coords=unproj)
    masked_sum(tout, tout["mask"], c["cots"], torch).backward()
    eq(jout["mask"].bool(), tout["mask"])
    assert tout["xyz"].shape[1] == 1024 + (512 if use_fusion else 0)
    for k in GAUSSIAN_KEYS:
        close(jout[k], tout[k].detach(), 5e-4 if k == "rotation" else TOL_OUT,
              k)
    tsd = tmodel.state_dict()
    # embedding, fusion, four poolings, four unpoolings with their skips
    assert len(c["stats"]) == 2 * (14 if use_fusion else 13)
    for k, v in c["stats"].items():
        close(v, tsd[k], TOL_OUT, k)
    close(c["dfeat"]["feat"], b["feat"].grad, TOL_GRAD, "d feat")
    jg = c["grad"]
    tg = {n: p.grad for n, p in tmodel.named_parameters()
          if p.grad is not None}
    assert set(tg) == set(jg) and len(tg) > 150
    gmax = max(float(v.abs().max()) for v in jg.values())
    for n, j in jg.items():
        if float(j.abs().max()) < 1e-3 * gmax:   # ahead of a BatchNorm
            assert float(tg[n].abs().max()) < 1e-3 * gmax, n
        else:
            close(j, tg[n], TOL_GRAD, n)


def test_ptv3_shuffle_swap_equals_reversed_orders(scene_batch, fused):
    """With ``shuffle_orders`` and the swap drawn true, the port in train
    mode equals the JAX model built with the orders reversed and no
    shuffle (DropPath off, the same parameters): the swap flips the order
    axis of every stage for the whole batch. A draw that does not swap
    gives another output."""
    tmodel = port_predictor(TINY + [SMALL_VAE, "model.backbone_overrides={"
                                    + NARROW + ", shuffle_orders: true}"],
                            fused["sd"])
    # a seed whose single draw swaps, and one whose draw does not
    draws = {s: bool(torch.rand((), generator=torch.Generator()
                                .manual_seed(s)) < 0.5) for s in range(8)}
    swap_seed = next(s for s, d in draws.items() if d)
    keep_seed = next(s for s, d in draws.items() if not d)
    b, img, unproj = port_inputs(scene_batch)
    with torch.no_grad():
        swapped = tmodel(b, img, unprojected_coords=unproj,
                         generator=torch.Generator().manual_seed(swap_seed))
        kept = tmodel(b, img, unprojected_coords=unproj,
                      generator=torch.Generator().manual_seed(keep_seed))
    jrev = fused["out_reversed"]
    for k in GAUSSIAN_KEYS:
        close(jrev[k], swapped[k], 5e-4 if k == "rotation" else TOL_OUT, k)
    assert rel(jrev["features_dc"], kept["features_dc"]) > 1e-3
    close(fused["out"]["features_dc"], kept["features_dc"], TOL_OUT)


def test_ptv3_predictor_bf16_gaps(scene_batch, fused):
    """The predictor in bfloat16 (the whole-model rule of
    tests/test_torch_compute_dtype.py): per gaussian
    field, the port-vs-JAX bfloat16 gap at most 3x JAX's own
    bfloat16-vs-float32 gap, and the port's own bfloat16-vs-float32 gap at
    least 0.25x it (a port that ignores its dtype has none). All in train
    mode, from the same float32 weights."""
    j32, jb = fused["out"], fused["out_bf16"]
    b, img, unproj = port_inputs(scene_batch)
    touts = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = port_predictor(predictor_over(True), fused["sd"], dtype)
        with torch.no_grad():
            touts[dtype] = m(b, img, unprojected_coords=unproj)
    mask = j32["mask"].bool()
    for k in GAUSSIAN_KEYS:
        sel = lambda x: x.float()[mask]  # noqa: E731
        jax_gap = rel(sel(j32[k]), sel(jb[k]))
        port_jax = rel(sel(jb[k]), sel(touts[torch.bfloat16][k]))
        port_own = rel(sel(touts[torch.float32][k]),
                       sel(touts[torch.bfloat16][k]))
        assert jax_gap > 0, k
        assert port_jax <= GAP_MULTIPLE * jax_gap, (k, port_jax, jax_gap)
        assert port_own >= GAP_FLOOR * jax_gap, (k, port_own, jax_gap)
