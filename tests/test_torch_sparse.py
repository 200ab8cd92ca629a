"""PyTorch port vs the JAX package: sparse voxel ops, the SparseUNet
geometry and the scene predictor's forward.

Inputs are made from a seed with numpy and handed to both packages.

Tolerances and reasons:
* every index structure (codes, sort orders, neighbour tables including
  duplicate codes, downsample structures, voxelize and merge orders, the
  whole SpUNetGeometry) and every copied value: exactly equal;
* feature outputs and gradients of the sparse convs: 1e-5 relative to the
  tensor's largest entry (float32 products summed in another order);
* the scene predictor at a small width (several BatchNorms over a few
  hundred rows, each dividing by a batch standard deviation): outputs,
  running statistics and parameter gradients 1e-4 relative to each
  tensor's largest entry (outputs measured <= 1.2e-5), the unit quaternion
  5e-4 (normalising a raw 4-vector of small norm divides its error by that
  norm; measured 1.1e-4); the validity mask exactly. Biases ahead of a
  BatchNorm have an analytically zero gradient: both sides must be noise
  (< 1e-3 of the largest gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unipre3d_tpu.models import scene_geometry as jgeo
from unipre3d_tpu.ops import sparse as jsp
from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu.training.config import load_config as jload_config
from unipre3d_tpu_torch.data import SyntheticSceneDataset, collate
from unipre3d_tpu_torch.models import scene_geometry as tgeo
from unipre3d_tpu_torch.models.gaussian_predictor import build_predictor
from unipre3d_tpu_torch.ops import sparse as tsp
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.weights import jax_to_state_dict

TINY = ["data.training_width=32", "data.training_height=32",
        "data.input_images=2", "data.max_points=1024", "opt.batch_size=2",
        "data.pts_dataset_root=synthetic"]
SMALL_MODEL = [
    "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
    "layers_per_block: 1}",
    "model.backbone_overrides={channels: [16, 16, 24, 24, 24, 16, 16, 16], "
    "layers: [1, 1, 1, 1, 1, 1, 1, 1], pixel_capacity: 512}"]


def eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def close(ref, got, rel, msg=""):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    scale = max(np.abs(ref).max(), 1e-12)
    assert np.abs(got - ref).max() <= rel * scale, (msg, np.abs(got - ref).max(),
                                                    scale)


def voxel_set(rng, n_valid, cap, extent=10, dup_from=None, n_dup=0):
    """Random voxels (unique codes), padded to ``cap`` with invalid rows
    whose coords are random too; ``dup_from`` (coords, mask) lends ``n_dup``
    of its valid coords, so that a merge with it has duplicate codes."""
    cells = rng.permutation(extent ** 3)[:n_valid]
    coords = np.stack(np.unravel_index(cells, (extent,) * 3), 1)
    if dup_from is not None:
        src = dup_from[0][dup_from[1]]
        coords[:n_dup] = src[rng.permutation(len(src))[:n_dup]]
        coords = np.unique(coords, axis=0)
        coords = coords[rng.permutation(len(coords))]
    n = len(coords)
    pad = rng.integers(0, extent, (cap - n, 3))
    coords = np.concatenate([coords, pad]).astype(np.int32)
    mask = np.concatenate([np.ones(n, bool), np.zeros(cap - n, bool)])
    order = rng.permutation(cap)
    return coords[order], mask[order]


def canonical_pair(rng, n_valid, cap, extent=10, dups=0):
    """A canonical voxel set in both packages; ``dups`` > 0 merges a
    second set that shares ``dups`` codes (the PointFusion case)."""
    a = voxel_set(rng, n_valid, cap, extent)
    nofeat = np.zeros((cap, 0), np.float32)
    if not dups:
        jsv, _ = jsp.canonicalize(jnp.asarray(a[0]), jnp.asarray(nofeat),
                                  jnp.asarray(a[1]))
        tsv, _ = tsp.canonicalize(torch.from_numpy(a[0]),
                                  torch.from_numpy(nofeat),
                                  torch.from_numpy(a[1]))
        return jsv, tsv
    b = voxel_set(rng, n_valid // 2, cap // 2, extent, a, dups)
    nb = np.zeros((cap // 2, 0), np.float32)
    jsv, _ = jsp.merge_voxel_sets(*(jnp.asarray(x) for x in
                                    (a[0], nofeat, a[1], b[0], nb, b[1])))
    tsv, _ = tsp.merge_voxel_sets(*(torch.from_numpy(x) for x in
                                    (a[0], nofeat, a[1], b[0], nb, b[1])))
    return jsv, tsv


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_code_and_canonicalize(seed):
    rng = np.random.default_rng(seed)
    coords = rng.integers(-3, 1100, (200, 3)).astype(np.int32)
    coords[50:80] = coords[:30]                      # duplicate codes
    mask = rng.uniform(size=200) > 0.2
    feats = rng.normal(size=(200, 4)).astype(np.float32)
    eq(jsp.pack_code(jnp.asarray(coords), jnp.asarray(mask)),
       tsp.pack_code(torch.from_numpy(coords), torch.from_numpy(mask)))
    jsv, jorder = jsp.canonicalize(*(jnp.asarray(x) for x in
                                     (coords, feats, mask)))
    tsv, torder = tsp.canonicalize(*(torch.from_numpy(x) for x in
                                     (coords, feats, mask)))
    eq(jorder, torder)
    for j, t in zip(jsv, tsv):
        eq(j, t)
    eq(jsp.kernel_offsets(5), tsp.kernel_offsets(5))
    idx = rng.integers(0, 200, (7, 9))
    eq(jsp.take_elements(jnp.asarray(feats[:, 0]), jnp.asarray(idx)),
       tsp.take_elements(torch.from_numpy(feats[:, 0]), torch.from_numpy(idx)))


def test_merge_lookup_matches_rank_lookup():
    """The port's searchsorted against the JAX hierarchical rank lookup,
    with duplicate codes in the table and a table longer than the needles."""
    rng = np.random.default_rng(3)
    codes = np.sort(rng.integers(0, 5000, 1500)).astype(np.uint32)
    tgt = rng.integers(0, 5200, (400, 3)).astype(np.uint32)
    tgt[:100, 0] = codes[rng.integers(0, 1500, 100)]
    jres = jsp._merge_lookup(jnp.asarray(codes), jnp.asarray(tgt))
    tres = tsp._merge_lookup(torch.from_numpy(codes.astype(np.int64)),
                             torch.from_numpy(tgt.astype(np.int64)))
    eq(jres, tres)
    # duplicates resolve to the last of their run
    hit = np.asarray(tres) >= 0
    r = np.asarray(tres)[hit]
    assert hit.sum() >= 100
    assert ((r == len(codes) - 1) | (codes[np.minimum(r + 1, len(codes) - 1)]
                                     != codes[r])).all()


@pytest.mark.parametrize("k,dups", [(3, 0), (5, 0), (3, 60), (5, 60)])
def test_find_neighbors(k, dups):
    rng = np.random.default_rng(10 + k + dups)
    jsv, tsv = canonical_pair(rng, 220, 300, extent=9, dups=dups)
    jn = jsp.find_neighbors(jsv, jsp.kernel_offsets(k))
    tn = tsp.find_neighbors(tsv, tsp.kernel_offsets(k))
    eq(jn, tn)
    if dups:   # the case is live: some lookups land on a duplicate run
        codes = np.asarray(tsp.pack_code(tsv.coords, tsv.mask))
        assert (codes[1:] == codes[:-1])[codes[1:] != 0xFFFFFFFF].sum() > 10


def subm_both(feats, nbr_j, nbr_t, w, dy):
    """Forward and (dfeats, dw) of the sparse conv in both packages."""
    def jfn(f, ww):
        return jax.vmap(jsp.subm_gather_matmul, in_axes=(0, 0, None))(
            f, nbr_j, ww)
    jy, vjp = jax.vjp(jfn, jnp.asarray(feats), jnp.asarray(w))
    jdf, jdw = vjp(jnp.asarray(dy))
    tf = torch.from_numpy(feats).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = tsp.subm_gather_matmul(tf, nbr_t, tw)
    (ty * torch.from_numpy(dy)).sum().backward()
    return (jy, jdf, jdw), (ty.detach(), tf.grad, tw.grad)


@pytest.mark.parametrize("dups", [0, 60])
def test_subm_conv_forward_and_gradients(dups):
    """Forward and both gradients against JAX; with duplicate codes the
    port keeps the JAX mirror-flip backward, which there differs from the
    true transpose of the gather (plain autograd)."""
    rng = np.random.default_rng(20 + dups)
    pairs = [canonical_pair(rng, 220, 300, extent=9, dups=dups)
             for _ in range(2)]
    offs = jsp.kernel_offsets(3)
    nbr_j = jnp.stack([jsp.find_neighbors(p[0], offs) for p in pairs])
    nbr_t = torch.stack([tsp.find_neighbors(p[1], offs) for p in pairs])
    M = nbr_t.shape[1]
    feats = rng.normal(size=(2, M, 5)).astype(np.float32)
    w = (rng.normal(size=(27, 5, 7)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(2, M, 7)).astype(np.float32)
    jres, tres = subm_both(feats, nbr_j, nbr_t, w, dy)
    for name, j, t in zip(("y", "dfeats", "dw"), jres, tres):
        close(j, t, 1e-5, name)
    if dups:
        tf = torch.from_numpy(feats).requires_grad_(True)
        g = tsp._gather_all(tf, nbr_t).reshape(2, M, -1)
        ((g @ torch.from_numpy(w).reshape(-1, 7))
         * torch.from_numpy(dy)).sum().backward()
        assert float((tf.grad - tres[1]).abs().max()) > 1e-3


def test_downsample_and_inverse_conv():
    rng = np.random.default_rng(5)
    scenes = [canonical_pair(rng, 250, 320, extent=12, dups=40)
              for _ in range(2)]
    cap = 90                          # fewer than the parents: some drop
    jds = [jsp.downsample_structure(j.coords, j.mask, cap) for j, _ in scenes]
    tds = [tsp.downsample_structure(t.coords, t.mask, cap) for _, t in scenes]
    for j, t in zip(jds, tds):
        for name, a, b in zip(j._fields, j, t):
            eq(a, b, name)
    assert int(np.asarray(jds[0].mask).sum()) == cap
    jb = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jds)
    tb = tsp.DownStructure(*(torch.stack(x) for x in zip(*tds)))
    M = tb.order.shape[1]
    feats = rng.normal(size=(2, M, 6)).astype(np.float32)
    w = (rng.normal(size=(8, 6, 5)) * 0.3).astype(np.float32)
    dy = rng.normal(size=(2, cap, 5)).astype(np.float32)

    jy, vjp = jax.vjp(lambda f, ww: jax.vmap(
        jsp.downsample_apply, in_axes=(0, 0, None))(jb, f, ww),
        jnp.asarray(feats), jnp.asarray(w))
    jdf, jdw = vjp(jnp.asarray(dy))
    tf = torch.from_numpy(feats).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = tsp.downsample_apply(tb, tf, tw)
    (ty * torch.from_numpy(dy)).sum().backward()
    for name, j, t in (("y", jy, ty.detach()), ("dfeats", jdf, tf.grad),
                       ("dw", jdw, tw.grad)):
        close(j, t, 1e-5, "down " + name)

    fine_mask = np.stack([np.asarray(t.mask) for _, t in scenes])
    coarse = rng.normal(size=(2, cap, 5)).astype(np.float32)
    wu = (rng.normal(size=(8, 5, 4)) * 0.3).astype(np.float32)
    dyu = rng.normal(size=(2, M, 4)).astype(np.float32)
    jy, vjp = jax.vjp(lambda c, ww: jax.vmap(
        jsp.inverse_conv, in_axes=(0, 0, 0, 0, None))(
        jb.parent_idx, jb.child_offset, c, jnp.asarray(fine_mask), ww),
        jnp.asarray(coarse), jnp.asarray(wu))
    jdc, jdw = vjp(jnp.asarray(dyu))
    tc = torch.from_numpy(coarse).requires_grad_(True)
    tw = torch.from_numpy(wu).requires_grad_(True)
    ty = tsp.inverse_conv(tb.parent_idx, tb.child_offset, tc,
                          torch.from_numpy(fine_mask), tw)
    (ty * torch.from_numpy(dyu)).sum().backward()
    for name, j, t in (("y", jy, ty.detach()), ("dcoarse", jdc, tc.grad),
                       ("dw", jdw, tw.grad)):
        close(j, t, 1e-5, "up " + name)


def test_voxelize_and_merge():
    rng = np.random.default_rng(7)
    pts = rng.uniform(-0.4, 0.4, (2000, 3)).astype(np.float32)
    feats = rng.normal(size=(2000, 3)).astype(np.float32)
    mask = rng.uniform(size=2000) > 0.1
    min_coord = pts.min(0) - 0.013
    args = (pts, feats, mask)
    jv = jsp.voxelize(*(jnp.asarray(x) for x in args), 0.05,
                      jnp.asarray(min_coord), 300)
    tv = tsp.voxelize(*(torch.from_numpy(x) for x in args), 0.05,
                      torch.from_numpy(min_coord), 300)
    for a, b in zip(jax.tree_util.tree_leaves(jv), [*tv[0], tv[1], tv[2]]):
        eq(a, b)
    assert bool(np.asarray(tv[0].mask).all())       # capacity cut
    a = voxel_set(rng, 150, 200, extent=8)
    b = (np.asarray(tv[0].coords) % 8, np.asarray(tv[0].mask))
    fa = rng.normal(size=(200, 3)).astype(np.float32)
    fb = np.asarray(tv[0].feats)
    jm = jsp.merge_voxel_sets(*(jnp.asarray(x) for x in
                                (a[0], fa, a[1], b[0], fb, b[1])))
    tm = tsp.merge_voxel_sets(*(torch.from_numpy(np.ascontiguousarray(x))
                                for x in (a[0], fa, a[1], b[0], fb, b[1])))
    for x, y in zip(jax.tree_util.tree_leaves(jm), [*tm[0], tm[1]]):
        eq(x, y)


@pytest.fixture(scope="module")
def scene_batch():
    """Two synthetic scenes at the tiny size as one numpy batch (point
    clouds, cameras and unprojections; the GT views are replaced by seeded
    noise, so no renderer's output enters the comparison)."""
    cfg = load_config("sparseunet_pretraining", overrides=TINY)
    ds = SyntheticSceneDataset(cfg, num_scenes=2, seed=0, device="cpu")
    batch = collate([ds[0], ds[1]])
    rng = np.random.default_rng(0)
    batch["gt_images"] = rng.uniform(
        0, 1, batch["gt_images"].shape).astype(np.float32)
    return batch


@pytest.mark.parametrize("use_fusion", [True, False])
def test_build_spunet_geometry_equals_jax(scene_batch, use_fusion):
    pc = scene_batch["point_cloud"]
    kw = dict(grid_size=0.02, pixel_capacity=4096, level_divs=(3, 9, 27, 81),
              n_stages=4, use_fusion=use_fusion)
    jg = jgeo.build_spunet_geometry(
        jax.tree_util.tree_map(jnp.asarray, pc),
        jnp.asarray(scene_batch["unprojected_coords"]), **kw)
    tg = tgeo.build_spunet_geometry(
        {k: torch.from_numpy(v) for k, v in pc.items()},
        torch.from_numpy(scene_batch["unprojected_coords"]), **kw)
    jl = jax.tree_util.tree_leaves(jg)
    tl = jax.tree_util.tree_leaves(tg, is_leaf=lambda x: x is None)
    tl = [x for x in tl if x is not None]
    assert len(jl) == len(tl) == (44 if use_fusion else 42)
    for a, b in zip(jl, tl):
        eq(a, b)
    if use_fusion:
        # the merged set holds duplicate codes: two fine rows with the same
        # parent and kernel slot share their grid coords
        ds = tg.downs[0]
        key = (ds.parent_idx[0] * 8 + ds.child_offset[0])[ds.parent_idx[0] >= 0]
        assert len(key.unique()) < len(key)


def test_scene_predictor_matches_jax(scene_batch):
    """Scene predictor (small SD-VAE and SpUNet widths, PointFusion on) on
    the same weights, in train mode: the forward (batch statistics), the
    BatchNorm running statistics it leaves, and the gradient of every
    parameter for a random cotangent on the outputs (the mirror-flip
    backward on the merged set's duplicate codes included). At this width
    no ReLU input lands within rounding of 0 (see
    test_torch_scene_step.py), so the gradients compare entry by entry."""
    over = TINY + SMALL_MODEL
    jcfg = jload_config("sparseunet_pretraining", overrides=over)
    jmodel = jtrainer.build_predictor(jcfg)
    args = jtrainer.model_inputs(scene_batch, 2, "scene")
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda: jmodel.init(
        {"params": rng, "droppath": rng}, *args))()
    keys = ("xyz", "opacity", "scaling", "rotation", "features_dc",
            "features_rest")
    shapes = jax.eval_shape(lambda v: jmodel.apply(v, *args), variables)
    cot_rng = np.random.default_rng(4)
    cots = {k: cot_rng.normal(size=shapes[k].shape).astype(np.float32)
            for k in keys}

    def masked_sum(out, mask, xp):
        return sum((xp.where(mask.reshape(mask.shape + (1,) * (
            out[k].ndim - 2)), out[k], 0.0) * cots[k]).sum() for k in keys)

    def f(params):
        out, stats = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *args, train=True, mutable=["batch_stats"])
        return masked_sum(out, out["mask"], jnp), (out, stats)
    (_, (jout, jstats)), jgrad = jax.jit(jax.value_and_grad(
        f, has_aux=True))(variables["params"])

    tmodel = build_predictor(load_config("sparseunet_pretraining",
                                         overrides=over))
    tmodel.load_state_dict(jax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"])))
    tmodel.train()
    b = {k: torch.from_numpy(v) for k, v in scene_batch["point_cloud"].items()}
    tout = tmodel(b, torch.from_numpy(scene_batch["gt_images"][:, :2]),
                  unprojected_coords=torch.from_numpy(
                      scene_batch["unprojected_coords"]))
    cots = {k: torch.from_numpy(v) for k, v in cots.items()}
    masked_sum(tout, tout["mask"], torch).backward()
    eq(jout["mask"], tout["mask"])
    assert tout["xyz"].shape[1] == 1024 + 512
    for k in keys:
        close(jout[k], tout[k].detach(), 5e-4 if k == "rotation" else 1e-4, k)
    tsd = tmodel.state_dict()
    jsd = jax_to_state_dict({}, jax.tree_util.tree_map(
        np.asarray, jstats["batch_stats"]))
    assert len(jsd) > 50
    for k, v in jsd.items():
        close(v, tsd[k], 1e-4, k)
    jg = {n: g for n, g in jax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jgrad)).items() if not n.startswith("image_network.")}
    tg = {n: p.grad for n, p in tmodel.named_parameters() if p.grad is not None}
    assert set(tg) == set(jg) and len(tg) > 60
    gmax = max(float(v.abs().max()) for v in jg.values())
    for n, j in jg.items():
        if float(j.abs().max()) < 1e-3 * gmax:   # ahead of a BatchNorm: 0
            assert float(tg[n].abs().max()) < 1e-3 * gmax, n
        else:
            close(j, tg[n], 1e-4, n)
