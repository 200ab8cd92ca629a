"""PyTorch port vs the JAX package: the block-dense sparse-conv executor.

``ops/sparse.py:block_structure`` / ``block_conv_apply`` compute a
submanifold conv as a scatter into the halo tensors of blocks, one dense
``F.conv3d`` and a gather; SparseUNet takes it with
``tpu.sparse_conv_impl=block`` (tests/test_block_conv.py holds JAX's).

Tolerances and reasons:
* the block structures (scatter targets, interior cells, valid blocks),
  on code-sorted sets with duplicate codes and dropped blocks: exactly
  equal;
* forward and both gradients of the conv: 1e-5 relative to each tensor's
  largest entry (float32 products summed in another order);
* the narrow SpUNet step under the block executor against JAX's: loss and
  PSNR 1e-5 relative, gradient norm 1e-4, each gradient (through Adam's
  first moment) 1e-4 relative to its tensor's largest entry, biases ahead
  of a BatchNorm noise on both sides (tests/test_torch_train_step.py);
  against the port's gather step: the loss and the BatchNorm running
  statistics (the forward) at 1e-5 / 1e-4; the gradients differ below the
  PointFusion merge, where the gather's mirror-flip backward gives a
  duplicate row its representative's gradient (ROADMAP C) and the block's
  true transpose gives it none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unipre3d_tpu.ops import sparse as jsp
from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu.training.config import load_config as jload_config
from unipre3d_tpu_torch.data import SyntheticSceneDataset, batch_to, collate
from unipre3d_tpu_torch.models import scene_geometry as tgeo
from unipre3d_tpu_torch.ops import sparse as tsp
from unipre3d_tpu_torch.training import trainer
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_scene_step import shared_across_workers
from test_torch_sparse import canonical_pair, close, eq
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NARROW = ["data.training_width=32", "data.training_height=32",
          "data.input_images=2", "data.max_points=1024", "opt.batch_size=2",
          "data.pts_dataset_root=synthetic", "opt.ema.update_after_step=1",
          "tpu.raster_impl_train=pallas_binned",
          "tpu.raster_tile_capacity=1024",
          "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
          "layers_per_block: 1}"]
SPUNET = ("channels: [16, 16, 24, 24, 24, 16, 16, 16], layers: [1, 1, 1, "
          "1, 1, 1, 1, 1], pixel_capacity: 512")
BLOCK = NARROW + ["tpu.sparse_conv_impl=block",
                  "model.backbone_overrides={" + SPUNET + "}"]
GATHER = NARROW + ["model.backbone_overrides={" + SPUNET + "}"]


def both_structures(rng, k, nb_cap, dups, bs=4, extent=14):
    jsv, tsv = canonical_pair(rng, 220, 300, extent=extent, dups=dups)
    j = jsp.block_structure(jsv.coords, jsv.mask, nb_cap, bs=bs,
                            halo=k // 2)
    t = tsp.block_structure(tsv.coords, tsv.mask, nb_cap, bs=bs,
                            halo=k // 2)
    return jsv, tsv, j, t


@pytest.mark.parametrize("k,bs,nb_cap,dups", [
    (3, 4, 256, 0), (3, 4, 256, 60), (5, 4, 256, 60), (3, 8, 64, 60),
    (3, 4, 12, 60)])
def test_block_structure_equals_jax(k, bs, nb_cap, dups):
    rng = np.random.default_rng(10 * k + bs + dups)
    _, tsv, j, t = both_structures(rng, k, nb_cap, dups, bs)
    for name, a, b in zip(j._fields, j, t):
        eq(a, b, name)
    if nb_cap == 12:                       # some blocks dropped
        assert bool(((t.out_idx < 0) & tsv.mask).any())


def jax_block_conv(feats, bst, w, dy):
    """JAX's block conv over a batch of scenes: y and both gradients of
    sum(y * dy)."""
    def f(x, w):
        y = jax.vmap(jsp.block_conv_apply, in_axes=(0, 0, None, None))(
            x, bst, w, 4)
        return jnp.sum(y * dy), y
    (_, y), (dx, dw) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(feats),
                                          jnp.asarray(w))
    return y, dx, dw


def port_block_conv(feats, bst, w, dy, dtype=torch.float32):
    x = torch.from_numpy(feats).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = tsp.block_conv_apply(x, bst, wt.to(dtype), 4)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    return y.detach(), x.grad, wt.grad


@pytest.mark.parametrize("k", [3, 5])
def test_block_conv_forward_and_gradients_match_jax(k):
    rng = np.random.default_rng(30 + k)
    pairs = [both_structures(rng, k, 40, 60) for _ in range(2)]
    jb = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                *[p[2] for p in pairs])
    tb = tsp.BlockStructure(*(torch.stack(x) for x in
                              zip(*[p[3] for p in pairs])))
    M = tb.out_idx.shape[1]
    feats = rng.normal(size=(2, M, 5)).astype(np.float32)
    w = (rng.normal(size=(k ** 3, 5, 7)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(2, M, 7)).astype(np.float32)
    for name, a, b in zip(("y", "dfeats", "dw"),
                          jax_block_conv(feats, jb, w, dy),
                          port_block_conv(feats, tb, w, dy)):
        close(a, b, 1e-5, name)
    y = port_block_conv(feats, tb, w, dy)[0]
    dropped = (tb.out_idx < 0)
    assert bool(dropped.any())             # 40 blocks: some dropped
    assert float(y[dropped].abs().max()) == 0.0


@pytest.mark.parametrize("k", [3, 5])
def test_block_conv_matches_the_gather_path(k):
    """On sets without duplicate codes and without dropped blocks the two
    executors compute the same sum, forward and backward."""
    rng = np.random.default_rng(40 + k)
    _, tsv, _, bst = both_structures(rng, k, 300, 0)
    nbr = tsp.find_neighbors(tsv, tsp.kernel_offsets(k))
    M = nbr.shape[0]
    feats = rng.normal(size=(1, M, 6)).astype(np.float32)
    w = (rng.normal(size=(k ** 3, 6, 4)) * 0.2).astype(np.float32)
    dy = rng.normal(size=(1, M, 4)).astype(np.float32)
    b1 = tsp.BlockStructure(*(x[None] for x in bst))
    x = torch.from_numpy(feats).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = tsp.subm_gather_matmul(x, nbr[None], wt)
    (y * torch.from_numpy(dy)).sum().backward()
    for name, a, b in zip(("y", "dfeats", "dw"),
                          (y.detach(), x.grad, wt.grad),
                          port_block_conv(feats, b1, w, dy)):
        close(a, b, 1e-5, name)
    assert float(y.detach()[0][~tsv.mask].abs().max()) == 0.0


def test_kernel_layout_on_an_asymmetric_kernel():
    """One tap of the k^3 kernel (x-major, ``kernel_offsets``) reads the
    neighbour at exactly its offset: x is the conv's depth axis."""
    coords = torch.tensor([[5, 5, 5], [6, 5, 4], [4, 5, 6], [5, 6, 5]],
                          dtype=torch.int32)
    feats = torch.tensor([[1.0], [2.0], [3.0], [4.0]])
    sv, _ = tsp.canonicalize(coords, feats, torch.ones(4, dtype=torch.bool))
    offs = tsp.kernel_offsets(3)
    tap = int(np.flatnonzero((offs == [1, 0, -1]).all(1))[0])
    w = torch.zeros(27, 1, 1)
    w[tap] = 1.0
    bst = tsp.block_structure(sv.coords, sv.mask, 8)
    y = tsp.block_conv_apply(sv.feats[None], tsp.BlockStructure(
        *(x[None] for x in bst)), w)[0, :, 0]
    want = {(5, 5, 5): 2.0, (6, 5, 4): 0.0, (4, 5, 6): 1.0, (5, 6, 5): 0.0}
    for c, v in zip(sv.coords.tolist(), y.tolist()):
        assert v == want[tuple(c)], (c, v)


def test_block_conv_bf16_gradient():
    rng = np.random.default_rng(6)
    _, tsv, _, bst = both_structures(rng, 3, 300, 0)
    M = bst.out_idx.shape[0]
    feats = rng.normal(size=(1, M, 4)).astype(np.float32)
    w = rng.normal(size=(27, 4, 4)).astype(np.float32)
    dy = rng.normal(size=(1, M, 4)).astype(np.float32)
    y, dx, dw = port_block_conv(feats, tsp.BlockStructure(
        *(x[None] for x in bst)), w, dy, dtype=torch.bfloat16)
    assert y.dtype == dx.dtype == torch.bfloat16
    assert dw.dtype == torch.float32 and bool(torch.isfinite(dw).all())
    ref = port_block_conv(feats, tsp.BlockStructure(
        *(x[None] for x in bst)), w, dy)[0]
    close(ref, y.float(), 2e-2, "bf16 forward")


def _scene_batch():
    cfg = load_config("sparseunet_pretraining", overrides=BLOCK)
    ds = SyntheticSceneDataset(cfg, num_scenes=2, seed=0, device="cpu")
    batch = collate([ds[0], ds[1]])
    batch["gt_images"] = np.random.default_rng(1).uniform(
        0, 1, batch["gt_images"].shape).astype(np.float32)
    return batch


def test_geometry_counts_rows_of_dropped_blocks():
    """``block_dropped`` per level (stem, fine, stages) counts the valid
    rows whose block is past the capacity; those rows' conv outputs are
    0 (JAX zeroes them without counting)."""
    batch = _scene_batch()
    pc = {k: torch.from_numpy(v) for k, v in batch["point_cloud"].items()}
    un = torch.from_numpy(batch["unprojected_coords"])
    kw = dict(grid_size=0.02, pixel_capacity=512, level_divs=(3, 9, 27, 81),
              n_stages=4, use_fusion=True, conv_impl="block")
    roomy = tgeo.build_spunet_geometry(pc, un, block_div=1, **kw)
    tight = tgeo.build_spunet_geometry(pc, un, block_div=64, **kw)
    assert roomy.block_dropped.shape == (2, 6)
    assert int(roomy.block_dropped.sum()) == 0
    assert int(tight.block_dropped.sum()) > 0
    b = tight.nbr3_fine
    want = (tight.fine_mask & (b.out_idx < 0)).sum(1)
    eq(tight.block_dropped[:, 1], want)
    x = torch.randn(*tight.fine_mask.shape, 3)
    y = tsp.block_conv_apply(x, b, torch.randn(27, 3, 2))
    assert float(y[b.out_idx < 0].abs().max()) == 0.0
    gather = tgeo.build_spunet_geometry(pc, un, **{**kw,
                                                   "conv_impl": "gather"})
    assert gather.block_dropped is None
    with pytest.raises(ValueError, match="conv_impl"):
        tgeo.build_spunet_geometry(pc, un, **{**kw, "conv_impl": "dense"})


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def adam_mu(opt_state):
    return next(leaf for leaf in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(leaf, "mu")).mu


def _jax_block_step():
    batch = _scene_batch()
    jcfg = jload_config("sparseunet_pretraining", overrides=BLOCK)
    jmodel, tx, jstate = jtrainer.create_train_state(
        jcfg, jax.random.PRNGKey(0), batch)
    init = jax_to_state_dict(np_tree(jstate.params),
                             np_tree(jstate.batch_stats))
    geo = jax.jit(jtrainer.make_geometry_fn(jcfg, jmodel))(batch)
    batch["geometry"] = geo
    new, jm = jax.jit(jtrainer.make_train_step(jcfg, jmodel, tx))(
        jstate, batch)
    return dict(init=init,
                jm={k: torch.tensor(float(v)) for k, v in jm.items()},
                jmu=jax_to_state_dict(np_tree(adam_mu(new.opt_state))))


def _port_step(over, init):
    cfg = load_config("sparseunet_pretraining", overrides=over)
    model, state = trainer.create_train_state(cfg, device="cpu",
                                              state_dict=init)
    batch = batch_to(_scene_batch(), "cpu")
    batch["geometry"] = trainer.make_geometry_fn(cfg, model)(batch)
    m = trainer.make_train_step(cfg, model)(state, batch)
    names = [n for n, _ in trainer.split_frozen(model)[0]]
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    return (m, dict(zip(names, state.optimizer.mu)), stats,
            batch["geometry"])


def test_spunet_block_step_matches_jax_and_gather(tmp_path_factory):
    ref = shared_across_workers(tmp_path_factory, "block_spunet_step",
                                _jax_block_step)
    jm = {k: float(v) for k, v in ref["jm"].items()}
    m, mu, stats, geo = _port_step(BLOCK, ref["init"])
    assert isinstance(geo.nbr3_fine, tsp.BlockStructure)
    for k in ("loss", "psnr"):
        assert m[k] == pytest.approx(jm[k], rel=1e-5), k
    assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-4)
    gmax = max(float(v.abs().max()) for v in ref["jmu"].values())
    assert set(mu) == set(ref["jmu"])
    for n, j in ref["jmu"].items():
        if float(j.abs().max()) < 1e-3 * gmax:     # ahead of a BatchNorm
            assert float(mu[n].abs().max()) < 1e-3 * gmax, n
        else:
            close(j, mu[n], 1e-4, n)
    # against the gather executor, where no block drops (block_div 1)
    roomy = BLOCK[:-1] + ["model.backbone_overrides={" + SPUNET
                          + ", block_div: 1}"]
    mb, _, sb, gb = _port_step(roomy, ref["init"])
    mg, _, sg, _ = _port_step(GATHER, ref["init"])
    assert int(gb.block_dropped.sum()) == 0
    assert mb["loss"] == pytest.approx(mg["loss"], rel=1e-5)
    for k, v in sg.items():
        close(v, sb[k], 1e-4, k)


def test_unknown_sparse_conv_impl_raises():
    cfg = load_config("sparseunet_pretraining",
                      overrides=NARROW + ["tpu.sparse_conv_impl=dense"])
    with pytest.raises(ValueError, match="sparse_conv_impl"):
        trainer.create_train_state(cfg, device="cpu")
