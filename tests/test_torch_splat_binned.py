"""PyTorch port vs the JAX package: the binned splat (duplicate prep, plain
forward and backward, the autograd Function) against
``rasterize_projected_pallas_binned`` in interpret mode.

Inputs are projected by the JAX package from numpy-seeded gaussians (the
shapes of tests/test_pallas_splat.py) and handed to both packages; the
port renders all views in one call, JAX one view at a time.

Tolerances and reasons:
* the duplicate list (depth ranks in (tile, depth) order, per-tile counts,
  the depth order, the gathered table): exactly equal, after mapping the
  JAX layout (each tile's segment padded to 1024) back to the raw list;
* images: 2e-5 absolute per pixel. The JAX kernel sums log(1 - alpha)
  with a roll scan, the port sequentially, so a pixel whose log T lands
  within rounding of log(1e-4) can take the other stop decision; such a
  flip moves it by up to alpha x T (~1e-4 here). The tests count the
  pixels beyond 2e-5 and allow at most 2 of every case's pixels, with 1e-3
  as their own bound; no case here has one (measured: no flip, at most
  4.2e-7);
* gradients: 1e-4 relative to each tensor's largest entry (the dense
  splat's tolerance; the two sum over pixels in other orders).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unipre3d_tpu.ops.rasterizer import pallas_splat_binned as jpsb
from unipre3d_tpu.ops.rasterizer.preprocess import \
    preprocess_gaussians as jpreprocess
from unipre3d_tpu.utils import camera as cam
from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb
from unipre3d_tpu_torch.ops.rasterizer.preprocess import ProjectedGaussians
from unipre3d_tpu_torch.ops.rasterizer.render import \
    rasterize_projected_reference
from test_torch_kernels_cuda import (BINNED_CULL_CASES, binned_cull_case,
                                     binned_prep)
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FOV = math.radians(49.13)
RES = 32
BG = np.asarray([0.1, 0.2, 0.3], np.float32)
FIELDS = ("mean2d", "conic", "color", "opacity", "depth", "radius", "valid")


def projected(n=200, seed=1, scale=0.015, views=1, spread=0.3, shift=None,
              mask_every=None):
    """JAX-projected gaussians of ``views`` cameras: dict of numpy [V, n, ...]
    (tests/test_pallas_splat.py:setup, with more cameras)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    if shift is not None:
        means[:n // 2, :2] += shift
    opa = rng.uniform(0.3, 0.9, n).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32) * scale
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    shs = np.zeros((n, 4, 3), np.float32)
    shs[:, 0] = (rng.uniform(0, 1, (n, 3)) - 0.5) / 0.28209479177387814
    mask = None if mask_every is None else np.arange(n) % mask_every != 0
    out = {k: [] for k in FIELDS}
    for v in range(views):
        a = 0.4 * v
        R = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                      [-math.sin(a), 0, math.cos(a)]], np.float32)
        c = cam.build_camera_tensors(R, np.array([0.0, 0.0, 1.5]), FOV, FOV,
                                     0.5, 2.0)
        pg = jpreprocess(
            *(jnp.asarray(x) for x in (means, opa, scales, q, shs)),
            jnp.asarray(c["world_view_transform"]),
            jnp.asarray(c["full_proj_transform"]),
            jnp.asarray(c["camera_center"]), RES, RES, math.tan(FOV / 2),
            math.tan(FOV / 2), 1,
            gaussian_mask=None if mask is None else jnp.asarray(mask))
        for k in FIELDS:
            out[k].append(np.asarray(getattr(pg, k)))
    return {k: np.stack(v) for k, v in out.items()}


def _pg(p, v):
    from unipre3d_tpu.ops.rasterizer.preprocess import ProjectedGaussians
    return ProjectedGaussians(**{k: jnp.asarray(p[k][v]) for k in FIELDS})


def torch_inputs(p, grad=False):
    t = [torch.from_numpy(p[k]) for k in FIELDS]
    if grad:
        t = [x.clone().requires_grad_(i < 4) for i, x in enumerate(t)]
    return t


def render_both(p, tile, max_per_tile=16384, dup_budget=None, cot=None):
    """Images of every view from both packages, and with a cotangent the
    gradients w.r.t. mean2d, conic, color, opacity."""
    V = p["depth"].shape[0]
    jimgs, jgrads = [], []
    for v in range(V):
        pg = _pg(p, v)

        def f(m, c, col, o):
            return jpsb.rasterize_projected_pallas_binned(
                pg._replace(mean2d=m, conic=c, color=col, opacity=o),
                jnp.asarray(BG), RES, RES, tile_h=tile, tile_w=tile,
                max_per_tile=max_per_tile, dup_budget=dup_budget)
        img, vjp = jax.vjp(f, pg.mean2d, pg.conic, pg.color, pg.opacity)
        jimgs.append(np.asarray(img))
        if cot is not None:
            jgrads.append([np.asarray(g) for g in vjp(jnp.asarray(cot[v]))])
    t = torch_inputs(p, grad=cot is not None)
    timg = sb.rasterize_projected_binned(
        *t, torch.from_numpy(BG), RES, RES, tile, tile,
        max_per_tile=max_per_tile, dup_budget=dup_budget)
    tgrads = None
    if cot is not None:
        (timg * torch.from_numpy(cot)).sum().backward()
        tgrads = [t[i].grad.numpy() for i in range(4)]
        jgrads = [np.stack([g[i] for g in jgrads]) for i in range(4)]
    return np.stack(jimgs), timg.detach().numpy(), jgrads, tgrads


def assert_images(jimg, timg):
    err = np.abs(jimg - timg).max(axis=1)            # per pixel
    flipped = err > 2e-5
    assert flipped.sum() <= 2, (flipped.sum(), err.max())
    assert err.max() <= 1e-3


def assert_grads(jg, tg):
    for name, a, b in zip(("mean2d", "conic", "color", "opacity"), jg, tg):
        assert np.isfinite(b).all(), name
        denom = np.abs(a).max() + 1e-12
        assert np.abs(a - b).max() / denom < 1e-4, (name,
                                                    np.abs(a - b).max() / denom)


CASES = {
    # (projected kwargs, tile, max_per_tile, dup_budget)
    "base": (dict(n=200, views=2), 8, 16384, None),
    "masked_and_empty_tiles": (dict(n=64, scale=0.01, shift=0.25,
                                    mask_every=4), 8, 16384, None),
    "large_radius": (dict(n=48, scale=0.12), 8, 16384, None),
    "budget_overflow": (dict(n=200, scale=0.12), 8, 16384, 1024),
    "chunk_rearm": (dict(n=2500, scale=0.03, spread=0.25), 16, 4096, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prep_equals_jax_layout(case):
    kw, tile, _, budget = CASES[case]
    p = projected(**kw)
    n_tiles = (RES // tile) ** 2
    N = p["depth"].shape[1]
    budget = budget or jpsb.default_dup_budget(N, n_tiles)
    t = torch_inputs(p)
    dup = sb.prep_duplicates(t[0], t[5], t[4], t[6], RES, RES, tile, tile,
                             budget)
    counts = np.diff(dup.seg.numpy()).reshape(-1, n_tiles)
    for v in range(p["depth"].shape[0]):
        pg = _pg(p, v)
        data, dup_idx, d_ids, seg = jpsb._prep_duplicates(
            pg.mean2d, pg.conic, pg.color,
            jnp.where(pg.valid, pg.opacity, 0.0), pg.depth, pg.radius,
            pg.valid, RES, RES, tile, tile, budget)
        dup_idx, seg = np.asarray(dup_idx), np.asarray(seg)
        live = dup_idx >= 0
        tile_of = np.searchsorted(seg, np.arange(len(dup_idx)), "right") - 1
        np.testing.assert_array_equal(
            np.bincount(tile_of[live], minlength=n_tiles), counts[v])
        mine = (dup.gid // N == v).numpy()
        np.testing.assert_array_equal(dup_idx[live], dup.rank.numpy()[mine])
        np.testing.assert_array_equal(np.asarray(d_ids), dup.d_ids[v].numpy())
        table = sb.gaussian_rows(*t[:4], t[6])[dup.gid[mine]].t().numpy()
        np.testing.assert_array_equal(np.asarray(data)[:9, live], table)
    if case == "budget_overflow":
        assert int(dup.span_sum.sum()) > dup.gid.shape[0]


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_gradients_match_jax(case):
    kw, tile, cap, budget = CASES[case]
    p = projected(**kw)
    cot = np.random.default_rng(5).normal(
        size=(p["depth"].shape[0], 3, RES, RES)).astype(np.float32)
    jimg, timg, jg, tg = render_both(p, tile, cap, budget, cot)
    assert_images(jimg, timg)
    assert_grads(jg, tg)


def test_chunk_rearm_matches_jax_not_sequential_reference():
    """A tile's list runs past 1024 duplicates: both kernels restart the
    stop at the chunk boundary (a saturated pixel takes small-alpha
    duplicates again), which the sequential brute-force renderer does
    not."""
    kw, tile, cap, _ = CASES["chunk_rearm"]
    p = projected(**kw)
    t = torch_inputs(p)
    dup = sb.prep_duplicates(t[0], t[5], t[4], t[6], RES, RES, tile, tile,
                             jpsb.default_dup_budget(p["depth"].shape[1], 4))
    assert int(np.diff(dup.seg.numpy()).max()) > sb.CHUNK
    jimg, timg, _, _ = render_both(p, tile, cap)
    assert_images(jimg, timg)
    ref = rasterize_projected_reference(
        ProjectedGaussians(*(x[0] for x in t)), BG.tolist(), RES, RES)
    # beyond the image tolerance: the sequential walk would fail this test
    assert np.abs(ref.numpy() - timg[0]).max() > 2e-5


@pytest.fixture(scope="module")
def cut_case():
    """Tiles whose lists run past the per-tile cap of one 1024-chunk."""
    p = projected(n=1500, scale=0.05, spread=0.2, seed=3)
    t = torch_inputs(p)
    dup = sb.prep_duplicates(t[0], t[5], t[4], t[6], RES, RES, 16, 16,
                             jpsb.default_dup_budget(1500, 4))
    assert int(np.diff(dup.seg.numpy()).max()) > 1024
    cot = np.random.default_rng(6).normal(size=(1, 3, RES, RES)).astype(
        np.float32)
    return p, dup, cot


def test_cut_tiles_jax_nan_port_finite(cut_case):
    """The JAX backward leaves the gradient rows of duplicates past the cap
    unwritten and scatter-adds them (NaN in interpret mode). The port's
    gradients are finite, equal to JAX's on every gaussian JAX gives finite
    and exactly 0 for gaussians none of whose duplicates is composited."""
    p, dup, cot = cut_case
    jimg, timg, jg, tg = render_both(p, 16, 1024, cot=cot)
    assert_images(jimg, timg)
    assert not all(np.isfinite(g).all() for g in jg)   # the JAX fault
    D = dup.gid.shape[0]
    pos = np.arange(D) - np.repeat(dup.seg.numpy()[:-1], np.diff(dup.seg))
    kept = np.zeros(p["depth"].shape[1], bool)
    kept[dup.gid.numpy()[pos < 1024]] = True
    dropped = ~kept[None]
    assert dropped[0][p["valid"][0]].sum() > 10
    for name, a, b in zip(("mean2d", "conic", "color", "opacity"), jg, tg):
        assert np.isfinite(b).all(), name
        rows = np.isfinite(a.reshape(1, a.shape[1], -1)).all(-1)
        assert rows.sum() > 100
        denom = np.abs(a[rows]).max()
        assert np.abs(a - b)[rows].max() / denom < 1e-4, name
        assert (b[dropped] == 0).all(), name


def test_cut_tiles_port_gradient_is_its_forward_derivative(cut_case):
    """Central differences of the port's own forward (float32 colour and
    opacity steps): the analytic rows of kept gaussians match, and a
    dropped gaussian's forward does not move at all."""
    p, dup, cot = cut_case
    t = torch_inputs(p, grad=True)
    bg = torch.from_numpy(BG)
    w = torch.from_numpy(cot)

    def loss(tt):
        return float((sb.rasterize_projected_binned(
            *tt, bg, RES, RES, 16, 16, max_per_tile=1024) * w).sum())
    (sb.rasterize_projected_binned(*t, bg, RES, RES, 16, 16,
                                   max_per_tile=1024) * w).sum().backward()
    D = dup.gid.shape[0]
    pos = np.arange(D) - np.repeat(dup.seg.numpy()[:-1], np.diff(dup.seg))
    kept = np.zeros(p["depth"].shape[1], bool)
    kept[dup.gid.numpy()[pos < 1024]] = True
    g_col, g_opa = t[2].grad[0], t[3].grad[0]
    live = np.flatnonzero(kept & p["valid"][0])
    pick = live[np.argsort(-np.abs(g_opa.numpy()[live]))[:4]]
    dead = np.flatnonzero(~kept & p["valid"][0])[:3]
    base = [x.detach() for x in t]
    for i in list(pick) + list(dead):
        for field, k, eps, grad in (("color", 2, 1e-2, g_col[i, 0]),
                                    ("opacity", 3, 1e-3, g_opa[i])):
            hi, lo = [x.clone() for x in base], [x.clone() for x in base]
            if field == "color":
                hi[k][0, i, 0] += eps
                lo[k][0, i, 0] -= eps
            else:
                hi[k][0, i] += eps
                lo[k][0, i] -= eps
            fd = (loss(hi) - loss(lo)) / (2 * eps)
            if i in dead:
                assert fd == 0.0 and float(grad) == 0.0, (field, i)
            else:
                assert abs(fd - float(grad)) <= 2e-2 * abs(float(grad)) + 1e-3, \
                    (field, i, fd, float(grad))


@pytest.mark.parametrize("case", BINNED_CULL_CASES)
def test_patch_cull_twin_is_conservative(case):
    """Every (render, pixel, duplicate) pair the plain walk does not skip
    (alpha != 0) is kept, in the twin of the kernels' per-warp cull, for
    the warp that owns the pixel, so the culled kernels walk every pair
    that matters; and the cull culls."""
    ins, H, W, th, tw = binned_cull_case(case)
    dup, table = binned_prep(ins, H, W, th, tw)
    R, cap = ins[0].shape[0], 4096
    counts = (dup.seg[1:] - dup.seg[:-1]).long()
    if case == "rearm":
        assert int(counts.max()) > sb.CHUNK
    bits = torch.nn.functional.pad(sb.patch_survivors_ref(
        dup.seg, table, R, H, W, th, tw, cap), (0, 1))  # + the dump column
    warp = sb.warp_of_pixel(th, tw)
    px, py, _ = sb._tile_pixels(R, H, W, th, tw, table.device)
    missed = live_pairs = 0
    for col, _, terms, _ in sb._walk(dup.seg, sb._padded(table), px, py,
                                     cap):
        live = ~terms[4]                                     # [blocks, P]
        kept = (bits[col][:, None] >> warp) & 1
        missed += int((live & (kept == 0)).sum())
        live_pairs += int(live.sum())
    assert missed == 0 and live_pairs > 0
    n_warps = int(warp.max()) + 1
    kept = sum(int(((bits >> w) & 1).sum()) for w in range(n_warps))
    assert kept < 0.9 * int(counts.clamp(max=cap).sum()) * n_warps
