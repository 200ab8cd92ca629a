"""PyTorch port vs the JAX package: the streaming splat (the plain forward
and backward behind ``StreamSplat``, the chunk bitmap) against
``rasterize_projected_pallas`` in interpret mode.

Inputs are projected by the JAX package from numpy-seeded gaussians
(tests/test_torch_splat_binned.py:projected), or written in screen space
for the three cases that pin the kernel's own rules; every interpret-mode
call stays at <= 16 tiles and <= 3 chunks of 512.

Tolerances and reasons:
* images: 2e-5 absolute per pixel. The JAX kernel sums a chunk's log(1 -
  alpha) with a log-step scan, the port one gaussian at a time, so a pixel
  whose log T lands within rounding of log(1e-4) can take the other stop
  decision (a flip moves it by up to alpha x T ~ 1e-4). At most 2 pixels of
  a case may pass 2e-5, with 1e-3 as their bound; none does here (measured
  <= 4e-7);
* gradients w.r.t. mean2d, conic, colour, opacity and bg: 1e-4 relative to
  each tensor's largest entry (the two sum over pixels and chunks in other
  orders; measured <= 2e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unipre3d_tpu.ops.rasterizer import pallas_splat_dense as jpsd
from unipre3d_tpu.ops.rasterizer.pallas_splat import \
    rasterize_projected_pallas
from unipre3d_tpu.ops.rasterizer.preprocess import \
    ProjectedGaussians as JProjected
from unipre3d_tpu.ops.rasterizer.render import _sorted_by_depth
from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
from unipre3d_tpu_torch.ops.rasterizer.preprocess import ProjectedGaussians
from unipre3d_tpu_torch.ops.rasterizer.render import (
    rasterize_projected, rasterize_projected_reference)
from test_torch_kernels_cuda import STREAM_CULL_CASES, stream_cull_case
from test_torch_splat_binned import FIELDS, projected
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

RES = 32
TILE = 8          # 16 tiles of 8x8


pytestmark = pytest.mark.usefixtures("one_torch_thread")
BG = np.asarray([0.1, 0.2, 0.3], np.float32)
GRAD_NAMES = ("mean2d", "conic", "color", "opacity", "bg")


@jax.jit
def _jax_vjp(fields, cot):
    pg = JProjected(*fields)

    def f(m, c, col, o, bg):
        return rasterize_projected_pallas(
            pg._replace(mean2d=m, conic=c, color=col, opacity=o), bg, RES,
            RES, tile_h=TILE, tile_w=TILE)
    img, vjp = jax.vjp(f, pg.mean2d, pg.conic, pg.color, pg.opacity, BG)
    return img, vjp(cot)


@jax.jit
def _jax_fwd(fields):
    return rasterize_projected_pallas(JProjected(*fields), BG, RES, RES,
                                      tile_h=TILE, tile_w=TILE)


def jax_render(p, v, cot=None):
    """JAX image of view v and, with a cotangent, its gradients w.r.t.
    mean2d, conic, color, opacity and bg."""
    fields = tuple(jnp.asarray(p[k][v]) for k in FIELDS)
    if cot is None:
        return np.asarray(_jax_fwd(fields)), None
    img, grads = _jax_vjp(fields, jnp.asarray(cot[v]))
    return np.asarray(img), [np.asarray(g) for g in grads]


def torch_render(p, cot=None):
    """The port's images of every view in one call [V, 3, H, W] and the
    gradients (per view stacked; bg summed over views)."""
    t = [torch.from_numpy(p[k]).clone() for k in FIELDS]
    for x in t[:4]:
        x.requires_grad_(cot is not None)
    bg = torch.from_numpy(BG).clone().requires_grad_(cot is not None)
    img = ss.rasterize_projected_stream(ProjectedGaussians(*t), bg, RES, RES,
                                        TILE, TILE)
    if cot is None:
        return img.detach().numpy(), None
    (img * torch.from_numpy(cot)).sum().backward()
    return img.detach().numpy(), [x.grad.numpy() for x in t[:4]] + \
        [bg.grad.numpy()]


def assert_images(jimg, timg):
    err = np.abs(jimg - timg).max(axis=-3)            # per pixel
    flipped = err > 2e-5
    assert flipped.sum() <= 2, (flipped.sum(), err.max())
    assert err.max() <= 1e-3


def assert_grads(jg, tg):
    for name, a, b in zip(GRAD_NAMES, jg, tg):
        a = a.reshape(b.shape)
        assert np.isfinite(b).all(), name
        err = np.abs(a - b).max() / (np.abs(a).max() + 1e-12)
        assert err < 1e-4, (name, err)


# three chunks of 512, masked and off-screen gaussians, two views in one
# port call (test_flagged_chunk_... covers radii past the tile)
THREE_CHUNKS = dict(n=1300, views=2, scale=0.02, spread=0.35, mask_every=5,
                    shift=0.3)


def test_forward_and_gradients_match_jax():
    p = projected(**THREE_CHUNKS)
    assert ss.padded_n(p["depth"].shape[1]) == 3 * ss.CHUNK
    V = p["depth"].shape[0]
    cot = np.random.default_rng(5).normal(size=(V, 3, RES, RES)).astype(
        np.float32)
    timg, tg = torch_render(p, cot)
    jimgs, jgs = zip(*(jax_render(p, v, cot) for v in range(V)))
    assert_images(np.stack(jimgs), timg)
    jg = [np.stack([g[i] for g in jgs]) for i in range(4)] + \
        [sum(g[4] for g in jgs)]
    assert_grads(jg, tg)


def jax_flags(p, v):
    """pallas_splat.py's bitmap (:352-364) of view v, numpy [16, chunks]."""
    s = _sorted_by_depth(JProjected(**{k: jnp.asarray(p[k][v])
                                       for k in FIELDS}))
    n_pad = ss.padded_n(p["depth"].shape[1])
    x0 = (np.arange(16) % 4) * TILE
    y0 = (np.arange(16) // 4) * TILE
    r, gx, gy = (np.asarray(a, np.float32) for a in (
        s.radius, s.mean2d[:, 0], s.mean2d[:, 1]))
    ov = (((gx + r)[None] >= x0[:, None])
          & ((gx - r)[None] <= (x0 + TILE - 1)[:, None])
          & ((gy + r)[None] >= y0[:, None])
          & ((gy - r)[None] <= (y0 + TILE - 1)[:, None])
          & np.asarray(s.valid)[None])
    ov = np.pad(ov, ((0, 0), (0, n_pad - ov.shape[1])))
    return ov.reshape(16, -1, ss.CHUNK).any(-1).astype(np.int32)


def port_inputs(p):
    """The port's table and bitmap of a numpy case."""
    pg = ProjectedGaussians(*(torch.from_numpy(p[k]) for k in FIELDS))
    return ss.stream_inputs(pg, RES, RES, TILE, TILE)[:2]


def port_flags(p):
    return port_inputs(p)[1].numpy()


def stripes_case():
    """1300 small gaussians whose depth order runs left half (chunk 0),
    right half (chunk 1), left half (chunk 2): the left tiles have chunk 1
    unflagged between two flagged ones. -> screen dict."""
    rng = np.random.default_rng(3)
    n = 1300
    right = (np.arange(n) // ss.CHUNK) % 2 == 1
    x = rng.uniform(1, 14, n) + 16 * right
    mean2d = np.stack([x, rng.uniform(1, 31, n)], -1)
    return screen_gaussians(mean2d, rng.uniform(0.3, 0.9, n),
                            rng.uniform(0.2, 0.7, n),
                            rng.uniform(0, 1, (n, 3)))


def test_chunk_flags_equal_jax_bitmap():
    """The bitmap of the depth-sorted gaussians equals pallas_splat.py's,
    and a case with unflagged chunks between flagged ones renders as
    JAX's."""
    p = projected(**THREE_CHUNKS)
    flags = port_flags(p)
    for v in range(p["depth"].shape[0]):
        np.testing.assert_array_equal(flags[v], jax_flags(p, v))
    p = stripes_case()
    flags = port_flags(p)[0]
    np.testing.assert_array_equal(flags, jax_flags(p, 0))
    left = (np.arange(16) % 4) == 0
    assert (flags[left] == [1, 0, 1]).all()
    assert (flags[(np.arange(16) % 4) == 3] == [0, 1, 0]).all()
    assert_images(jax_render(p, 0)[0][None], torch_render(p)[0])


def screen_gaussians(mean2d, sigma, opacity, color, conic=None,
                     radius=None):
    """Screen-space gaussians (one view): isotropic sigma (plus the 0.3 px
    blur) unless a conic is given; radius 3 sigma as preprocess gives it,
    unless given; depth in index order; all valid. -> dict of [1, n, ...]."""
    n = len(opacity)
    var = np.asarray(sigma, np.float64) ** 2 + 0.3
    if conic is None:
        conic = np.stack([1 / var, np.zeros(n), 1 / var], -1)
    if radius is None:
        radius = np.ceil(3 * np.sqrt(var + np.sqrt(0.1)))
    p = {"mean2d": np.asarray(mean2d), "conic": np.asarray(conic),
         "color": np.asarray(color), "opacity": np.asarray(opacity),
         "depth": 1.0 + 0.01 * np.arange(n), "radius": radius,
         "valid": np.ones(n, bool)}
    return {k: (v.astype(np.int32) if k == "radius" else
                v if k == "valid" else v.astype(np.float32))[None]
            for k, v in p.items()}


def test_flagged_chunk_composites_gaussians_outside_their_bbox():
    """A broad gaussian left of the image, whose bbox ends in tile column
    0, adds colour to pixels of column 1 (alpha ~0.006 at x = 8) while a
    small gaussian of the same chunk flags those tiles, and none once the
    small one moves to column 3 (the chunk unflagged there). The tiled
    renderer (a per-tile culled list) leaves it out: the streaming splat is
    not that function."""
    def case(small_x):
        return screen_gaussians([[-55.0, 16.0], [small_x, 16.0]],
                                [20.0, 0.7], [0.9, 0.8],
                                [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])

    flagged, unflagged = case(12.0), case(28.0)
    r = float(flagged["radius"][0, 0])
    assert -55.0 + r < TILE <= -55.0 + r + 2        # bbox ends in column 0
    imgs = []
    for p in (flagged, unflagged):
        timg = torch_render(p)[0]
        assert_images(jax_render(p, 0)[0][None], timg)
        imgs.append(timg[0, :, 8:24, TILE])   # x = 8, the small one's rows
    assert (imgs[0][0] - BG[0]).min() > 3e-3
    np.testing.assert_allclose(imgs[1], np.broadcast_to(
        BG[:, None], (3, 16)), atol=1e-7)
    tiled = rasterize_projected(ProjectedGaussians(
        *(torch.from_numpy(flagged[k][0]) for k in FIELDS)), BG.tolist(),
        RES, RES, TILE, TILE, capacity=64).numpy()
    assert np.abs(tiled[0, 8:24, TILE] - BG[0]).max() < 1e-6


def rearm_case():
    """600 gaussians over one pixel block: chunk 0 stops every pixel at
    its last three (opacities 0.9, 0.95, 0.99), chunk 1 offers alpha-0.5
    ones. -> screen dict."""
    n = 600
    opa = np.zeros(n)
    opa[509:512] = [0.9, 0.95, 1.0]
    opa[512:] = 0.5
    col = np.random.default_rng(7).uniform(0, 1, (n, 3))
    col[512:] = [1.0, 0.0, 1.0]
    return screen_gaussians(np.full((n, 2), 16.0), np.full(n, 1e3), opa,
                            col)


def test_rearm_at_512_matches_jax_not_sequential_reference():
    """A pixel stopped inside chunk 0 re-enters chunk 1 at its last
    contributing T and takes five alpha-0.5 gaussians more (down to T ~
    1.6e-4), which the sequential brute-force renderer does not."""
    p = rearm_case()
    jimg, _ = jax_render(p, 0)
    timg, _ = torch_render(p)
    assert_images(jimg[None], timg)
    ref = rasterize_projected_reference(ProjectedGaussians(
        *(torch.from_numpy(p[k][0]) for k in FIELDS)), BG.tolist(), RES,
        RES).numpy()
    assert np.abs(ref - timg[0]).max() > 1e-3
    table, flags = port_inputs(p)
    _, logt = ss.stream_fwd_ref(table, flags, torch.from_numpy(BG), RES, RES,
                                TILE, TILE)
    T = torch.exp(logt)
    assert 1e-4 < float(T.min()) and float(T.max()) < 2e-4


def test_walk_tally_counts_the_work_of_the_rearm_case():
    """The plain forward's optional tally (what chip_smoke reads for the
    stream kernels' bounds and purpose checks), on the re-arm case: every
    pixel takes columns 509-510, stops at 511, re-arms and takes 512-516
    (all five re-armed) and stops at 517. So the pairs tested are the
    contributing ones plus one stopping pair a pixel a chunk (the 509
    opacity-0 columns before them are not counted), and those seven columns
    add colour to every tile. The tally changes no output."""
    table, flags = port_inputs(rearm_case())
    bg = torch.from_numpy(BG)
    stats = {}
    out, logt = ss.stream_fwd_ref(table, flags, bg, RES, RES, TILE, TILE,
                                  stats=stats)
    ref = ss.stream_fwd_ref(table, flags, bg, RES, RES, TILE, TILE)
    assert torch.equal(out, ref[0]) and torch.equal(logt, ref[1])
    px = RES * RES
    assert int(stats["pairs"]) == 7 * px
    assert int(stats["evaluated"]) == 9 * px
    assert int(stats["rearm"]) == 5 * px
    cols = [509, 510, 512, 513, 514, 515, 516]
    hit = stats["hit"][0]                                # [16 tiles, 1024]
    assert hit[:, cols].all()
    assert hit.any(0).nonzero().flatten().tolist() == cols


def test_power_skip_is_zero_not_dense_threshold():
    """A pair whose power lies in (0, 1e-4] (an indefinite conic: power =
    1e-7 dx dy) is skipped by the streaming splat, as by its JAX kernel,
    and composited by the dense splat (which skips only above 1e-4)."""
    n = 2
    conic = np.asarray([[0.0, -1e-7, 0.0], [0.5, 0.0, 0.5]])
    p = screen_gaussians([[0.0, 0.0], [30.0, 30.0]], np.ones(n), [0.6, 0.6],
                         [[0.0, 1.0, 0.0], [1.0, 1.0, 1.0]], conic=conic,
                         radius=np.asarray([40, 2]))
    jimg, _ = jax_render(p, 0)
    timg, _ = torch_render(p)
    assert_images(jimg[None], timg)
    # every pixel with dx dy > 0 against gaussian 0 (x, y > 0) is skipped
    np.testing.assert_allclose(timg[0, :, 1:20, 1:20],
                               np.broadcast_to(BG[:, None, None], (3, 19, 19)),
                               atol=1e-7)
    dense = np.asarray(jpsd.rasterize_dense_batched(
        *(jnp.asarray(p[k]) for k in ("mean2d", "conic", "color", "opacity",
                                      "depth", "valid")),
        jnp.asarray(BG), RES, RES))[0]
    assert np.abs(dense[1, 1:20, 1:20] - BG[1]).min() > 0.3


def test_cpu_takes_the_plain_version_other_devices_raise():
    table, flags = port_inputs(rearm_case())
    bg = torch.from_numpy(BG)
    before = (ss.STREAM_FWD.launches, ss.STREAM_BWD.launches)
    out, logt = ss.stream_fwd(table, flags, bg, RES, RES, TILE, TILE)
    ref = ss.stream_fwd_ref(table, flags, bg, RES, RES, TILE, TILE)
    assert torch.equal(out, ref[0]) and torch.equal(logt, ref[1])
    assert (ss.STREAM_FWD.launches, ss.STREAM_BWD.launches) == before
    meta = [x.to("meta") for x in (table, flags, bg)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ss.stream_fwd(*meta, RES, RES, TILE, TILE)
    with pytest.raises(ValueError, match="several devices"):
        ss.stream_fwd(table, flags.to("meta"), bg, RES, RES, TILE, TILE)
    assert math.isfinite(float(out.sum()))


@pytest.mark.parametrize("case", STREAM_CULL_CASES)
def test_patch_cull_twin_is_conservative(case):
    """Every (render, pixel, gaussian) pair the plain walk does not skip
    (alpha != 0) is kept, in the twin of the kernels' per-warp cull, for
    the warp that owns the pixel, so the culled kernels walk every pair
    that matters (the walk's tally counts the misses); the cases meet
    their purpose (a re-arm, a gaussian composited outside its bbox); and
    the cull culls."""
    pg, H, W, th, tw = stream_cull_case(case)
    table, flags, s = ss.stream_inputs(pg, H, W, th, tw)
    bits = ss.patch_survivors_ref(table, flags, H, W, th, tw)
    stats = {"survivors": bits, "tile": (th, tw)}
    ss.stream_fwd_ref(table, flags, torch.from_numpy(BG), H, W, th, tw,
                      stats=stats)
    assert int(stats["missed"]) == 0 and int(stats["live"]) > 0
    assert int(stats["iters_patches"]) < int(stats["iters_rows"])
    if case == "rearm":
        assert int(stats["rearm"]) > 0
    if case == "outside_bbox":
        ov = ss.tile_overlap(s.mean2d, s.radius, s.valid, H, W, th, tw)
        assert int((stats["hit"][..., :ov.shape[-1]] & ~ov).sum()) > 0
    n_warps = int(ss.warp_of_pixel(th, tw).max()) + 1
    kept = sum(int(((bits >> w) & 1).sum()) for w in range(n_warps))
    assert kept < 0.9 * int(flags.sum()) * ss.CHUNK * n_warps
