"""PyTorch port vs the JAX package: preprocess and the dense splat.

The port's plain dense splat (what the CPU runs) is held to the JAX
``rasterize_dense_batched`` (Pallas kernel in interpret mode) in the cases
of tests/test_pallas_splat_dense.py, and to the JAX brute-force reference
renderer. Tolerances:

* 1e-4 against the JAX dense kernel, images (absolute) and gradients
  (relative to the largest): the JAX kernel's own bar against its
  reference. It evaluates the EWA power as an MXU polynomial and the T
  prefix with a bf16 hi/lo split; the port evaluates both directly
  (measured: ~7e-5 relative on gradients at 32x32).
* 1e-5 against the JAX brute-force reference (images) and against autograd
  through the port's own brute-force renderer (gradients), which evaluate
  the power the same direct way (measured ~3e-7): only float32 summation
  order differs.
* preprocess: 1e-5 relative (elementwise float32 maths).

The CUDA kernels against the plain versions are in
tests/test_torch_kernels_cuda.py (``cuda``-marked, no JAX).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_splat_dense import BG, FOV, RES, dense, prep_batch, setup_batch
from test_torch_kernels_cuda import CULL_CASES, cull_case
from test_torch_splat_stream import one_torch_thread  # noqa: F401
from test_torch_utils import trimmed_heap  # noqa: F401
from unipre3d_tpu.ops.rasterizer.preprocess import ProjectedGaussians
from unipre3d_tpu.ops.rasterizer.render import (
    rasterize_projected_reference, rasterize_reference)
from unipre3d_tpu_torch.ops.rasterizer import render as trender
from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd
from unipre3d_tpu_torch.ops.rasterizer.preprocess import \
    preprocess_gaussians as tprep

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TANF = math.tan(FOV / 2)


def to_t(arrs, grad=False):
    return [torch.tensor(np.asarray(a), requires_grad=grad) for a in arrs]


def t_prep(params, cams):
    return tprep(*params, *cams, RES, RES, TANF, TANF, 1)


def t_dense(pg, bg=BG):
    return sd.rasterize_dense_batched(
        pg.mean2d, pg.conic, pg.color, pg.opacity, pg.depth, pg.valid,
        torch.tensor(np.asarray(bg)), RES, RES)


def t_reference(pg):
    """The port's brute-force renderer, per render (autograd)."""
    return torch.stack([trender.rasterize_projected_reference(
        type(pg)(*(t[r] for t in pg)), np.array(BG), RES, RES)
        for r in range(pg.depth.shape[0])])


def j_ref(pg):
    return jax.vmap(lambda p: rasterize_projected_reference(
        p, BG, RES, RES))(pg)


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-8)


def test_preprocess_matches_jax_forward_and_grad():
    params, cams = setup_batch(R=2, n=150, seed=3)
    jpg = prep_batch(params, cams)
    tp = to_t(params, grad=True)
    tpg = t_prep(tp, to_t(cams))
    for name in ProjectedGaussians._fields:
        a, b = np.asarray(getattr(jpg, name)), getattr(tpg, name).detach()
        if name in ("radius", "valid"):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
        else:
            assert rel_err(a, b.numpy()) < 1e-5, name
    w = np.random.default_rng(0).normal(size=(2, 150, 2)).astype(np.float32)

    def jloss(*p):
        pg = prep_batch(p, cams)
        return (jnp.sum(pg.mean2d * w) + jnp.sum(pg.conic)
                + jnp.sum(pg.color ** 2) + jnp.sum(pg.opacity))

    g = jax.grad(jloss, argnums=tuple(range(5)))(*params)
    (torch.sum(tpg.mean2d * torch.from_numpy(w)) + tpg.conic.sum()
     + (tpg.color ** 2).sum() + tpg.opacity.sum()).backward()
    for i, nm in enumerate(["means", "opa", "scales", "rots", "shs"]):
        assert rel_err(g[i], tp[i].grad.numpy()) < 1e-5, nm


CASES = {  # name: (R, n, seed, scale, mask every third gaussian)
    "per_render": (3, 150, 1, 0.015, False),
    "non_multiple_of_128": (2, 97, 1, 0.015, False),
    "multi_chunk_600": (2, 600, 4, 0.015, False),
    "multi_chunk_1024": (2, 1024, 4, 0.015, False),
    "large_radius": (2, 64, 1, 0.25, False),
    "masked": (2, 96, 1, 0.015, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dense_forward_matches_jax(case):
    R, n, seed, scale, masked = CASES[case]
    params, cams = setup_batch(R=R, n=n, seed=seed, scale=scale)
    jpg = prep_batch(params, cams)
    tpg = t_prep(to_t(params), to_t(cams))
    if masked:
        mask = np.arange(n)[None, :] % 3 != 0
        jpg = jpg._replace(valid=jpg.valid & mask,
                           opacity=jnp.where(mask, jpg.opacity, 0.0))
        tm = torch.from_numpy(mask)
        tpg = tpg._replace(valid=tpg.valid & tm,
                           opacity=torch.where(tm, tpg.opacity, 0.0))
    out = t_dense(tpg).numpy()
    np.testing.assert_allclose(out, np.asarray(dense(jpg)), atol=1e-4)
    np.testing.assert_allclose(out, np.asarray(j_ref(jpg)), atol=1e-5)


@pytest.mark.parametrize("R,n,seed", [(2, 128, 1), (1, 600, 5)])
def test_dense_backward_matches_jax(R, n, seed):
    """The analytic backward against JAX's dense-kernel VJP (1e-4) and
    against autograd through the port's brute-force renderer (1e-5)."""
    params, cams = setup_batch(R=R, n=n, seed=seed)
    tgt = np.random.default_rng(0).uniform(
        0, 1, (R, 3, RES, RES)).astype(np.float32)

    def loss_dense(*p):
        return jnp.sum((dense(prep_batch(p, cams)) - tgt) ** 2)

    g_dense = jax.grad(loss_dense, argnums=tuple(range(5)))(*params)
    grads = []
    for render in (t_dense, t_reference):
        tp = to_t(params, grad=True)
        ((render(t_prep(tp, to_t(cams))) - torch.from_numpy(tgt)) ** 2) \
            .sum().backward()
        grads.append([t.grad.numpy() for t in tp])
    for i, nm in enumerate(["means", "opa", "scales", "rots", "shs"]):
        assert rel_err(g_dense[i], grads[0][i]) < 1e-4, nm
        assert rel_err(grads[1][i], grads[0][i]) < 1e-5, nm


def chunk_carry_inputs():
    """One render, N=600 (N_pad 1024, two 512-column chunks): transparent
    fillers at depth ranks 0-508, then three image-wide gaussians at ranks
    509-511 (alpha ~0.9, ~0.95, 0.99) that stop every pixel inside chunk 0
    with T frozen at ~5e-3, then alpha-0.5 gaussians from rank 512 on."""
    n = 600
    mean2d = np.full((1, n, 2), RES / 2, np.float32)
    conic = np.tile(np.asarray([1e-6, 0.0, 1e-6], np.float32), (1, n, 1))
    opacity = np.zeros((1, n), np.float32)
    opacity[0, 509:512] = [0.9, 0.95, 1.0]
    opacity[0, 512:] = 0.5
    rng = np.random.default_rng(7)
    color = rng.uniform(0, 1, (1, n, 3)).astype(np.float32)
    color[0, 512:] = [1.0, 0.0, 1.0]
    depth = np.arange(1, n + 1, dtype=np.float32)[None] * 0.01
    valid = np.ones((1, n), bool)
    return mean2d, conic, color, opacity, depth, valid


def test_chunk_carry_matches_jax_kernel_not_sequential_reference():
    """The JAX kernel carries the frozen T between 512-column chunks, so a
    pixel that stopped in chunk 0 takes alpha-0.5 gaussians again in chunk
    1; the sequential brute-force reference does not. The port follows the
    JAX kernel (ROADMAP.md section C records the difference)."""
    args = chunk_carry_inputs()
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    from unipre3d_tpu.ops.rasterizer.pallas_splat_dense import \
        rasterize_dense_batched as j_dense
    jax_img = np.asarray(j_dense(*map(jnp.asarray, args), bg, RES, RES))
    t_img = sd.rasterize_dense_batched(*to_t(args), torch.from_numpy(bg),
                                       RES, RES).numpy()
    one = [jnp.asarray(a[0]) for a in args]
    pg = ProjectedGaussians(*one[:5], radius=jnp.full((600,), 10 ** 4),
                            valid=one[5])
    seq = np.asarray(rasterize_projected_reference(pg, bg, RES, RES))
    np.testing.assert_allclose(t_img, jax_img, atol=1e-4)
    # the carried chunk adds ~5e-3 of magenta where the reference stops
    assert np.abs(t_img[0] - seq).max() > 2e-3
    assert (t_img[0, 0] - seq[0]).min() > 1e-3


def test_reference_renderer_matches_jax():
    params, cams = setup_batch(R=1, n=120, seed=2)
    p1 = [np.asarray(a)[0] for a in params]
    c1 = [np.asarray(c)[0] for c in cams]
    kw = dict(img_h=RES, img_w=RES, tanfovx=TANF, tanfovy=TANF, sh_degree=1)
    a = rasterize_reference(*map(jnp.asarray, p1), *map(jnp.asarray, c1),
                            bg_color=BG, **kw)
    b = trender.rasterize_reference(*to_t(p1), *to_t(c1),
                                    bg_color=np.array(BG), **kw)
    np.testing.assert_allclose(np.asarray(a["render"]), b["render"].numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(a["radii"]), b["radii"].numpy())


def test_cpu_tensors_take_the_plain_version_other_devices_raise():
    params, cams = setup_batch(R=1, n=40)
    tpg = t_prep(to_t(params), to_t(cams))
    before = (sd.DENSE_FWD.launches, sd.DENSE_BWD.launches)
    t_dense(tpg)
    assert (sd.DENSE_FWD.launches, sd.DENSE_BWD.launches) == before
    data = torch.zeros(1, 16, 128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sd.dense_fwd(data, torch.zeros(3, device="meta"), RES, RES)
    with pytest.raises(ValueError, match="multiple"):
        sd.chunk_of(640)


@pytest.mark.parametrize("case", CULL_CASES)
def test_tile_cull_twin_is_conservative(case):
    """Every (render, pixel, column) pair the plain walk does not skip
    (alpha != 0) is a survivor of the pixel's tile in the twin of the
    kernels' cull, so the culled kernels walk every pair that matters."""
    data, H, W = cull_case(case)
    surv = sd.tile_survivors_ref(data, H, W)            # [R, tiles, N_pad]
    px, py = sd._pixels(H, W, data.device)
    tile = (py.long() // sd.TILE) * (-(-W // sd.TILE)) + px.long() // sd.TILE
    live_cols = []
    for r in range(data.shape[0]):      # a render at a time: ~70 MB a walk
        _, _, cols = sd._walk(data[r:r + 1], px, py,
                              sd.chunk_of(data.shape[-1]), keep_columns=True)
        live = torch.stack([col[0][0] != 0 for col in cols], -1)  # [P, N]
        del cols
        assert bool((surv[r, tile, :] | ~live).all()), (case, r)
        live_cols.append(live.any(0))
    # the cull culls: padding columns always, and most real columns
    n_real = int((data[:, 5] > 0).sum(-1).max())
    assert not bool(surv[..., n_real:].any())
    assert float(surv.float().mean()) < 0.5
    if case == "corner_grazed":     # the level set straddles the corners
        grazed = torch.stack(live_cols) & (data[:, 5] > 0)
        assert 0 < int(grazed.sum()) < int((data[:, 5] > 0).sum())


def test_tile_cull_twin_drops_padding_keeps_undecidable_rows():
    """Opacity <= 0 drops on every tile; a row with a non-finite mean,
    conic or opacity, a conic that is not positive definite, or a huge
    magnitude is kept on every tile (the unculled walk decides it)."""
    data = torch.zeros(1, 16, 128)
    data[0, 2] = data[0, 4] = 1.0               # unit conic, mean (0, 0)
    data[0, 5, :8] = 0.5
    data[0, 0, 0] = float("nan")
    data[0, 3, 1] = float("inf")
    data[0, 5, 2] = float("nan")
    data[0, 3, 3] = 2.0                         # det < 0
    data[0, 0, 4] = 2e9                         # |mean| past 1e9
    data[0, 4, 5] = 1e19                        # |conic| past 1e18
    data[0, 0:2, 6] = 1000.0                    # far outside: dropped
    data[0, 5, 7] = -0.5                        # negative opacity: dropped
    surv = sd.tile_survivors_ref(data, 64, 48)
    assert surv.shape == (1, 12, 128)
    assert bool(surv[0, :, :6].all())
    assert not bool(surv[0, :, 6:].any())
    # a unit gaussian at the origin reaches only the first tile
    data[0, 0:2, 6] = 0.0
    surv = sd.tile_survivors_ref(data, 64, 48)
    assert surv[0, :, 6].nonzero().flatten().tolist() == [0]
