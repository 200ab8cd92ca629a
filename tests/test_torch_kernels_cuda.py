"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device (``cuda`` marker; the fixture skips without one) and
imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerances: images and T 1e-4 absolute (pixel values in [0, 1]); gradients
1e-4 relative to each row's largest, since the backward's atomic adds sum
the per-gaussian terms in an order that changes from run to run. The binned
and streaming kernels walk in the plain version's order with its
arithmetic: their log T is held bit for bit, and so are the dense kernels'
T and images at the edges of their per-tile cull.
The selective-scan pair: the forward within 1e-5 of max |y| and each
gradient within 1e-4 relative to its largest entry (sums over D, or over
batch and time, in another order than autograd's); at the mixer's bf16
strided operands, each gradient in its input's dtype and held beyond its
rounding into bf16 (half an ulp), and the backward bit for bit across two
launches.
One full-width PTv3 forward and backward (``ptv3_pretraining``, default
run) on the binned route: each binned kernel launches once, the loss and
every gradient are finite.
chip_smoke.py holds the same kernels at the main path's full shapes.
"""

import math

import numpy as np
import pytest
import torch

from unipre3d_tpu_torch.ops import scan as sc
from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb
from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd
from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
from unipre3d_tpu_torch.ops.rasterizer.preprocess import ProjectedGaussians


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def gaussians(R, N, H, W, seed):
    """Random screen-space gaussians (numpy seed): mean2d, conic, color,
    opacity, depth, valid, each [R, N, ...]."""
    rng = np.random.default_rng(seed)
    mean2d = rng.uniform(-0.1, 1.1, (R, N, 2)) * [W, H]
    sig = np.exp(rng.uniform(math.log(0.5), math.log(max(H, W) / 3.0),
                             (R, N, 2)))
    th = rng.uniform(0, math.pi, (R, N))
    c, s = np.cos(th), np.sin(th)
    sxx = (c * sig[..., 0]) ** 2 + (s * sig[..., 1]) ** 2 + 0.3
    syy = (s * sig[..., 0]) ** 2 + (c * sig[..., 1]) ** 2 + 0.3
    sxy = c * s * (sig[..., 0] ** 2 - sig[..., 1] ** 2)
    det = sxx * syy - sxy * sxy
    conic = np.stack([syy / det, -sxy / det, sxx / det], -1)
    opacity = np.where(rng.uniform(size=(R, N)) < 0.1, 1.0,
                       rng.uniform(0.2, 0.99, (R, N)))
    color = rng.uniform(0, 1, (R, N, 3))
    depth = rng.uniform(0.5, 1.5, (R, N))
    valid = rng.uniform(size=(R, N)) > 0.1
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    return (f(mean2d), f(conic), f(color), f(opacity), f(depth),
            torch.tensor(valid))


def rel_err(ref, got):
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-12))


def edge_gaussians(name, H, W, cell=(16, 16), R=4, N=128):
    """Gaussians built to meet the edges of the kernels' cull (numpy
    seeded by ``name``): mean2d, conic, color, opacity, depth and the
    3-sigma radius (the preprocess' formula), each [R, N, ...] float32.
    Kinds: thin rotated ellipses (large |B|), opacity 1 (the 0.99 cap),
    sub-pixel sigmas, centres outside the image, and isotropic gaussians
    whose 1/255 level set grazes a corner pixel of a ``cell`` (the dense
    kernels' 16x16 tile, the binned kernels' 8x4 (x, y) warp patch, the
    streaming kernels' 8x8) from outside, the radius jittered by +-1e-4."""
    rng = np.random.default_rng(sum(map(ord, name)))
    mean2d = rng.uniform(-8, W + 8, (R, N, 2))
    sig = np.exp(rng.uniform(np.log(0.7), np.log(20.0), (R, N, 2)))
    th = rng.uniform(0, np.pi, (R, N))
    opacity = rng.uniform(0.02, 0.99, (R, N))
    if name == "thin_rotated":        # condition number up to ~1e5: |B| large
        sig[..., 0] = np.exp(rng.uniform(np.log(0.1), np.log(0.5), (R, N)))
        sig[..., 1] = np.exp(rng.uniform(np.log(10.0), np.log(60.0), (R, N)))
    elif name == "opacity_one":       # alpha at the 0.99 cap
        opacity[:] = 1.0
    elif name == "sub_pixel":
        sig = np.exp(rng.uniform(np.log(0.05), np.log(0.6), (R, N, 2)))
    elif name == "centres_outside":
        side = rng.integers(0, 4, (R, N))
        off = rng.uniform(1, 60, (R, N))
        mean2d[..., 0] = np.where(side == 0, -off, np.where(
            side == 1, W - 1 + off, mean2d[..., 0]))
        mean2d[..., 1] = np.where(side == 2, -off, np.where(
            side == 3, H - 1 + off, mean2d[..., 1]))
        sig = sig * 2
    c, s = np.cos(th), np.sin(th)
    sxx = (c * sig[..., 0]) ** 2 + (s * sig[..., 1]) ** 2
    syy = (s * sig[..., 0]) ** 2 + (c * sig[..., 1]) ** 2
    sxy = c * s * (sig[..., 0] ** 2 - sig[..., 1] ** 2)
    if name == "corner_grazed":
        # isotropic, the 1/255 level set through a cell's corner pixel
        # (x, y) from outside the cell, the radius jittered by +-1e-4
        sxx = syy = sig[..., 0] ** 2
        sxy = np.zeros_like(sxx)
        cell = np.asarray(cell)
        corner = rng.integers(1, 7, (R, N, 2)) * cell + rng.integers(
            0, 2, (R, N, 2)) * (cell - 1) - cell
        ang = rng.uniform(0.05, np.pi / 2 - 0.05, (R, N))
        sgn = np.where(corner % cell == cell - 1, 1.0, -1.0)
        rad = sig[..., 0] * np.sqrt(2 * np.log(255 * opacity)) \
            * (1 + rng.uniform(-1e-4, 1e-4, (R, N)))
        mean2d = corner + sgn * np.stack([np.cos(ang), np.sin(ang)], -1) \
            * rad[..., None]
    det = sxx * syy - sxy * sxy
    conic = np.stack([syy / det, -sxy / det, sxx / det], -1)
    mid = 0.5 * (sxx + syy)
    radius = np.ceil(3.0 * np.sqrt(
        mid + np.sqrt(np.maximum(mid * mid - det, 0.1))))
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    color = rng.uniform(0, 1, (R, N, 3))
    depth = rng.uniform(0.5, 1.5, (R, N))
    return (f(mean2d), f(conic), f(color), f(opacity), f(depth),
            f(radius))


def cull_case(name):
    """Tables [R,16,N_pad] + image size for the dense kernels' cull: the
    kernel tests' random gaussians (chip_smoke.py's random_gaussians in
    numpy) and cases built to meet the cull's edges (``edge_gaussians``)."""
    H = W = 128
    if name in ("random", "multi_chunk_600"):
        R, N = (4, 128) if name == "random" else (2, 600)
        H = W = 128 if name == "random" else 64
        return sd.sorted_table(*gaussians(R, N, H, W, seed=11)), H, W
    mean2d, conic, color, opacity, depth, _ = edge_gaussians(name, H, W)
    return sd.sorted_table(mean2d, conic, color, opacity, depth,
                           torch.ones(opacity.shape, dtype=torch.bool)), H, W


CULL_CASES = ["random", "thin_rotated", "opacity_one", "sub_pixel",
              "centres_outside", "corner_grazed", "multi_chunk_600"]


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", [(4, 128), (2, 1000), (1, 4096)])
def test_kernels_match_plain_versions(cuda, R, N):
    H = W = 48          # not a multiple of the 16-pixel tile in flat order
    data = sd.sorted_table(*gaussians(R, N, H, W, seed=N)).to(cuda)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    g_out = torch.randn(R, 3, H * W, device=cuda)
    out, tfin = sd.dense_fwd(data, bg, H, W)
    dgrad, dbg = sd.dense_bwd(data, bg, out, tfin, g_out, H, W)
    out_r, tfin_r = sd.dense_splat_fwd_ref(data, bg, H, W)
    dgrad_r, dbg_r = sd.dense_splat_bwd_ref(data, bg, tfin_r, g_out, H, W)
    torch.cuda.synchronize()
    assert float((out - out_r).abs().max()) < 1e-4
    assert float((tfin - tfin_r).abs().max()) < 1e-4
    for k in range(9):
        assert rel_err(dgrad_r[:, k], dgrad[:, k]) < 1e-4, k
    assert float(dgrad[:, 9:].abs().max()) == 0.0
    assert rel_err(dbg_r, dbg) < 1e-4



@pytest.mark.cuda
def test_kernels_match_plain_versions_at_the_cull_edges(cuda):
    """The edge cases of the dense kernels' per-tile cull (``cull_case``,
    two renders each at 128x128): T and images bit for bit, since the cull
    drops only pairs the walk skips at every pixel of the tile."""
    data = torch.cat([cull_case(name)[0][:2] for name in CULL_CASES
                      if name != "multi_chunk_600"]).to(cuda)
    R, H, W = data.shape[0], 128, 128
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    g_out = torch.randn(R, 3, H * W, device=cuda)
    out, tfin = sd.dense_fwd(data, bg, H, W)
    dgrad, dbg = sd.dense_bwd(data, bg, out, tfin, g_out, H, W)
    out_r, tfin_r = sd.dense_splat_fwd_ref(data, bg, H, W)
    dgrad_r, _ = sd.dense_splat_bwd_ref(data, bg, tfin_r, g_out, H, W)
    torch.cuda.synchronize()
    assert int((tfin != tfin_r).sum()) == 0
    assert int((out != out_r).sum()) == 0
    for k in range(9):
        assert rel_err(dgrad_r[:, k], dgrad[:, k]) < 1e-4, k

@pytest.mark.cuda
def test_autograd_function_launches_each_kernel_once(cuda):
    """One forward and one backward launch per call, and the same
    gradients as the CPU path (the plain versions)."""
    H = W = 32
    grads = []
    for dev in ("cpu", cuda):
        ins = [t.to(dev) for t in gaussians(3, 200, H, W, seed=1)]
        for t in ins[:4]:
            t.requires_grad_(True)
        before = (sd.DENSE_FWD.launches, sd.DENSE_BWD.launches)
        img = sd.rasterize_dense_batched(*ins, [0.1, 0.2, 0.3], H, W)
        (img * torch.linspace(-1, 1, img.numel(), device=dev)
         .reshape(img.shape)).sum().backward()
        launched = (sd.DENSE_FWD.launches - before[0],
                    sd.DENSE_BWD.launches - before[1])
        assert launched == ((1, 1) if dev == cuda else (0, 0))
        grads.append([img.detach().cpu()] + [t.grad.cpu() for t in ins[:4]])
    assert float((grads[0][0] - grads[1][0]).abs().max()) < 1e-4
    for a, b in zip(grads[0][1:], grads[1][1:]):
        assert rel_err(a, b) < 1e-4


@pytest.mark.cuda
def test_kernels_keep_the_chunk_carry(cuda):
    """A pixel saturated inside the first 512-column chunk re-enters the
    next chunk at its frozen T (the JAX kernel's behaviour, pinned against
    JAX for the plain version in tests/test_torch_splat.py)."""
    n, H, W = 600, 32, 32
    mean2d = torch.full((1, n, 2), 16.0)
    conic = torch.tensor([1e-6, 0.0, 1e-6]).expand(1, n, 3).contiguous()
    opacity = torch.zeros(1, n)
    opacity[0, 509:512] = torch.tensor([0.9, 0.95, 1.0])
    opacity[0, 512:] = 0.5
    color = torch.rand(1, n, 3, generator=torch.Generator().manual_seed(7))
    color[0, 512:] = torch.tensor([1.0, 0.0, 1.0])
    depth = torch.arange(1, n + 1, dtype=torch.float32)[None] * 0.01
    valid = torch.ones(1, n, dtype=torch.bool)
    data = sd.sorted_table(mean2d, conic, color, opacity, depth,
                           valid).to(cuda)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    out, tfin = sd.dense_fwd(data, bg, H, W)
    out_r, tfin_r = sd.dense_splat_fwd_ref(data, bg, H, W)
    assert float((out - out_r).abs().max()) < 1e-4
    assert torch.equal(tfin, tfin_r)
    # chunk 0 stops every pixel at T ~5e-3; the carried chunk takes five
    # alpha-0.5 gaussians more, down to T ~1.6e-4
    assert 1e-4 < float(tfin.min()) and float(tfin.max()) < 2e-4


def binned_inputs(R, N, H, W, seed, device, tile=(8, 32)):
    """Random screen-space gaussians with their 3-sigma radius, as the
    binned splat takes them, on ``device``."""
    mean2d, conic, color, opacity, depth, valid = gaussians(R, N, H, W, seed)
    a, b, c = conic.unbind(-1)
    det = 1.0 / (a * c - b * b)                 # determinant of the covariance
    mid = 0.5 * (a + c) * det
    radius = torch.ceil(3.0 * torch.sqrt(
        mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))))
    return [t.to(device) for t in (mean2d, conic, color, opacity, depth,
                                   radius, valid)]


def binned_cull_case(name):
    """Inputs of the binned splat built to meet the edges of its per-warp
    cull: (mean2d, conic, color, opacity, depth, radius, valid) [R, N, ...],
    H, W, tile_h, tile_w. At the scene's 120x160 with 8x32 tiles (4x8 warp
    patches): random gaussians and the edge kinds of ``edge_gaussians``
    grazing patch corners; a tile list past 1024 duplicates (the re-arm,
    16x16 tiles); 32x4 tiles, whose warps own 32 pixels in row-major order
    (8 rows of 4)."""
    if name == "random":
        return binned_inputs(2, 2000, 120, 160, seed=12, device="cpu"), \
            120, 160, 8, 32
    if name == "rearm":
        return binned_inputs(1, 3000, 32, 32, seed=13, device="cpu"), \
            32, 32, 16, 16
    if name == "rows":
        return binned_inputs(1, 400, 32, 36, seed=14, device="cpu"), \
            32, 36, 32, 4
    ins = edge_gaussians(name, 120, 160, cell=(8, 4), R=2, N=256)
    return [*ins, torch.ones(ins[3].shape, dtype=torch.bool)], 120, 160, 8, 32


BINNED_CULL_CASES = ["random", "thin_rotated", "opacity_one", "sub_pixel",
                     "centres_outside", "corner_grazed", "rearm", "rows"]


def binned_prep(ins, H, W, th, tw, budget=None):
    """The sorted duplicate list and table of binned inputs."""
    N = ins[0].shape[1]
    budget = budget or sb.default_dup_budget(N, (H // th) * (W // tw))
    dup = sb.prep_duplicates(ins[0], ins[5], ins[4], ins[6], H, W, th, tw,
                             budget)
    return dup, sb.gaussian_rows(*ins[:4], ins[6])[dup.gid].t().contiguous()


def check_binned_kernels(dup, table, R, H, W, th, tw, cap, device):
    """Both binned kernels against their plain versions: T and the images
    bit for bit, gradient rows to 1e-4 relative."""
    bg = torch.tensor([0.1, 0.2, 0.3], device=device)
    g_out = torch.randn(R, 3, H, W, device=device)
    args = (R, H, W, th, tw, cap)
    out, logt = sb.binned_fwd(dup.seg, table, bg, *args)
    tot = (g_out * (out - bg.reshape(1, 3, 1, 1)
                    * torch.exp(logt)[:, None])).sum(1)
    dgrad = sb.binned_bwd(dup.seg, table, bg, logt, tot, g_out, *args)
    out_r, logt_r = sb.binned_fwd_ref(dup.seg, table, bg, *args)
    dgrad_r = sb.binned_bwd_ref(dup.seg, table, bg, logt_r, tot, g_out, *args)
    torch.cuda.synchronize()
    assert torch.equal(out, out_r)
    assert torch.equal(logt, logt_r)
    for k in range(9):
        assert rel_err(dgrad_r[k], dgrad[k]) < 1e-4, k


@pytest.mark.cuda
@pytest.mark.parametrize("case", BINNED_CULL_CASES)
def test_binned_kernels_match_plain_versions_at_the_cull_edges(cuda, case):
    """The edge cases of the binned kernels' per-warp cull
    (``binned_cull_case``): T and images bit for bit, since the cull drops
    only pairs the walk skips at every pixel of the warp's patch."""
    ins, H, W, th, tw = binned_cull_case(case)
    dup, table = binned_prep([t.to(cuda) for t in ins], H, W, th, tw)
    check_binned_kernels(dup, table, ins[0].shape[0], H, W, th, tw, 4096,
                         cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,H,W,cap,budget", [
    (2, 4000, 64, 64, 4096, None),      # lists past 1024: chunk re-arm
    (1, 3000, 64, 64, 1024, None),      # tiles cut at the cap
    (2, 2000, 48, 64, 4096, 4096)])     # duplicate budget overflow
def test_binned_kernels_match_plain_versions(cuda, R, N, H, W, cap, budget):
    ins = binned_inputs(R, N, H, W, seed=N + R, device=cuda)
    th, tw = 8, 32
    dup, table = binned_prep(ins, H, W, th, tw, budget)
    if budget == 4096:
        assert int(dup.span_sum.sum()) > dup.gid.shape[0]
    else:
        assert int((dup.seg[1:] - dup.seg[:-1]).max()) > 1024
    check_binned_kernels(dup, table, R, H, W, th, tw, cap, cuda)


@pytest.mark.cuda
def test_binned_autograd_function_launches_each_kernel_once(cuda):
    """One launch each way per call for all renders, the CPU path's
    gradients, and exactly 0 where the CPU path has 0 (gaussians that no
    tile composites, past the cap of 1024)."""
    H, W = 64, 64
    grads = []
    for dev in ("cpu", cuda):
        ins = binned_inputs(2, 4000, H, W, seed=9, device=dev)
        for t in ins[:4]:
            t.requires_grad_(True)
        before = (sb.BINNED_FWD.launches, sb.BINNED_BWD.launches)
        stats = {}
        img = sb.rasterize_projected_binned(*ins, [0.1, 0.2, 0.3], H, W, 8,
                                            32, max_per_tile=1024, stats=stats)
        (img * torch.linspace(-1, 1, img.numel(), device=dev)
         .reshape(img.shape)).sum().backward()
        launched = (sb.BINNED_FWD.launches - before[0],
                    sb.BINNED_BWD.launches - before[1])
        assert launched == ((1, 1) if dev == cuda else (0, 0))
        assert int(stats["cap_dropped"]) > 0
        grads.append([img.detach().cpu()] + [t.grad.cpu() for t in ins[:4]])
    assert float((grads[0][0] - grads[1][0]).abs().max()) < 1e-4
    for a, b in zip(grads[0][1:], grads[1][1:]):
        assert torch.isfinite(b).all()
        assert rel_err(a, b) < 1e-4
        assert bool((b[a == 0] == 0).all())     # dropped: exactly 0


def stream_case(R, N, H, W, tile, seed, device):
    """Random gaussians (binned_inputs) depth-sorted into the stream
    table, with their chunk bitmap at ``tile`` tiles."""
    ins = binned_inputs(R, N, H, W, seed, device)
    return ss.stream_inputs(ProjectedGaussians(*ins), H, W, *tile)[:2]


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,H,W,tile", [
    (2, 1300, 64, 64, (32, 32)),     # four CTAs a tile, three chunks
    (1, 3000, 48, 64, (8, 32)),      # the scene's tile, six chunks
    (3, 100, 32, 32, (16, 16))])     # one partly filled chunk
def test_stream_kernels_match_plain_versions(cuda, R, N, H, W, tile):
    table, flags = stream_case(R, N, H, W, tile, seed=N + R, device=cuda)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    g_out = torch.randn(R, 3, H, W, device=cuda)
    out, logt = ss.stream_fwd(table, flags, bg, H, W, *tile)
    tot = (g_out * (out - bg.reshape(1, 3, 1, 1)
                    * torch.exp(logt)[:, None])).sum(1)
    dgrad = ss.stream_bwd(table, flags, bg, logt, tot, g_out, H, W, *tile)
    out_r, logt_r = ss.stream_fwd_ref(table, flags, bg, H, W, *tile)
    dgrad_r = ss.stream_bwd_ref(table, flags, bg, logt_r, tot, g_out, H, W,
                                *tile)
    torch.cuda.synchronize()
    assert float((out - out_r).abs().max()) < 1e-4
    assert torch.equal(logt, logt_r)
    for k in range(9):
        assert rel_err(dgrad_r[:, k], dgrad[:, k]) < 1e-4, k
    assert float(dgrad[:, 9:].abs().max()) == 0.0


@pytest.mark.cuda
def test_stream_autograd_function_launches_each_kernel_once(cuda):
    """One launch each way per call for all renders, and the CPU path's
    image and gradients (w.r.t. mean2d, conic, color, opacity, bg)."""
    H, W = 64, 64
    grads = []
    for dev in ("cpu", cuda):
        ins = binned_inputs(2, 1200, H, W, seed=3, device=dev)
        for t in ins[:4]:
            t.requires_grad_(True)
        bg = torch.tensor([0.1, 0.2, 0.3], device=dev, requires_grad=True)
        before = (ss.STREAM_FWD.launches, ss.STREAM_BWD.launches)
        img = ss.rasterize_projected_stream(ProjectedGaussians(*ins), bg, H,
                                            W, 32, 32)
        (img * torch.linspace(-1, 1, img.numel(), device=dev)
         .reshape(img.shape)).sum().backward()
        launched = (ss.STREAM_FWD.launches - before[0],
                    ss.STREAM_BWD.launches - before[1])
        assert launched == ((1, 1) if dev == cuda else (0, 0))
        grads.append([img.detach().cpu()] +
                     [t.grad.cpu() for t in ins[:4]] + [bg.grad.cpu()])
    assert float((grads[0][0] - grads[1][0]).abs().max()) < 1e-4
    for a, b in zip(grads[0][1:], grads[1][1:]):
        assert rel_err(a, b) < 1e-4


@pytest.mark.cuda
def test_stream_kernels_rearm_at_512(cuda):
    """Every pixel stops inside chunk 0 and re-enters chunk 1 at its last
    contributing T (tests/test_torch_splat_stream.py pins the plain version
    against JAX)."""
    n, H, W = 600, 32, 32
    opacity = torch.zeros(1, n)
    opacity[0, 509:512] = torch.tensor([0.9, 0.95, 1.0])
    opacity[0, 512:] = 0.5
    pg = ProjectedGaussians(
        torch.full((1, n, 2), 16.0),
        torch.tensor([1e-6, 0.0, 1e-6]).expand(1, n, 3).contiguous(),
        torch.rand(1, n, 3, generator=torch.Generator().manual_seed(7)),
        opacity, torch.arange(1, n + 1, dtype=torch.float32)[None] * 0.01,
        torch.full((1, n), 3001, dtype=torch.int32),
        torch.ones(1, n, dtype=torch.bool))
    table, flags, _ = ss.stream_inputs(
        ProjectedGaussians(*(t.to(cuda) for t in pg)), H, W, 8, 8)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    out, logt = ss.stream_fwd(table, flags, bg, H, W, 8, 8)
    out_r, logt_r = ss.stream_fwd_ref(table, flags, bg, H, W, 8, 8)
    assert float((out - out_r).abs().max()) < 1e-4
    assert torch.equal(logt, logt_r)
    T = torch.exp(logt)
    assert 1e-4 < float(T.min()) and float(T.max()) < 2e-4


def stream_cull_case(name):
    """Projected gaussians (ProjectedGaussians [R, N, ...], on the CPU)
    built to meet the edges of the streaming kernels' per-warp cull, with
    H, W, tile_h, tile_w. At the scene's 120x160 with 8x32 tiles (8x8 warp
    patches): random gaussians and the edge kinds of ``edge_gaussians``
    grazing patch corners, over two chunks; ``rearm``: broad gaussians at
    64x64 with 32x32 tiles (16 patches a tile), pixels stopping inside a
    chunk and re-armed at the next; ``outside_bbox``: a broad gaussian left
    of a 64x64 image whose 3-sigma bbox ends in tile column 0, composited in
    column 1 because small gaussians of its chunk flag that column;
    ``rows``: 12x12 tiles, whose warps own rows of 64 pixels (the last one
    partly outside the tile)."""
    def pg_of(ins):
        return ProjectedGaussians(*ins[:5], ins[5].to(torch.int32), ins[6])
    if name == "random":
        return pg_of(binned_inputs(2, 1000, 120, 160, seed=16,
                                   device="cpu")), 120, 160, 8, 32
    if name == "rearm":
        g = torch.Generator().manual_seed(18)
        n = 1400
        var = (6.0 + 14.0 * torch.rand(1, n, generator=g)) ** 2 + 0.3
        mean2d = torch.rand(1, n, 2, generator=g) * 64.0
        opa = 0.3 + 0.6 * torch.rand(1, n, generator=g)
        return stream_screen_case(mean2d, var, opa, g), 64, 64, 32, 32
    if name == "outside_bbox":
        g = torch.Generator().manual_seed(19)
        n = 512
        mean2d = torch.stack([40.0 + 22.0 * torch.rand(n, generator=g),
                              2.0 + 60.0 * torch.rand(n, generator=g)], -1)
        mean2d[0] = torch.tensor([-30.0, 32.0])
        var = torch.full((n,), 0.25 + 0.3)
        var[0] = 400.0 + 0.3                  # bbox: x in [-91, 31]
        opa = 0.2 + 0.4 * torch.rand(n, generator=g)
        opa[0] = 0.9
        return stream_screen_case(mean2d[None], var[None], opa[None], g), \
            64, 64, 32, 32
    if name == "rows":
        return pg_of(binned_inputs(1, 700, 36, 48, seed=17,
                                   device="cpu")), 36, 48, 12, 12
    ins = edge_gaussians(name, 120, 160, cell=(ss.PATCH, ss.PATCH), R=2,
                         N=600)
    return pg_of([*ins, torch.ones(ins[3].shape, dtype=torch.bool)]), \
        120, 160, 8, 32


def stream_screen_case(mean2d, var, opacity, g):
    """Isotropic screen-space gaussians [1, n] of variance ``var`` (blur
    included) in depth order, all valid, the 3-sigma radius as the
    preprocess gives it."""
    n = var.shape[1]
    zero = torch.zeros_like(var)
    conic = torch.stack([1 / var, zero, 1 / var], -1)
    radius = torch.ceil(3 * torch.sqrt(var + math.sqrt(0.1)))
    return ProjectedGaussians(
        mean2d, conic, torch.rand(1, n, 3, generator=g), opacity,
        1.0 + 1e-3 * torch.arange(n, dtype=torch.float32)[None],
        radius.to(torch.int32), torch.ones(1, n, dtype=torch.bool))


STREAM_CULL_CASES = ["random", "thin_rotated", "opacity_one", "sub_pixel",
                     "centres_outside", "corner_grazed", "rearm",
                     "outside_bbox", "rows"]


@pytest.mark.cuda
def test_stream_kernels_match_plain_versions_at_the_cull_edges(cuda):
    """The edge cases of the streaming kernels' per-warp cull
    (``stream_cull_case``): T and images bit for bit, since the cull drops
    only pairs the walk skips at every pixel of the warp's patch; the
    gradient rows to 1e-4 relative."""
    for case in STREAM_CULL_CASES:
        pg, H, W, th, tw = stream_cull_case(case)
        table, flags, _ = ss.stream_inputs(
            ProjectedGaussians(*(t.to(cuda) for t in pg)), H, W, th, tw)
        R = table.shape[0]
        bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
        g_out = torch.randn(R, 3, H, W, device=cuda)
        out, logt = ss.stream_fwd(table, flags, bg, H, W, th, tw)
        tot = (g_out * (out - bg.reshape(1, 3, 1, 1)
                        * torch.exp(logt)[:, None])).sum(1)
        dgrad = ss.stream_bwd(table, flags, bg, logt, tot, g_out, H, W, th,
                              tw)
        out_r, logt_r = ss.stream_fwd_ref(table, flags, bg, H, W, th, tw)
        dgrad_r = ss.stream_bwd_ref(table, flags, bg, logt_r, tot, g_out, H,
                                    W, th, tw)
        torch.cuda.synchronize()
        assert torch.equal(logt, logt_r), case
        assert torch.equal(out, out_r), case
        for k in range(9):
            assert rel_err(dgrad_r[:, k], dgrad[:, k]) < 1e-4, (case, k)


def scan_inputs(Bsz, L, D, seed, device, full=True):
    """Mamba-like scan inputs (numpy seed): u, delta, A, B, C, D, z, bias;
    D, z and bias None unless ``full``. ``full`` deltas go through the
    softplus (the mixer's), the others are taken as they are: positive, so
    that exp(delta A) decays."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    u = f(rng.normal(size=(Bsz, L, D)))
    delta = f(rng.normal(-1.0, 1.0, (Bsz, L, D)) if full
              else rng.uniform(1e-3, 0.2, (Bsz, L, D)))
    A = f(-np.exp(rng.uniform(0, np.log(16), (D, sc.SCAN_N))))
    Bm = f(rng.normal(size=(Bsz, L, sc.SCAN_N)))
    Cm = f(rng.normal(size=(Bsz, L, sc.SCAN_N)))
    if not full:
        return u, delta, A, Bm, Cm, None, None, None
    return (u, delta, A, Bm, Cm, f(rng.normal(size=D)),
            f(rng.normal(size=(Bsz, L, D))), f(rng.normal(-2, 0.5, D)))


@pytest.mark.cuda
@pytest.mark.parametrize("Bsz,L,D,full,softplus", [
    (2, 1, 32, True, True), (2, 17, 32, True, True), (3, 129, 64, True, True),
    (2, 40, 48, False, False), (2, 40, 48, False, True),
    (1, 76, 1536, True, True)])
def test_scan_kernels_match_plain_version(cuda, Bsz, L, D, full, softplus):
    ins = [t if t is None else t.requires_grad_(True)
           for t in scan_inputs(Bsz, L, D, L + D, cuda, full)]
    g = torch.randn(Bsz, L, D, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))
    n0, n1 = sc.SCAN_FWD.launches, sc.SCAN_BWD.launches
    y = sc.selective_scan(*ins, delta_softplus=softplus)
    grads = torch.autograd.grad(y, [t for t in ins if t is not None], g)
    assert (sc.SCAN_FWD.launches - n0, sc.SCAN_BWD.launches - n1) == (1, 1)
    y_r = sc.selective_scan_ref(*ins, delta_softplus=softplus)
    grads_r = torch.autograd.grad(y_r, [t for t in ins if t is not None], g)
    torch.cuda.synchronize()
    assert torch.isfinite(y_r).all()
    assert rel_err(y_r.detach(), y.detach()) < 1e-5
    for a, b in zip(grads_r, grads):
        assert rel_err(a, b) < 1e-4


def beyond_rounding_err(ref, got):
    """max |got - ref| beyond half an ulp of got's dtype (a bfloat16
    gradient is the float32 one rounded as .to(torch.bfloat16)), over
    max |ref|."""
    diff = (got.float() - ref.float()).abs()
    if got.dtype == torch.bfloat16:
        _, ex = torch.frexp(got.float())
        half_ulp = torch.where(got == 0, 0.0, torch.ldexp(
            torch.ones_like(diff), ex - 9))
        diff = (diff - half_ulp).clamp_min(0.0)
    return float(diff.max() / (ref.float().abs().max() + 1e-12))


def mixer_layout(ins, rank):
    """The default run's layout of the mixer's scan inputs: u float32;
    delta bfloat16; B, C bfloat16 views of one [Bsz, L, rank + 32] tensor
    (x_proj's output); z a bfloat16 view of one [Bsz, L, 2 D] tensor
    (in_proj's output)."""
    u, delta, A, Bm, Cm, Dv, z, bias = ins
    n = sc.SCAN_N
    xp = torch.cat([torch.randn(*u.shape[:2], rank, device=u.device), Bm, Cm],
                   -1).to(torch.bfloat16)
    zx = torch.cat([u, z], -1).to(torch.bfloat16)
    return [u, delta.to(torch.bfloat16), A, xp[..., rank:rank + n],
            xp[..., rank + n:], Dv, zx[..., u.shape[-1]:], bias]


@pytest.mark.cuda
@pytest.mark.parametrize("Bsz,L,D,layout", [
    (2, 7, 96, "float32"), (2, 9, 96, "mixer"), (2, 15, 96, "float32"),
    (2, 17, 96, "float32"), (2, 31, 96, "mixer"), (2, 33, 96, "mixer"),
    (3, 129, 64, "mixer"), (2, 40, 48, "mixer")])
def test_scan_kernels_take_the_mixer_layout(cuda, Bsz, L, D, layout):
    """L one step either side of a backward segment (8 steps), a forward
    tile (16) and two tiles, D = 96 (a backward CTA of 64 channels and a
    masked half), and the mixer's bf16 strided views:
    read in place (no launch but the kernels'), each gradient in its
    input's dtype, held to the plain version on float32 copies of the same
    values at 1e-5 / 1e-4 beyond the rounding into bfloat16."""
    ins = list(scan_inputs(Bsz, L, D, L + D, cuda, True))
    if layout == "mixer":
        ins = mixer_layout(ins, 24)
        assert all(sc.in_place(t) for t in (ins[1], ins[3], ins[4], ins[6]))
        assert not ins[3].is_contiguous() and not ins[6].is_contiguous()
    ins = [t.detach().requires_grad_(True) for t in ins]
    g = torch.randn(Bsz, L, D, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    n0, n1 = sc.SCAN_FWD.launches, sc.SCAN_BWD.launches
    y = sc.selective_scan(*ins, delta_softplus=True)
    grads = torch.autograd.grad(y, ins, g)
    assert (sc.SCAN_FWD.launches - n0, sc.SCAN_BWD.launches - n1) == (1, 1)
    assert [a.dtype for a in grads] == [t.dtype for t in ins]
    leaves = [t.detach().float().requires_grad_(True) for t in ins]
    y_r = sc.selective_scan_ref(*leaves, delta_softplus=True)
    grads_r = torch.autograd.grad(y_r, leaves, g)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32
    assert rel_err(y_r.detach(), y.detach()) < 1e-5
    for a, b in zip(grads_r, grads):
        assert beyond_rounding_err(a, b) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["float32", "mixer"])
def test_scan_backward_is_deterministic(cuda, layout):
    """Two backward launches on the same inputs give the same bits: the
    partial sums are reduced in a fixed order, without float atomics."""
    ins = list(scan_inputs(4, 129, 768, 5, cuda, True))
    if layout == "mixer":
        ins = mixer_layout(ins, 24)
    g = torch.randn(4, 129, 768, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2))
    _, chk = sc.scan_fwd(*ins, True, keep_states=True)
    first = sc.scan_bwd(*ins, True, g, chk)
    second = sc.scan_bwd(*ins, True, g, chk)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ptv3_full_width_step_launches_the_binned_pair(cuda):
    """One full-width ``ptv3_pretraining`` forward and backward on the card
    (80,000 + 4,096 rows, 8 + 8 views at 160x120, the default bf16 compute
    dtype, DropPath and the order shuffle drawn from a seeded generator) on
    the binned route: each binned kernel launches once, and the loss and
    every parameter's gradient are finite."""
    from unipre3d_tpu_torch.data import (SyntheticSceneDataset, batch_to,
                                         collate)
    from unipre3d_tpu_torch.training import trainer
    from unipre3d_tpu_torch.training.config import load_config
    cfg = load_config("ptv3_pretraining", overrides=[
        "opt.batch_size=1", "data.pts_dataset_root=synthetic",
        "tpu.raster_impl_train=pallas_binned"])
    batch = batch_to(collate([SyntheticSceneDataset(
        cfg, num_scenes=1, seed=0, device=cuda)[0]]), cuda)
    model, state = trainer.create_train_state(
        cfg, device=cuda, seed=0, dtype=trainer.compute_dtype_of(cfg))
    batch["geometry"] = trainer.make_geometry_fn(cfg, model)(batch)
    assert batch["geometry"].fine_mask.shape == (1, 84096)
    n_in = int(cfg.data.input_images)
    before = (sb.BINNED_FWD.launches, sb.BINNED_BWD.launches)
    model.train()
    g = trainer.predict(model, batch, n_in, state.generator)
    bg = trainer.bg_color_of(cfg)
    loss, _ = trainer.compute_loss(
        trainer.render_supervision_views(g, batch, cfg, bg),
        batch["gt_images"][:, n_in:], cfg, bg)
    loss.backward()
    assert (sb.BINNED_FWD.launches - before[0],
            sb.BINNED_BWD.launches - before[1]) == (1, 1)
    assert math.isfinite(float(loss.detach()))
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    assert len(grads) > 400
    for n, gr in grads.items():
        assert bool(torch.isfinite(gr).all()), n
