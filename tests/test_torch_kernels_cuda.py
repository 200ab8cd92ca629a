"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device (``cuda`` marker; the fixture skips without one) and
imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerances: images and T 1e-4 absolute (pixel values in [0, 1]); gradients
1e-4 relative to each row's largest, since the backward's atomic adds sum
the per-gaussian terms in an order that changes from run to run. The binned
kernels walk in the plain version's order with its arithmetic: their log T
is held bit for bit.
chip_smoke.py holds the same kernels at the main path's full shapes.
"""

import math

import numpy as np
import pytest
import torch

from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb
from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd


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


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,H,W,cap,budget", [
    (2, 4000, 64, 64, 4096, None),      # lists past 1024: chunk re-arm
    (1, 3000, 64, 64, 1024, None),      # tiles cut at the cap
    (2, 2000, 48, 64, 4096, 4096)])     # duplicate budget overflow
def test_binned_kernels_match_plain_versions(cuda, R, N, H, W, cap, budget):
    ins = binned_inputs(R, N, H, W, seed=N + R, device=cuda)
    th, tw = 8, 32
    budget = budget or sb.default_dup_budget(N, (H // th) * (W // tw))
    dup = sb.prep_duplicates(ins[0], ins[5], ins[4], ins[6], H, W, th, tw,
                             budget)
    table = sb.gaussian_rows(*ins[:4], ins[6])[dup.gid].t().contiguous()
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    g_out = torch.randn(R, 3, H, W, device=cuda)
    args = (R, H, W, th, tw, cap)
    out, logt = sb.binned_fwd(dup.seg, table, bg, *args)
    tot = (g_out * (out - bg.reshape(1, 3, 1, 1)
                    * torch.exp(logt)[:, None])).sum(1)
    dgrad = sb.binned_bwd(dup.seg, table, bg, logt, tot, g_out, *args)
    out_r, logt_r = sb.binned_fwd_ref(dup.seg, table, bg, *args)
    dgrad_r = sb.binned_bwd_ref(dup.seg, table, bg, logt_r, tot, g_out, *args)
    torch.cuda.synchronize()
    if budget == 4096:
        assert int(dup.span_sum.sum()) > dup.gid.shape[0]
    else:
        assert int((dup.seg[1:] - dup.seg[:-1]).max()) > 1024
    assert float((out - out_r).abs().max()) < 1e-4
    assert torch.equal(logt, logt_r)
    for k in range(9):
        assert rel_err(dgrad_r[k], dgrad[k]) < 1e-4, k


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
