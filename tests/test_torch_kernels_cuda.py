"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device (``cuda`` marker; the fixture skips without one) and
imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerances: images and T 1e-4 absolute (pixel values in [0, 1]); gradients
1e-4 relative to each row's largest, since the backward's atomic adds sum
the per-gaussian terms in an order that changes from run to run.
chip_smoke.py holds the same kernels at the main path's full shapes.
"""

import math

import numpy as np
import pytest
import torch

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
