"""Selective state-space scan (S6 / Mamba) and the depthwise causal conv.

Port of unipre3d_tpu/ops/scan.py (``selective_scan``,
``selective_scan_ref``, ``causal_conv1d``). The recurrence, channel-last
``[B, L, D]`` with the state dimension N innermost::

    dt_t = softplus(delta_t + delta_bias)       (softplus optional)
    h_t  = exp(dt_t * A) h_{t-1} + dt_t B_t u_t
    y_t  = (<C_t, h_t> + D u_t) * silu(z_t)     (D and the gate optional)

float32 throughout, as the JAX version casts to float32 inside the scan.

The JAX package evaluates it with a chunked ``jax.lax.associative_scan``,
its TPU-shaped replacement for the reference's sequential CUDA
``selective_scan_fn``. PyTorch has no associative scan, and a Python loop
over the sequence costs several launches a step (about 20,000 forward
launches a Mamba3D step), so on the card the recurrence is a hand-written
kernel pair (``csrc/selective_scan.cu``): one thread per (b, d, n), the
state in a register, a sequential walk over t. ``selective_scan`` launches
it for CUDA tensors through an autograd Function whose backward is the
second kernel; CPU tensors take ``selective_scan_ref``, the plain
sequential recurrence (the counterpart of JAX's ``selective_scan_ref``),
differentiated by autograd. The kernels are held to it on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from unipre3d_tpu_torch import kernels

SCAN_N = 16        # the kernels' state dimension (one half-warp per (b, d))
SCAN_D_BLOCK = 16  # channels a CTA walks; D must be a multiple of it
SCAN_SEG = 16      # time steps per group of the kernels (one a lane)

# the kernels' C entry points, with their launch counts
SCAN_FWD = kernels.CudaKernel("selective_scan", "selective_scan_fwd", 9, 4)
SCAN_BWD = kernels.CudaKernel("selective_scan", "selective_scan_bwd", 18, 4)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0), without torch's threshold."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _prepare(delta, delta_bias, delta_softplus):
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()
    return softplus(delta) if delta_softplus else delta


def selective_scan_ref(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       delta_softplus: bool = False) -> torch.Tensor:
    """The plain sequential recurrence: u, delta [Bsz, L, D]; A [D, N];
    B, C [Bsz, L, N]; D [D]; z [Bsz, L, D]; delta_bias [D] -> y [Bsz, L, D]
    float32. Differentiable by autograd."""
    u = u.float()
    dt = _prepare(delta, delta_bias, delta_softplus)
    A, Bm, Cm = A.float(), B.float(), C.float()
    Bsz, L, Dd = u.shape
    h = u.new_zeros(Bsz, Dd, A.shape[1])
    ys = []
    for t in range(L):
        d_t = dt[:, t]
        h = torch.exp(d_t[..., None] * A) * h \
            + (d_t * u[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = torch.stack(ys, 1)
    if D is not None:
        y = y + D.float() * u
    if z is not None:
        y = y * F.silu(z.float())
    return y


def _check(u, delta, A, B, C, D, z, delta_bias):
    Bsz, L, Dd = u.shape
    N = A.shape[1]
    if N != SCAN_N or Dd % SCAN_D_BLOCK or L < 1:
        raise ValueError(f"the selective-scan kernels take N = {SCAN_N}, D a "
                         f"multiple of {SCAN_D_BLOCK} and L >= 1, got N = "
                         f"{N}, D = {Dd}, L = {L}")
    for name, t, shape in (("u", u, (Bsz, L, Dd)), ("delta", delta, u.shape),
                           ("A", A, (Dd, N)), ("B", B, (Bsz, L, N)),
                           ("C", C, (Bsz, L, N)), ("D", D, (Dd,)),
                           ("z", z, u.shape), ("delta_bias", delta_bias,
                                               (Dd,))):
        if t is not None:
            kernels.check_tensor(name, t, shape)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def scan_fwd(u, delta, A, B, C, D, z, delta_bias, delta_softplus):
    """The forward kernel: float32 contiguous inputs -> y [Bsz, L, D]."""
    _check(u, delta, A, B, C, D, z, delta_bias)
    Bsz, L, Dd = u.shape
    y = torch.empty_like(u)
    SCAN_FWD(u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), _ptr(D), _ptr(z), _ptr(delta_bias), y.data_ptr(),
             Bsz, L, Dd, int(delta_softplus))
    return y


def scan_bwd(u, delta, A, B, C, D, z, delta_bias, delta_softplus, dy):
    """The backward kernel, then a small reduction of its partial sums over
    the batch (dA, dD, d delta_bias) and over the CTAs' channel blocks (dB,
    dC) -> (du, ddelta, dA, dB, dC, dD, dz, d delta_bias); the gradients of
    absent inputs are None."""
    _check(u, delta, A, B, C, D, z, delta_bias)
    kernels.check_tensor("dy", dy, u.shape)
    Bsz, L, Dd = u.shape
    nblk = Dd // SCAN_D_BLOCK
    n_seg = -(-L // SCAN_SEG)
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    dz = torch.empty_like(u) if z is not None else None
    # per CTA (a block of SCAN_D_BLOCK channels): dB and dC summed over
    # its channels, then here over the CTAs
    dB_part = torch.empty(Bsz, L, nblk, SCAN_N, **f32)
    dC_part = torch.empty(Bsz, L, nblk, SCAN_N, **f32)
    dA_part = torch.empty(Bsz, Dd, SCAN_N, **f32)
    dD_part = torch.empty(Bsz, Dd, **f32)
    dbias_part = torch.empty(Bsz, Dd, **f32)
    # the state at the start of every segment of SCAN_SEG steps
    chk = torch.empty(Bsz, n_seg, Dd, SCAN_N, **f32)
    SCAN_BWD(u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), _ptr(D), _ptr(z), _ptr(delta_bias), dy.data_ptr(),
             du.data_ptr(), ddelta.data_ptr(), _ptr(dz), dA_part.data_ptr(),
             dB_part.data_ptr(), dC_part.data_ptr(), dD_part.data_ptr(),
             dbias_part.data_ptr(), chk.data_ptr(), Bsz, L, Dd,
             int(delta_softplus))
    return (du, ddelta, dA_part.sum(0), dB_part.sum(2), dC_part.sum(2),
            dD_part.sum(0) if D is not None else None, dz,
            dbias_part.sum(0) if delta_bias is not None else None)


class SelectiveScan(torch.autograd.Function):
    """The kernel pair behind autograd: saves only the inputs; the backward
    recomputes the states."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, delta_softplus):
        ins = [None if t is None else t.float().contiguous()
               for t in (u, delta, A, B, C, D, z, delta_bias)]
        ctx.save_for_backward(*ins)
        ctx.softplus = bool(delta_softplus)
        ctx.dtypes = [None if t is None else t.dtype
                      for t in (u, delta, A, B, C, D, z, delta_bias)]
        return scan_fwd(*ins, delta_softplus)

    @staticmethod
    def backward(ctx, dy):
        grads = scan_bwd(*ctx.saved_tensors, ctx.softplus,
                         dy.float().contiguous())
        return (*[None if g is None else g.to(dt)
                  for g, dt in zip(grads, ctx.dtypes)], None)


def selective_scan(u, delta, A, B, C, D: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None,
                   delta_bias: Optional[torch.Tensor] = None,
                   delta_softplus: bool = False) -> torch.Tensor:
    """u, delta [Bsz, L, D]; A [D, N]; B, C [Bsz, L, N]; D [D]; z [Bsz, L,
    D]; delta_bias [D] -> y [Bsz, L, D] float32. CUDA tensors launch the
    kernel pair, CPU tensors take ``selective_scan_ref``; any other device
    raises."""
    present = [t for t in (u, delta, A, B, C, D, z, delta_bias)
               if t is not None]
    if not kernels.use_kernel("selective scan", *present):
        return selective_scan_ref(u, delta, A, B, C, D, z, delta_bias,
                                  delta_softplus)
    return SelectiveScan.apply(u, delta, A, B, C, D, z, delta_bias,
                               delta_softplus)


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv: x [B, L, D], weight [K, D] (taps oldest to
    newest), bias [D] -> [B, L, D], left-padded with K - 1 zeros. Summed
    tap by tap in the JAX version's order; a float32 weight meeting a
    bfloat16 input promotes the result to float32, as in JAX."""
    K, L = weight.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = 0
    for i in range(K):
        y = y + pad[:, i:i + L, :] * weight[i]
    if bias is not None:
        y = y + bias
    return y
