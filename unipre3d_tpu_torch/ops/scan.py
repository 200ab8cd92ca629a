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
kernel pair (``csrc/selective_scan.cu``): one thread a channel (b, d), its
16 states in registers, a sequential walk over t in tiles of
``SCAN_SEG`` steps. The forward keeps the state before every tile when the
gradient will be taken; the backward walks the tiles last to first from
those states, sums dB and dC over channels by warp shuffles and a partial
a CTA, and a second kernel sums the partials in a fixed order (two runs
give the same bits). The kernels read u, delta, z, B, C (and dy) in place
as float32 or bfloat16 with their own batch and time strides, the last
dimension contiguous (``in_place``), and write each input's gradient in
its dtype: the mixer's bf16 projections and its views of ``x_proj``'s and
``in_proj``'s outputs go in without a copy, as JAX casts them inside its
scan. An operand outside that (float16, a strided last dimension) is
copied to float32 first. ``selective_scan`` launches the pair for CUDA
tensors through an autograd Function; CPU tensors take
``selective_scan_ref``, the plain sequential recurrence (the counterpart
of JAX's ``selective_scan_ref``), differentiated by autograd. The kernels
are held to it on the card. ``scan_states_ref`` and ``scan_bwd_ref`` are
plain twins of the kernels' decomposition (the states every ``SCAN_SEG``
steps, the backward segment by segment with its carry of dh), held to
autograd of ``selective_scan_ref`` on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.nn import functional as F

from unipre3d_tpu_torch import kernels

SCAN_N = 16          # the kernels' state dimension (a thread's registers)
SCAN_CHANNELS = 64   # channels a backward CTA walks; D is masked at its edge
SCAN_SEG = 8         # the states kept every SCAN_SEG steps (a backward segment)

# the kernels' C entry points, with their launch counts (the backward's
# entry point launches the walk and the sum of its partials)
SCAN_FWD = kernels.CudaKernel("selective_scan", "selective_scan_fwd", 11, 5)
SCAN_BWD = kernels.CudaKernel("selective_scan", "selective_scan_bwd", 20, 5)

# the dtypes the kernels read and write in place
IN_PLACE_DTYPES = (torch.float32, torch.bfloat16)


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


def scan_states_ref(u, delta, A, B, delta_bias=None,
                    delta_softplus: bool = False) -> torch.Tensor:
    """Plain twin of the forward kernel's kept states: the state before
    every ``SCAN_SEG`` steps, [Bsz, ceil(L / SCAN_SEG), D, N] float32."""
    u = u.float()
    dt = _prepare(delta, delta_bias, delta_softplus)
    A, Bm = A.float(), B.float()
    Bsz, L, Dd = u.shape
    h = u.new_zeros(Bsz, Dd, A.shape[1])
    kept = []
    for t in range(L):
        if t % SCAN_SEG == 0:
            kept.append(h)
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]
    return torch.stack(kept, 1)


def scan_bwd_ref(u, delta, A, B, C, D, z, delta_bias, delta_softplus, dy,
                 chk):
    """Plain twin of the backward kernel's decomposition: the segments of
    ``SCAN_SEG`` steps last to first, each recomputed from its kept state
    (``chk``, as ``scan_states_ref`` gives it) and walked back with
    e * dh carried into the segment before; the sums over n gathered as
    X_t = sum_n dh B_t and Y_t = sum_n A dh h_{t-1} e_t. Returns (du,
    ddelta, dA, dB, dC, dD, dz, d delta_bias), each input's gradient in its
    dtype (dA, dD, d delta_bias float32), None for absent inputs."""
    u32, Bm, Cm, A32 = u.float(), B.float(), C.float(), A.float()
    x = delta.float()
    if delta_bias is not None:
        x = x + delta_bias.float()
    dt = softplus(x) if delta_softplus else x
    dtu = dt * u32
    g = dy.float() * (F.silu(z.float()) if z is not None else 1.0)
    Bsz, L, Dd = u.shape
    X, Y, sc = (u32.new_zeros(Bsz, L, Dd) for _ in range(3))
    dB, dC = u32.new_zeros(Bsz, L, A32.shape[1]), u32.new_zeros(
        Bsz, L, A32.shape[1])
    dA = torch.zeros_like(A32)
    dhn = u32.new_zeros(Bsz, Dd, A32.shape[1])  # e * dh from the segment after
    for s in reversed(range(chk.shape[1])):
        ts = range(s * SCAN_SEG, min((s + 1) * SCAN_SEG, L))
        h = chk[:, s]
        walk = []
        for t in ts:  # the segment's states, recomputed
            e = torch.exp(dt[:, t, :, None] * A32)
            h_next = e * h + dtu[:, t, :, None] * Bm[:, t, None, :]
            walk.append((h, e, h_next))
            h = h_next
        for t, (h_prev, e, h) in zip(reversed(ts), reversed(walk)):
            dh = g[:, t, :, None] * Cm[:, t, None, :] + dhn
            q = dh * h_prev * e
            X[:, t] = (dh * Bm[:, t, None, :]).sum(-1)
            Y[:, t] = (A32 * q).sum(-1)
            sc[:, t] = (Cm[:, t, None, :] * h).sum(-1)
            dA += (dt[:, t, :, None] * q).sum(0)
            dB[:, t] = (dh * dtu[:, t, :, None]).sum(1)
            dC[:, t] = (g[:, t, :, None] * h).sum(1)
            dhn = e * dh
    dskip = D.float() if D is not None else 0.0
    du = g * dskip + dt * X
    ddelta = Y + u32 * X
    if delta_softplus:
        ddelta = ddelta * torch.sigmoid(x)
    dz = None
    if z is not None:
        z32 = z.float()
        sg = torch.sigmoid(z32)
        dz = (dy.float() * (sc + dskip * u32) * sg * (1 + z32 * (1 - sg))
              ).to(z.dtype)
    return (du.to(u.dtype), ddelta.to(delta.dtype), dA, dB.to(B.dtype),
            dC.to(C.dtype), (g * u32).sum((0, 1)) if D is not None else None,
            dz, ddelta.sum((0, 1)) if delta_bias is not None else None)


def in_place(t: torch.Tensor) -> bool:
    """Whether the kernels read the [Bsz, L, W] operand ``t`` as it is:
    float32 or bfloat16, the last dimension contiguous, the batch and time
    strides within an int."""
    return (t.dtype in IN_PLACE_DTYPES and t.dim() == 3
            and (t.stride(2) == 1 or t.shape[2] == 1)
            and all(0 <= st < 2 ** 31 for st in t.stride()))


def _operand(t):
    """An operand as the kernels take it: itself when ``in_place``, else a
    float32 contiguous copy (input normalisation, off the mixer's path)."""
    return t if t is None or in_place(t) else t.float().contiguous()


def _param(t):
    """A, D, delta_bias: float32 contiguous (the mixer's are: no copy)."""
    return None if t is None else t.float().contiguous()


def _check(u, delta, A, B, C, D, z, delta_bias):
    if u.device.type != "cuda":
        raise ValueError(f"the selective-scan kernels run on cuda, not "
                         f"{u.device}")
    Bsz, L, Dd = u.shape
    N = A.shape[1]
    if N != SCAN_N or L < 1 or not 0 < Bsz <= 65535:
        raise ValueError(f"the selective-scan kernels take N = {SCAN_N}, L "
                         f">= 1 and 1 <= batch <= 65535, got N = {N}, L = "
                         f"{L}, batch {Bsz}")
    for name, t, shape in (("u", u, (Bsz, L, Dd)), ("delta", delta, u.shape),
                           ("B", B, (Bsz, L, N)), ("C", C, (Bsz, L, N)),
                           ("z", z, u.shape)):
        if t is not None and (tuple(t.shape) != tuple(shape)
                              or not in_place(t)):
            raise ValueError(f"{name}: need a float32 or bfloat16 tensor of "
                             f"shape {tuple(shape)} with a contiguous last "
                             f"dimension, got {t.dtype} {tuple(t.shape)} "
                             f"strides {t.stride()}")
    for name, t, shape in (("A", A, (Dd, N)), ("D", D, (Dd,)),
                           ("delta_bias", delta_bias, (Dd,))):
        if t is not None:
            kernels.check_tensor(name, t, shape)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _layout(*operands):
    """The batch and time strides of the operands (a C int array, kept
    alive by the caller through the call) and their bfloat16 bits."""
    strides, bf16 = [], 0
    for i, t in enumerate(operands):
        strides += [0, 0] if t is None else [t.stride(0), t.stride(1)]
        if t is not None and t.dtype == torch.bfloat16:
            bf16 |= 1 << i
    return (ctypes.c_int * len(strides))(*strides), bf16


def scan_fwd(u, delta, A, B, C, D, z, delta_bias, delta_softplus,
             keep_states: bool = False):
    """The forward kernel on operands it takes in place (``in_place``; A,
    D, delta_bias float32 contiguous) -> y [Bsz, L, D] float32, and with
    ``keep_states`` also the state before every ``SCAN_SEG`` steps, chk
    [Bsz, ceil(L / SCAN_SEG), D, N] float32, which ``scan_bwd`` takes."""
    _check(u, delta, A, B, C, D, z, delta_bias)
    Bsz, L, Dd = u.shape
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty(Bsz, L, Dd, **f32)
    chk = torch.empty(Bsz, -(-L // SCAN_SEG), Dd, SCAN_N, **f32) \
        if keep_states else None
    strides, bf16 = _layout(u, delta, z, B, C)
    SCAN_FWD(u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), _ptr(D), _ptr(z), _ptr(delta_bias), y.data_ptr(),
             _ptr(chk), ctypes.addressof(strides), Bsz, L, Dd,
             int(delta_softplus), bf16)
    return (y, chk) if keep_states else y


def scan_bwd(u, delta, A, B, C, D, z, delta_bias, delta_softplus, dy, chk):
    """The backward kernels (the walk, then the fixed-order sum of its
    partials), given dy (taken in place like u) and the forward's ``chk``
    -> (du, ddelta, dA, dB, dC, dD, dz, d delta_bias): each input's gradient
    in its dtype, contiguous (dA, dD, d delta_bias float32); the gradients
    of absent inputs are None."""
    _check(u, delta, A, B, C, D, z, delta_bias)
    Bsz, L, Dd = u.shape
    if tuple(dy.shape) != tuple(u.shape) or not in_place(dy):
        raise ValueError(f"dy: need the shape {tuple(u.shape)} of u and a "
                         f"contiguous last dimension")
    kernels.check_tensor("chk", chk, (Bsz, -(-L // SCAN_SEG), Dd, SCAN_N))
    nblk = -(-Dd // SCAN_CHANNELS)
    f32 = dict(dtype=torch.float32, device=u.device)
    like = lambda t, *shape: torch.empty(  # noqa: E731
        shape or t.shape, dtype=t.dtype, device=u.device)
    du, ddelta = like(u), like(delta)
    dz = like(z) if z is not None else None
    dB, dC = like(B, Bsz, L, SCAN_N), like(C, Bsz, L, SCAN_N)
    dA = torch.empty(Dd, SCAN_N, **f32)
    dD = torch.empty(Dd, **f32) if D is not None else None
    dbias = torch.empty(Dd, **f32) if delta_bias is not None else None
    # the walk's partial sums: dB, dC a CTA, dA, dD, d delta_bias a row
    work = torch.empty(Bsz * L * nblk * 2 * SCAN_N + Bsz * Dd * SCAN_N
                       + 2 * Bsz * Dd, **f32)
    strides, bf16 = _layout(u, delta, z, B, C, dy)
    SCAN_BWD(u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), _ptr(D), _ptr(z), _ptr(delta_bias), dy.data_ptr(),
             chk.data_ptr(), du.data_ptr(), ddelta.data_ptr(), _ptr(dz),
             dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), _ptr(dD),
             _ptr(dbias), work.data_ptr(), ctypes.addressof(strides), Bsz, L,
             Dd, int(delta_softplus), bf16)
    return du, ddelta, dA, dB, dC, dD, dz, dbias


class SelectiveScan(torch.autograd.Function):
    """The kernel pair behind autograd: saves the inputs as the kernels read
    them (the mixer's without a copy) and, when the gradient is wanted, the
    forward's states every ``SCAN_SEG`` steps."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                keep_states):
        ins = [_operand(u), _operand(delta), _param(A), _operand(B),
               _operand(C), _param(D), _operand(z), _param(delta_bias)]
        ctx.softplus = bool(delta_softplus)
        ctx.dtypes = [None if t is None else t.dtype
                      for t in (u, delta, A, B, C, D, z, delta_bias)]
        out = scan_fwd(*ins, delta_softplus, keep_states=keep_states)
        y, chk = out if keep_states else (out, None)
        ctx.save_for_backward(*ins, chk)
        return y

    @staticmethod
    def backward(ctx, dy):
        *ins, chk = ctx.saved_tensors
        grads = scan_bwd(*ins, ctx.softplus, _operand(dy), chk)
        return (*[None if g is None else g.to(dt)
                  for g, dt in zip(grads, ctx.dtypes)], None, None)


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
    keep_states = torch.is_grad_enabled() and any(t.requires_grad
                                                  for t in present)
    return SelectiveScan.apply(u, delta, A, B, C, D, z, delta_bias,
                               delta_softplus, keep_states)


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
