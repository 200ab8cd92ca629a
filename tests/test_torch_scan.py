"""PyTorch port vs the JAX package: the selective scan, the causal conv and
the Mamba mixer, float32 on the CPU (the scan's plain version, which the
CUDA kernel pair is held to on the card by tests/test_torch_kernels_cuda.py
and chip_smoke.py).

The scan against JAX's ``selective_scan`` on both of its paths (one
associative scan at L <= 64, the chunked and padded one at L = 150) and
against its sequential ``selective_scan_ref``, with D, the silu(z) gate,
delta_bias and the softplus: the output within 1e-5 of max |y|, the
gradient of every input within 1e-4 relative to its largest entry (float32
recurrences summed in another order: JAX's associative scan multiplies the
decays in a tree). The causal conv to 1e-6 absolute. ``MambaMixer`` at
d_model 32 on converted weights: the output and every parameter gradient
to 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unipre3d_tpu.models.mamba_mixer import MambaMixer as JMixer
from unipre3d_tpu.ops import scan as jscan
from unipre3d_tpu_torch.models import mamba_mixer
from unipre3d_tpu_torch.models.mamba_mixer import MambaMixer
from unipre3d_tpu_torch.ops import scan as tscan
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")


def rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-12)


def scan_inputs(Bsz, L, D, N, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return [f32(rng.normal(size=(Bsz, L, D))),
            f32(rng.normal(-1.0, 1.0, (Bsz, L, D))),
            f32(-np.exp(rng.uniform(0, np.log(N), (D, N)))),
            f32(rng.normal(size=(Bsz, L, N))),
            f32(rng.normal(size=(Bsz, L, N))),
            f32(rng.normal(size=D)),
            f32(rng.normal(size=(Bsz, L, D))),
            f32(rng.normal(-2.0, 0.5, D))]


@pytest.mark.parametrize("L,jax_fn", [(40, "selective_scan"),
                                      (150, "selective_scan"),
                                      (40, "selective_scan_ref")])
def test_plain_scan_matches_jax(L, jax_fn):
    ins = scan_inputs(2, L, 24, 16, L)
    cot = np.random.default_rng(1).normal(size=(2, L, 24)).astype(np.float32)
    fn = getattr(jscan, jax_fn)

    def jloss(*a):
        y = fn(*a, delta_softplus=True)
        return jnp.sum(y * cot), y

    (_, jy), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(8)), has_aux=True))(
        *[jnp.asarray(a) for a in ins])
    tin = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    ty = tscan.selective_scan(*tin, delta_softplus=True)
    tg = torch.autograd.grad((ty * torch.from_numpy(cot)).sum(), tin)
    assert rel_err(jy, ty.detach().numpy()) < 1e-5
    for name, a, b in zip(NAMES, jg, tg):
        assert rel_err(a, b.numpy()) < 1e-4, name


def test_plain_scan_without_the_options_matches_jax():
    """No D, gate or bias, no softplus (positive deltas)."""
    u, _, A, Bm, Cm = scan_inputs(2, 33, 16, 16, 3)[:5]
    delta = np.random.default_rng(4).uniform(1e-3, 0.2, u.shape).astype(
        np.float32)
    jy = jscan.selective_scan(*map(jnp.asarray, (u, delta, A, Bm, Cm)))
    ty = tscan.selective_scan(*map(torch.from_numpy, (u, delta, A, Bm, Cm)))
    assert rel_err(jy, ty.numpy()) < 1e-5


def test_scan_wrapper_takes_the_plain_version_only_on_the_cpu():
    ins = [torch.from_numpy(a) for a in scan_inputs(1, 5, 16, 16, 5)]
    y = tscan.selective_scan(*ins, delta_softplus=True)
    assert torch.equal(y, tscan.selective_scan_ref(*ins,
                                                   delta_softplus=True))
    assert tscan.SCAN_FWD.launches == 0 and tscan.SCAN_BWD.launches == 0
    with pytest.raises(ValueError, match="cuda or cpu"):
        tscan.selective_scan(*[t.to("meta") for t in ins])


def test_causal_conv1d():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 11, 8)).astype(np.float32)
    w = rng.normal(size=(4, 8)).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    a = jscan.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    t = tscan.causal_conv1d(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(np.asarray(a), t.numpy(), atol=1e-6)
    # causal: the output at t sees x up to t only
    x2 = x.copy()
    x2[:, 6:] += 1.0
    t2 = tscan.causal_conv1d(*map(torch.from_numpy, (x2, w, b)))
    np.testing.assert_array_equal(t2[:, :6].numpy(), t[:, :6].numpy())


@pytest.mark.parametrize("bimamba", [True, False])
def test_mamba_mixer(bimamba):
    jm = JMixer(32, bimamba=bimamba)
    x = np.random.default_rng(7).normal(size=(2, 20, 32)).astype(np.float32)
    cot = np.random.default_rng(8).normal(size=(2, 20, 32)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def jloss(p):
        y = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(y * cot), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm = MambaMixer(32, bimamba=bimamba)
    tm.load_state_dict(jax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                params)))
    ty = tm(torch.from_numpy(x))
    (ty * torch.from_numpy(cot)).sum().backward()
    assert rel_err(jy, ty.detach().numpy()) < 1e-4
    jgrad = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jg))
    assert set(jgrad) == {n for n, _ in tm.named_parameters()}
    for n, p in tm.named_parameters():
        assert rel_err(jgrad[n], p.grad.numpy()) < 1e-4, n


@pytest.mark.parametrize("L", [1, 37, 150])
def test_segmented_twin_matches_jax(L):
    """The plain twin of the kernels' decomposition (the states kept every
    SCAN_SEG steps, the backward segment by segment from them with e * dh
    carried into the segment before, the sums over n as X and Y) against
    JAX's selective_scan and autograd of selective_scan_ref: at L = 1, at
    an L that no segment divides and at an L over several segments, every
    gradient within 1e-4 and the kept states within 1e-5 of the walk's."""
    ins = scan_inputs(2, L, 24, 16, L + 1)
    cot = np.random.default_rng(2).normal(size=(2, L, 24)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jscan.selective_scan(*a, delta_softplus=True) * cot)

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(8))))(
        *[jnp.asarray(a) for a in ins])
    tin = [torch.from_numpy(a) for a in ins]
    dy = torch.from_numpy(cot)
    chk = tscan.scan_states_ref(tin[0], tin[1], tin[2], tin[3], tin[7], True)
    assert chk.shape == (2, -(-L // tscan.SCAN_SEG), 24, 16)
    twin = tscan.scan_bwd_ref(*tin, True, dy, chk)
    leaves = [t.clone().requires_grad_(True) for t in tin]
    y = tscan.selective_scan_ref(*leaves, delta_softplus=True)
    tg = torch.autograd.grad(y, leaves, dy)
    for name, a, b, c in zip(NAMES, jg, tg, twin):
        assert rel_err(a, c.numpy()) < 1e-4, name
        assert rel_err(b.numpy(), c.numpy()) < 1e-4, name
    # the kept states are the walk's: h before step s * SCAN_SEG
    dt = tscan.softplus(tin[1] + tin[7])
    h = torch.zeros(2, 24, 16)
    for t in range(L):
        if t % tscan.SCAN_SEG == 0:
            assert rel_err(h.numpy(), chk[:, t // tscan.SCAN_SEG].numpy()) \
                < 1e-5
        h = torch.exp(dt[:, t, :, None] * tin[2]) * h \
            + (dt[:, t] * tin[0][:, t])[..., None] * tin[3][:, t, None, :]


def test_segmented_twin_keeps_each_gradient_in_its_inputs_dtype():
    """bfloat16 delta, B, C, z (the mixer's): each gradient in its input's
    dtype, within 1e-4 of autograd on float32 copies beyond the rounding
    into bfloat16 (half an ulp)."""
    ins = [torch.from_numpy(a) for a in scan_inputs(2, 40, 24, 16, 9)]
    for i in (1, 3, 4, 6):
        ins[i] = ins[i].to(torch.bfloat16)
    dy = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 40, 24)).astype(np.float32))
    chk = tscan.scan_states_ref(ins[0], ins[1], ins[2], ins[3], ins[7], True)
    twin = tscan.scan_bwd_ref(*ins, True, dy, chk)
    leaves = [t.float().requires_grad_(True) for t in ins]
    ref = torch.autograd.grad(
        tscan.selective_scan_ref(*leaves, delta_softplus=True), leaves, dy)
    assert [g.dtype for g in twin] == [t.dtype for t in ins]
    for name, a, b in zip(NAMES, ref, twin):
        diff = (b.float() - a).abs()
        if b.dtype == torch.bfloat16:
            _, ex = torch.frexp(b.float())
            diff = (diff - torch.ldexp(torch.ones_like(diff), ex - 9)).clamp(
                min=0.0)
        assert float(diff.max() / a.abs().max()) < 1e-4, name


def test_mixer_hands_the_kernels_operands_they_read_in_place():
    """The default run's mixer (bfloat16) at the CPU: every [B, L, W]
    operand of its scan calls is one the kernels read as it is (the
    wrapper's own predicate, ``in_place``: no copy or cast launch before
    the kernel), B and C are views of x_proj's output and z of in_proj's
    (row strides dt_rank + 32 and 2 d_inner), delta and z bfloat16, and A,
    D, delta_bias float32 contiguous (no copy either)."""
    mixer = MambaMixer(32, bimamba=True, dtype=torch.bfloat16)
    seen = []
    real = mamba_mixer.selective_scan

    def hook(u, delta, A, B, C, D=None, z=None, delta_bias=None,
             delta_softplus=False):
        seen.append(dict(u=u, delta=delta, A=A, B=B, C=C, D=D, z=z,
                         delta_bias=delta_bias))
        return real(u, delta, A, B, C, D, z, delta_bias, delta_softplus)

    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 20, 32)).astype(np.float32)).to(torch.bfloat16)
    mamba_mixer.selective_scan = hook
    try:
        mixer(x).float().sum().backward()
    finally:
        mamba_mixer.selective_scan = real
    assert len(seen) == 2  # the forward and the flipped direction
    d_inner, rank = 64, mixer.fwd.dt_rank
    for ops in seen:
        for name in ("u", "delta", "B", "C", "z"):
            assert tscan.in_place(ops[name]), name
        assert ops["u"].dtype == torch.float32
        assert {ops[n].dtype for n in ("delta", "B", "C", "z")} == {
            torch.bfloat16}
        assert ops["B"].stride(1) == ops["C"].stride(1) == rank + 32
        for name in ("A", "D", "delta_bias"):
            t = ops[name]
            assert t.dtype == torch.float32 and t.is_contiguous(), name
    assert seen[0]["z"].stride(1) == 2 * d_inner  # a view of in_proj's
