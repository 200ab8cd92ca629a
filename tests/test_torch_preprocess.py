"""PyTorch port vs the JAX package: the preprocess where a gaussian's 2D
covariance overflows float32.

A huge scale makes the projected covariance's determinant overflow:
``det_orig / det_blur`` is inf / inf or NaN, so JAX's anti-aliasing scale
``h_scale`` is NaN, the row is invalid (opacity masked to 0), and the mask
passes 0 x NaN back: JAX's gradient w.r.t. the row's opacity (and, through
``h_scale``, its mean, scale and rotation) is NaN, which in a train step
reaches every parameter. The port takes the ratio's limit, 1, on those
rows (unipre3d_tpu_torch/ops/rasterizer/preprocess.py): its gradients are
finite everywhere and equal JAX's on every row where JAX's are finite.

Both packages render one view with their brute-force reference renderer
(preprocess + sequential compositing). Tolerances: the image 1e-5 absolute
(tests/test_torch_splat.py's bar for the same renderers); gradients 1e-4
relative to each tensor's largest finite entry (float32 sums over pixels
in other orders).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_splat_dense import BG, FOV, RES, setup_batch
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401
from unipre3d_tpu.ops.rasterizer.render import rasterize_reference
from unipre3d_tpu_torch.ops.rasterizer import render as trender

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TANF = math.tan(FOV / 2)
KW = dict(img_h=RES, img_w=RES, tanfovx=TANF, tanfovy=TANF, sh_degree=1)
HUGE = {3: 1e10, 17: 1e12, 40: 1e15}   # row: scale, the covariance overflows
NAMES = ("means", "opacity", "scales", "rotations", "shs")


def overflow_case():
    """One view of 60 gaussians (tests/test_pallas_splat_dense.py's
    setup_batch), the rows of HUGE scaled up; numpy params, cameras and a
    cotangent."""
    params, cams = setup_batch(R=1, n=60, seed=4)
    p = [np.array(a)[0] for a in params]
    for row, s in HUGE.items():
        p[2][row] = s
    cot = np.random.default_rng(6).normal(size=(3, RES, RES)).astype(
        np.float32)
    return p, [np.asarray(c)[0] for c in cams], cot


def test_overflowing_covariance_jax_nan_port_finite():
    p, c, cot = overflow_case()

    def jloss(*params):
        img = rasterize_reference(*params, *map(jnp.asarray, c), bg_color=BG,
                                  **KW)["render"]
        return jnp.sum(img * cot), img

    (_, jimg), jg = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                       has_aux=True)(*map(jnp.asarray, p))
    jg = [np.asarray(g) for g in jg]
    t = [torch.tensor(a, requires_grad=True) for a in p]
    timg = trender.rasterize_reference(
        *t, *(torch.tensor(a) for a in c), bg_color=np.asarray(BG),
        **KW)["render"]
    (timg * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(np.asarray(jimg), timg.detach().numpy(),
                               atol=1e-5)
    huge = np.asarray(sorted(HUGE))
    # the fault: JAX's opacity gradient is NaN on the overflowing rows, and
    # finite on the others
    assert np.isnan(jg[1][huge]).all()
    finite = np.isfinite(jg[1])
    assert finite.sum() == len(finite) - len(huge)
    for name, a, x in zip(NAMES, jg, t):
        b = x.grad.numpy()
        assert np.isfinite(b).all(), name
        rows = np.isfinite(a.reshape(len(a), -1)).all(1)
        assert rows.sum() >= len(rows) - len(huge), name
        err = np.abs(a[rows] - b[rows]).max() / np.abs(a[rows]).max()
        assert err < 1e-4, (name, err)
