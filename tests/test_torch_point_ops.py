"""PyTorch port vs the JAX package: point ops.

Index outputs (FPS, ball query, kNN) must be identical: a flipped centre or
neighbour changes everything downstream. Distances and gathered
coordinates: 1e-5 absolute (float32 rounding of |x|^2 - 2x.y + |y|^2 over
unit-range points).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unipre3d_tpu.ops import point_ops as jp
from unipre3d_tpu_torch.ops import point_ops as tp
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def cloud(seed, B=2, N=256):
    return np.random.default_rng(seed).uniform(
        -0.4, 0.4, (B, N, 3)).astype(np.float32)


def test_square_distance():
    a, b = cloud(0, N=64), cloud(1, N=48)
    np.testing.assert_allclose(
        np.asarray(jp.square_distance(jnp.asarray(a), jnp.asarray(b))),
        tp.square_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_furthest_point_sample_identical(seed):
    x = cloud(seed, N=512)
    a = np.asarray(jp.furthest_point_sample(jnp.asarray(x), 128))
    b = tp.furthest_point_sample(torch.from_numpy(x), 128).numpy()
    np.testing.assert_array_equal(a, b)
    assert (b[:, 0] == 0).all()


def test_ball_query_identical_with_empty_and_sparse_balls():
    x = cloud(3)
    q = np.concatenate([x[:, :32], x[:, :8] + 5.0], axis=1)  # 8 empty balls
    a = np.asarray(jp.ball_query(0.1, 32, jnp.asarray(x), jnp.asarray(q)))
    b = tp.ball_query(0.1, 32, torch.from_numpy(x),
                      torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(a, b)
    assert (b[:, 32:] == 0).all()


def test_knn():
    x, q = cloud(4), cloud(5, N=40)
    da, ia = jp.knn(jnp.asarray(q), jnp.asarray(x), 8)
    db, ib = tp.knn(torch.from_numpy(q), torch.from_numpy(x), 8)
    np.testing.assert_array_equal(np.asarray(ia), ib.numpy())
    np.testing.assert_allclose(np.asarray(da), db.numpy(), atol=1e-5)


def test_subsample_group_and_gather_gradient():
    x = cloud(6)
    na, ca = jp.subsample_group(jnp.asarray(x), 128, 32, radius=0.1)
    xt = torch.from_numpy(x).requires_grad_(True)
    nb, cb = tp.subsample_group(xt, 128, 32, radius=0.1)
    np.testing.assert_allclose(np.asarray(na), nb.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(ca), cb.detach().numpy(), atol=1e-6)
    idx = np.random.default_rng(0).integers(0, 256, (2, 5, 3))
    g = tp.group_points(xt, torch.from_numpy(idx))
    assert g.shape == (2, 5, 3, 3)
    g.sum().backward()
    counts = np.zeros((2, 256))
    for b in range(2):
        np.add.at(counts[b], idx[b].ravel(), 1)
    np.testing.assert_allclose(xt.grad.numpy(), counts[..., None] * np.ones(3))
