"""PyTorch port vs the JAX package: point ops.

Index outputs (FPS, ball query, kNN, three-NN; 3 and 4 channels) must be
identical: a flipped centre or neighbour changes everything downstream.
Distances and gathered
coordinates: 1e-5 absolute (float32 rounding of |x|^2 - 2x.y + |y|^2 over
unit-range points).
"""

import jax
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


def cloud4(seed, B=2, N=256):
    """Points with a fourth (gravity-like) channel, as PointMLP and PCM
    take them."""
    x = np.random.default_rng(seed).uniform(-0.4, 0.4, (B, N, 4))
    return x.astype(np.float32)


def test_square_distance_and_knn_at_four_channels():
    x, q = cloud4(7), cloud4(8, N=40)
    np.testing.assert_allclose(
        np.asarray(jp.square_distance(jnp.asarray(q), jnp.asarray(x))),
        tp.square_distance(torch.from_numpy(q), torch.from_numpy(x)).numpy(),
        atol=1e-5)
    da, ia = jp.knn(jnp.asarray(q), jnp.asarray(x), 24)
    db, ib = tp.knn(torch.from_numpy(q), torch.from_numpy(x), 24)
    np.testing.assert_array_equal(np.asarray(ia), ib.numpy())
    np.testing.assert_allclose(np.asarray(da), db.numpy(), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_furthest_point_sample_at_four_channels(seed):
    x = cloud4(seed, N=512)
    a = np.asarray(jp.furthest_point_sample(jnp.asarray(x), 128))
    b = tp.furthest_point_sample(torch.from_numpy(x), 128).numpy()
    np.testing.assert_array_equal(a, b)
    # the fourth channel takes part: the first three alone pick otherwise
    c = tp.furthest_point_sample(torch.from_numpy(x[..., :3]), 128).numpy()
    assert (b != c).any()


def test_three_nn_and_three_interpolate_with_gradient():
    """Indices equal; squared distances 1e-5 absolute; the interpolated
    features and their gradient 1e-5 relative to their largest."""
    x, q = cloud4(9, N=64), cloud4(10, N=200)
    feats = np.random.default_rng(11).normal(size=(2, 64, 8)).astype(
        np.float32)
    w = np.random.default_rng(12).normal(size=(2, 200, 8)).astype(np.float32)
    da, ia = jp.three_nn(jnp.asarray(q), jnp.asarray(x))
    db, ib = tp.three_nn(torch.from_numpy(q), torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(ia), ib.numpy())
    np.testing.assert_allclose(np.asarray(da), db.numpy(), atol=1e-5)

    def jloss(f):
        return jnp.sum(jp.three_interpolate(f, ia, da) * w)

    ja, jg = jax.value_and_grad(jloss)(jnp.asarray(feats))
    ft = torch.from_numpy(feats).requires_grad_(True)
    out = tp.three_interpolate(ft, ib, db)
    (out * torch.from_numpy(w)).sum().backward()
    ref = np.asarray(jp.three_interpolate(jnp.asarray(feats), ia, da))
    assert np.abs(out.detach().numpy() - ref).max() < 1e-5 * np.abs(ref).max()
    assert np.abs(ft.grad.numpy() - np.asarray(jg)).max() < \
        1e-5 * np.abs(np.asarray(jg)).max()
    loss = float((out.detach() * torch.from_numpy(w)).sum())
    assert float(ja) == pytest.approx(loss, rel=1e-5)
