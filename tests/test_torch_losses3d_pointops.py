"""PyTorch port vs the JAX package: the 3D set losses (Chamfer, EMD) and
the ragged point ops (offset2batch, kNN, ball query, grouping,
interpolation, FPS).

Same numpy inputs, float32 on the CPU. Tolerances: indices exact (the
kNN's ties go to the lower index in both: ``jax.lax.top_k`` and the port's
stable sort; FPS takes argmax's first index), losses 1e-5 relative (float32
sums in other orders), the kNN's distances 1e-5 absolute (the square root
of |q|^2 + |s|^2 - 2 q.s, a cancelling sum of O(1) terms: measured 2.6e-6
at a distance of 0.05), EMD 1e-5 relative after its 50
Sinkhorn iterations, gradients 1e-5 of their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unipre3d_tpu.ops import losses3d as jl
from unipre3d_tpu.ops import pointops_ragged as jpo
from unipre3d_tpu_torch.ops import losses3d as tl
from unipre3d_tpu_torch.ops import pointops_ragged as tpo
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def t(x):
    return torch.from_numpy(np.asarray(x))


def clouds():
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (2, 48, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 48, 3)).astype(np.float32)
    return a, b


def test_chamfer_and_its_gradient_match_jax():
    a, b = clouds()
    jd1, jd2 = jl.chamfer_distance(jnp.asarray(a), jnp.asarray(b[:, :40]))
    td1, td2 = tl.chamfer_distance(t(a), t(b[:, :40]))
    np.testing.assert_allclose(td1.numpy(), np.asarray(jd1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-5,
                               atol=1e-6)
    jg = np.asarray(jax.grad(lambda x: jl.chamfer_loss(x, jnp.asarray(b)))(
        jnp.asarray(a)))
    x = t(a).requires_grad_(True)
    loss = tl.chamfer_loss(x, t(b))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(
        float(jl.chamfer_loss(jnp.asarray(a), jnp.asarray(b))), rel=1e-5)
    assert np.abs(x.grad.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()


def test_emd_matches_jax():
    a, b = clouds()
    je = np.asarray(jl.emd_approx(jnp.asarray(a), jnp.asarray(b), eps=0.05))
    te = tl.emd_approx(t(a), t(b), eps=0.05).numpy()
    np.testing.assert_allclose(te, je, rtol=1e-5)
    jg = np.asarray(jax.grad(lambda x: jnp.sum(jl.emd_approx(
        x, jnp.asarray(b), eps=0.05)))(jnp.asarray(a)))
    x = t(a).requires_grad_(True)
    tl.emd_approx(x, t(b), eps=0.05).sum().backward()
    assert np.abs(x.grad.numpy() - jg).max() <= 1e-4 * np.abs(jg).max()


def ragged(ties: bool):
    """Two scenes of 40 and 60 points (on an integer grid with ties), as
    support, and 30 + 25 queries."""
    rng = np.random.default_rng(1)
    if ties:
        s = rng.integers(0, 4, (100, 3)).astype(np.float32)
        q = rng.integers(0, 4, (55, 3)).astype(np.float32)
    else:
        s = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
        q = rng.uniform(-1, 1, (55, 3)).astype(np.float32)
    return s, np.array([40, 100], np.int32), q, np.array([30, 55], np.int32)


def test_offset2batch_matches_jax():
    off = np.array([3, 3, 10, 17], np.int32)
    np.testing.assert_array_equal(
        tpo.offset2batch(t(off), 17).numpy(),
        np.asarray(jpo.offset2batch(jnp.asarray(off), 17)))


@pytest.mark.parametrize("ties", [False, True])
def test_knn_query_matches_jax(ties):
    s, so, q, qo = ragged(ties)
    ji, jd = jpo.knn_query(8, jnp.asarray(s), jnp.asarray(so),
                           jnp.asarray(q), jnp.asarray(qo))
    ti, td = tpo.knn_query(8, t(s), t(so), t(q), t(qo))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-5)
    assert (ti.numpy()[:30] < 40).all() and (ti.numpy()[30:] >= 40).all()
    if ties:   # equal distances in a row: ascending indices
        d, i = td.numpy(), ti.numpy()
        same = d[:, 1:] == d[:, :-1]
        assert same.any() and (i[:, 1:][same] > i[:, :-1][same]).all()


@pytest.mark.parametrize("radius", [0.3, 0.9])
def test_ball_query_matches_jax(radius):
    """At r = 0.3 many balls hold fewer than nsample points (padded with
    the first hit, or 0 when empty)."""
    s, so, q, qo = ragged(False)
    ji = jpo.ball_query(radius, 6, jnp.asarray(s), jnp.asarray(so),
                        jnp.asarray(q), jnp.asarray(qo))
    ti = tpo.ball_query(radius, 6, t(s), t(so), t(q), t(qo))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    d2 = ((q[:, None] - s[None]) ** 2).sum(-1)
    hits = (d2 < radius ** 2).sum(1)
    if radius == 0.3:
        assert ((hits > 0) & (hits < 6)).any()


def test_grouping_and_interpolation_match_jax():
    s, so, q, qo = ragged(False)
    feats = np.random.default_rng(2).normal(size=(100, 5)).astype(np.float32)
    idx = np.random.default_rng(3).integers(0, 100, (7, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tpo.grouping(t(feats), t(idx)).numpy(),
        np.asarray(jpo.grouping(jnp.asarray(feats), jnp.asarray(idx))))
    ji = jpo.interpolation(jnp.asarray(s), jnp.asarray(so), jnp.asarray(q),
                           jnp.asarray(qo), jnp.asarray(feats))
    ti = tpo.interpolation(t(s), t(so), t(q), t(qo), t(feats))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5,
                               atol=1e-5)


def test_farthest_point_sampling_matches_jax():
    s, so, _, _ = ragged(False)
    new = np.array([12, 30], np.int32)      # 12 of scene 0, 18 of scene 1
    jf = jpo.farthest_point_sampling(jnp.asarray(s), jnp.asarray(so),
                                     jnp.asarray(new), 20)
    tf = tpo.farthest_point_sampling(t(s), t(so), t(new), 20)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert (tf.numpy()[0] < 40).all() and (tf.numpy()[1] >= 40).all()
    assert (tf.numpy()[0, 12:] == 0).all()
