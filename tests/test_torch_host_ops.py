"""The port's host ops (unipre3d_tpu_torch/native): FPS, the grid dedup and
kNN in C++ equal their plain numpy references bit for bit, and they raise
when the library cannot be built (no quiet numpy fallback). The grid dedup
and kNN also equal the JAX package's (unipre3d_tpu.native) on inputs
without exact ties: its numpy kNN fallback breaks ties arbitrarily.

Both seed at index 0, sum the squared distance as (dx*dx + dy*dy) + dz*dz
in float32 with no fused multiply-add, and take the lowest index on a
tie; the cases with exact ties (points on an integer grid, repeated
points, a cloud of one point repeated) hold that rule. (The JAX package's
OpenMP version breaks ties between threads in the order they arrive: a
held difference, ROADMAP.md.)
"""

import numpy as np
import pytest

from unipre3d_tpu import native as jnative
from unipre3d_tpu_torch import native
from test_torch_utils import trimmed_heap  # noqa: F401


def clouds():
    rng = np.random.default_rng(0)
    grid = rng.integers(0, 6, (3000, 3)).astype(np.float32)
    return {
        "uniform": (rng.uniform(-2, 2, (5000, 3)), 700),
        "grid_ties": (grid, 400),
        "repeated": (np.repeat(rng.uniform(0, 1, (50, 3)), 20, axis=0), 120),
        "one_point": (np.ones((40, 3)), 10),
        "six_channels": (rng.normal(size=(900, 6)), 900),
        "m_past_n": (rng.normal(size=(30, 3)), 64),
    }


@pytest.mark.parametrize("name", sorted(clouds()))
def test_host_fps_equals_numpy_reference(name):
    xyz, m = clouds()[name]
    got = native.host_fps(xyz, m)
    ref = native.host_fps_ref(xyz, m)
    assert got.dtype == np.int32 and got.shape == (min(m, len(xyz)),)
    np.testing.assert_array_equal(got, ref)
    assert got[0] == 0
    if name in ("uniform", "six_channels", "m_past_n"):
        # distinct points: no index twice (with fewer distinct points than
        # m, every distance reaches 0 and index 0 comes back)
        assert len(np.unique(got)) == len(got)


def test_host_fps_picks_the_lowest_index_on_a_tie():
    # from index 0 at the origin the points 1..4 all lie at distance 1;
    # from 0 and 1 together, 2, 3 and 4 still do
    xyz = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, 0, 1]],
                   np.float32)
    np.testing.assert_array_equal(native.host_fps(xyz, 3), [0, 1, 2])


def test_host_fps_raises_when_it_cannot_build(monkeypatch, tmp_path):
    bad = tmp_path / "host_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.host_fps(np.zeros((10, 3), np.float32), 4)
    monkeypatch.setenv("PATH", str(tmp_path))      # no g++ on the path
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        native.host_fps(np.zeros((10, 3), np.float32), 4)


def grid_clouds():
    rng = np.random.default_rng(4)
    return {
        "uniform": (rng.uniform(-2, 2, (6000, 3)), 0.1, None),
        "negative_min": (rng.uniform(-5, -1, (3000, 4)), 0.05,
                         np.array([-6.0, -6.0, -6.0])),
        "repeated": (np.repeat(rng.uniform(0, 1, (200, 3)), 5, axis=0),
                     0.02, None),
        "one_voxel": (np.full((50, 3), 0.5), 0.1, None),
    }


@pytest.mark.parametrize("name", sorted(grid_clouds()))
def test_host_grid_subsample_equals_numpy_reference(name):
    xyz, g, lo = grid_clouds()[name]
    idx, grid = native.host_grid_subsample(xyz, g, lo)
    ridx, rgrid = native.host_grid_subsample_ref(xyz, g, lo)
    assert idx.dtype == np.int32 and grid.dtype == np.int32
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(grid, rgrid)
    assert (np.diff(idx) > 0).all()          # first row per voxel, in order
    assert len(np.unique(grid, axis=0)) == len(grid)


@pytest.mark.parametrize("name", ["uniform", "negative_min"])
def test_host_grid_subsample_equals_jax(name):
    xyz, g, lo = grid_clouds()[name]
    for a, b in zip(native.host_grid_subsample(xyz, g, lo),
                    jnative.host_grid_subsample(xyz, g, lo)):
        np.testing.assert_array_equal(a, b)


def knn_clouds():
    rng = np.random.default_rng(5)
    return {
        "uniform": (rng.uniform(-1, 1, (300, 3)), rng.uniform(-1, 1,
                                                             (2000, 3)), 16),
        "grid_ties": (rng.integers(0, 5, (200, 3)),
                      rng.integers(0, 5, (900, 3)), 12),
        "k_past_n": (rng.normal(size=(20, 6)), rng.normal(size=(7, 6)), 10),
    }


@pytest.mark.parametrize("name", sorted(knn_clouds()))
def test_host_knn_equals_numpy_reference(name):
    q, s, k = knn_clouds()[name]
    idx, d2 = native.host_knn(q, s, k)
    ridx, rd2 = native.host_knn_ref(q, s, k)
    assert idx.shape == (len(q), min(k, len(s))) and d2.dtype == np.float32
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(d2, rd2)
    assert (np.diff(d2, axis=1) >= 0).all()
    if name == "grid_ties":   # equal distances: ascending indices
        same = d2[:, 1:] == d2[:, :-1]
        assert same.any() and (idx[:, 1:][same] > idx[:, :-1][same]).all()


def test_host_knn_equals_jax_without_ties():
    q, s, k = knn_clouds()["uniform"]
    idx, d2 = native.host_knn(q, s, k)
    jidx, jd2 = jnative.host_knn(q, s, k)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(d2, jd2, rtol=1e-5, atol=1e-6)
