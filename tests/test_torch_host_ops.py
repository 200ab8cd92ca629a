"""The port's host FPS (unipre3d_tpu_torch/native): the C++ version equals
its plain numpy reference bit for bit, and it raises when it cannot be
built (no quiet numpy fallback).

Both seed at index 0, sum the squared distance as (dx*dx + dy*dy) + dz*dz
in float32 with no fused multiply-add, and take the lowest index on a
tie; the cases with exact ties (points on an integer grid, repeated
points, a cloud of one point repeated) hold that rule. (The JAX package's
OpenMP version breaks ties between threads in the order they arrive: a
held difference, ROADMAP.md.)
"""

import numpy as np
import pytest

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
