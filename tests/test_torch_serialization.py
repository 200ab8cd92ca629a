"""PyTorch port vs the JAX package: space-filling-curve serialization.

Integer codes, so everything is exact: every order's codes (the port's
int64 against JAX's uint32) on random voxel coordinates, the corners of the
10-bit grid (coordinate 1023 included) and the ``-trans`` swaps; decode
inverts encode; the voxel coordinates of a cloud; and PCM's reorder
permutation on a cloud with many points in one 0.02 voxel, which only a
stable sort orders as ``jnp.argsort`` does.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unipre3d_tpu.models import pcm as jpcm
from unipre3d_tpu.ops import serialization as jser
from unipre3d_tpu_torch.models import pcm as tpcm
from unipre3d_tpu_torch.ops import serialization as tser
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def grid(depth, seed=0, n=4000):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 1 << depth, (n, 3))
    corners = np.array(list(itertools.product([0, (1 << depth) - 1],
                                              repeat=3)))
    return np.concatenate([g, corners]).astype(np.int32)


@pytest.mark.parametrize("order", tser.ORDERS)
@pytest.mark.parametrize("depth", [10, 4])
def test_codes_equal_jax(order, depth):
    g = grid(depth)
    a = np.asarray(jser.encode(jnp.asarray(g), order=order, depth=depth))
    b = tser.encode(torch.from_numpy(g), order=order, depth=depth)
    assert b.dtype == torch.int64
    np.testing.assert_array_equal(a.astype(np.int64), b.numpy())
    assert len(np.unique(a)) == len(np.unique(g, axis=0))   # a bijection


@pytest.mark.parametrize("kind", ["z", "hilbert"])
def test_decode_inverts_encode(kind):
    g = torch.from_numpy(grid(10, seed=1))
    enc = getattr(tser, f"{kind}_{'order_' if kind == 'z' else ''}encode")
    dec = getattr(tser, f"{kind}_{'order_' if kind == 'z' else ''}decode")
    code = enc(g, 10)
    np.testing.assert_array_equal(dec(code, 10).numpy(), g.numpy())
    jdec = getattr(jser, f"{kind}_{'order_' if kind == 'z' else ''}decode")
    np.testing.assert_array_equal(
        np.asarray(jdec(jnp.asarray(code.numpy().astype(np.uint32)), 10)),
        g.numpy())


def test_grid_coord_from_points():
    p = np.random.default_rng(2).uniform(-0.5, 0.5, (2, 500, 3)).astype(
        np.float32)
    a = jser.grid_coord_from_points(jnp.asarray(p), 0.02)
    b = tser.grid_coord_from_points(torch.from_numpy(p), 0.02)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("order", jpcm.PCM_ORDERS)
def test_reorder_permutation_with_voxel_ties(order):
    rng = np.random.default_rng(3)
    # 64 clusters of 8 points each inside one 0.02 voxel: the codes tie
    centres = rng.uniform(-0.5, 0.5, (2, 64, 1, 3))
    p = (centres + rng.uniform(0, 0.004, (2, 64, 8, 3))).reshape(2, 512, 3)
    p = p.astype(np.float32)
    feat = rng.normal(size=(2, 512, 5)).astype(np.float32)
    jp_, (jf,) = jpcm.serialize_reorder(jnp.asarray(p), [jnp.asarray(feat)],
                                        order)
    tp_, (tf, none) = tpcm.serialize_reorder(
        torch.from_numpy(p), [torch.from_numpy(feat), None], order)
    assert none is None
    np.testing.assert_array_equal(np.asarray(jp_), tp_.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
