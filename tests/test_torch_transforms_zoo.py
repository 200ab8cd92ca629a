"""PyTorch port vs the JAX package: the fine-tuning transform zoo, the
``TRANSFORMS`` registry, Mix3d and the loader's collate hook.

Each newly ported transform runs on the same numpy example in both
packages; the JAX one draws from the global ``random`` and ``np.random``
seeded with ``s``, the port's from ``Draws.seeded(s)``. Tolerances: exact
for integer and boolean arrays and for the keys and their order, 1e-6
relative (and 1e-9 absolute) for floats (both compute in numpy; equal
draws give equal arithmetic, so these are measured exact).
"""

import random

import numpy as np
import pytest

from unipre3d_tpu.data import loader as jloader
from unipre3d_tpu.data import transforms as J
from unipre3d_tpu_torch.data import Loader
from unipre3d_tpu_torch.data import transforms as T
from unipre3d_tpu_torch.data.draws import Draws, batch_rng
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def scene(n=300, seed=0):
    rng = np.random.default_rng(seed)
    ext = np.stack([np.eye(4) for _ in range(2)])
    ext[:, :3, 3] = rng.normal(size=(2, 3))
    return {
        "coord": rng.uniform(-2, 2, (n, 3)),
        "color": rng.uniform(0, 255, (n, 3)),
        "normal": rng.normal(size=(n, 3)),
        "segment": rng.integers(-1, 6, n),
        "instance": rng.integers(-1, 5, n),
        "extrinsic": ext.astype(np.float32),
    }


def views(n=300, seed=1):
    """A scene in front of two pinhole cameras (lidar2img = K [R|t]) with
    16x20 images."""
    d = scene(n, seed)
    d["coord"][:, 2] = np.abs(d["coord"][:, 2]) + 3.0
    K = np.array([[8.0, 0, 10, 0], [0, 8.0, 8, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]])
    l2c = [np.eye(4), np.eye(4)]
    l2c[1][:3, 3] = [0.3, -0.2, 0.5]
    d["lidar2cam"] = l2c
    d["lidar2img"] = [K @ m for m in l2c]
    rng = np.random.default_rng(seed + 1)
    d["img"] = [rng.uniform(0, 255, (16, 20, 3)) for _ in l2c]
    return d


def project(d):
    return J.ProjectOnImage()(d)


EXT = {"keys": ["extrinsic"]}
CASES = {
    "NormalizeCoord": ({}, scene),
    "PositiveShift": ({}, scene),
    "RandomShift": (EXT, scene),
    "RandomRotateTargetAngle": (dict(EXT, p=1.0), scene),
    "RandomScale": (dict(EXT, scale=(0.8, 1.2), anisotropic=True), scene),
    "RandomFlip": (dict(EXT, p=0.5), scene),
    "ClipGaussianJitter": ({}, scene),
    "RandomColorGrayScale": ({"p": 1.0}, scene),
    "RandomDropout": ({"dropout_application_ratio": 1.0}, scene),
    "SphereCrop": ({"point_max": 120}, scene),
    "SphereCrop_center": ({"point_max": 120, "mode": "center"}, scene),
    "ElasticDistortion": ({}, scene),
    "Copy": ({}, scene),
    "Add": ({"keys_dict": {"condition": "ScanNet"}}, scene),
    "PointClip": ({"point_cloud_range": (-1, -1, -1, 1, 1, 1)}, scene),
    "PointRangeFilter": ({"point_cloud_range": (-1, -1, -1, 1, 1, 1)},
                         scene),
    "ProjectOnImage": ({}, views),
    "RaySample": ({"point_ratio": 0.5}, lambda: project(views())),
    "RandomColorJitter": (dict(brightness=0.4, contrast=0.4,
                               saturation=0.4, hue=0.1, p=0.95), scene),
    "HueSaturationTranslation": ({}, scene),
    "RandomColorDrop": ({"p": 1.0}, scene),
    "ShufflePoint": ({}, scene),
    "CropBoundary": ({}, scene),
    "ContrastiveViewsGenerator": (dict(
        view_keys=("coord", "color", "normal"),
        view_trans=[("RandomScale", {"scale": (0.9, 1.1)}),
                    ("RandomFlip", {}), ("RandomColorDrop", {"p": 0.5})]),
        scene),
    "InstanceParser": ({}, scene),
    "ToTensor": ({}, scene),
}


def assert_same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
        assert a.shape == b.shape and b.dtype == a.dtype
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)
    elif isinstance(a, np.ndarray):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_transform_matches_jax(case, seed):
    name = case.split("_")[0]
    kw, make = CASES[case]
    np.random.seed(seed)
    random.seed(seed)
    ref = J.TRANSFORMS[name](**kw)(make())
    got = T.TRANSFORMS[name](**kw)(make(), Draws.seeded(seed))
    assert_same(ref, got)


def test_registry_names_match_jax():
    assert sorted(T.TRANSFORMS) == sorted(J.TRANSFORMS)
    assert T.POINT_KEYS == J.POINT_KEYS


def test_hsv_round_trip_and_select_points_match_jax():
    rgb = np.random.default_rng(0).uniform(0, 1, (500, 3))
    rgb[:10] = 0.5                      # grey: equal channels
    np.testing.assert_array_equal(T._rgb2hsv(rgb), J._rgb2hsv(rgb))
    hsv = J._rgb2hsv(rgb)
    np.testing.assert_array_equal(T._hsv2rgb(hsv), J._hsv2rgb(hsv))
    np.testing.assert_allclose(T._hsv2rgb(T._rgb2hsv(rgb)), rgb, atol=1e-12)
    idx = np.array([5, 1, 7])
    assert_same(J._select_points(scene(), idx),
                T._select_points(scene(), idx))


def padded(value, n_valid, M=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"coord": np.full((M, 3), value, np.float32)
            + rng.normal(size=(M, 3)).astype(np.float32),
            "segment": np.full(M, int(value), np.int64),
            "feat": rng.normal(size=(M, 4)).astype(np.float32),
            "mask": np.arange(M) < n_valid, "name": f"scene{value}"}


def test_mix3d_pair_matches_jax_with_the_same_generator():
    a, b = padded(1.0, 40), padded(2.0, 50, seed=1)
    ref = J.mix3d_pair(a, b, np.random.default_rng(4))
    got = T.mix3d_pair(a, b, np.random.default_rng(4))
    assert_same(ref, got)
    assert got["mask"].sum() == 64 and set(got["segment"]) == {1, 2}


def test_mix3d_collate_matches_jax_on_one_batch():
    """JAX's hook carries one generator seeded ``s``; the port's takes the
    batch's generator: for the first batch, ``default_rng(s)`` alike. Also
    a nested ``point_cloud`` (the scene schema)."""
    ex = [padded(v, 30 + 5 * v, seed=v) for v in range(4)]
    ref = J.make_mix3d_collate(0.8, seed=7)(ex)
    got = T.make_mix3d_collate(0.8)(ex, np.random.default_rng(7))
    assert_same(ref, got)
    assert any(g is not e for g, e in zip(got, ex))       # something mixed
    nested = [{"point_cloud": e, "idx": i} for i, e in enumerate(ex)]
    ref = J.make_mix3d_collate(1.0, seed=2)(nested)
    got = T.make_mix3d_collate(1.0)(nested, np.random.default_rng(2))
    assert_same(ref, got)
    assert T.make_mix3d_collate(0.0)(ex, np.random.default_rng(0)) is ex


class Tiny:
    def __init__(self, n):
        self.items = [padded(float(i % 3), 20 + i, M=32, seed=i)
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_loader_collate_hook_gets_batch_order_and_batch_generator():
    """The hook sees each batch's examples in batch order, before stacking,
    with ``batch_rng(seed, epoch, batch)``: a resumed loader hands the same
    generator to the same batch. On the first batch the port's Mix3d
    collate equals JAX's loader with its hook seeded alike."""
    seen = []

    def hook(examples, rng):
        seen.append(([e["name"] for e in examples], rng.random()))
        return examples

    ds = Tiny(9)
    loader = Loader(ds, 3, seed=5, shuffle=True, num_workers=1,
                    collate_hook=hook)
    batches = list(loader.epoch(1))
    order = np.random.default_rng(5 + 1).permutation(9)
    for b, (names, r) in enumerate(seen):
        assert names == [ds[int(i)]["name"] for i in order[3 * b:3 * b + 3]]
        assert r == batch_rng(5, 1, b).random()
    assert batches[0]["coord"].shape == (3, 32, 3)
    seen.clear()
    list(loader.epoch(1, start=2))
    assert seen[0][1] == batch_rng(5, 1, 2).random()

    ds = Tiny(4)
    jl = jloader.Loader(ds, 2, shuffle=False, num_workers=1,
                        collate_hook=J.make_mix3d_collate(1.0, seed=0))
    ref = next(iter(jl.epoch(0)))
    mix = T.make_mix3d_collate(1.0)
    tl = Loader(ds, 2, shuffle=False, num_workers=1,
                collate_hook=lambda e, rng: mix(e, np.random.default_rng(0)))
    assert_same(ref, next(iter(tl.epoch(0))))
