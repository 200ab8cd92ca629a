"""PyTorch port vs the JAX package: the downstream testers (fragment
voting with TTA, the object testers) and ``grid_fragments``.

Both packages get the same scenes and the same deterministic numpy
``predict_fn``; TTA pipelines are given in the registry's config syntax.
JAX's pipelines draw from the global ``random`` and ``np.random`` seeded
with ``s``, the port's from ``Draws.seeded(s)``. The port's predict
returns a torch tensor (the testers read it through ``to_numpy``), JAX's
the numpy array. Records compared exactly: both compute them in numpy
from equal inputs.
"""

import random

import numpy as np
import pytest
import torch

from unipre3d_tpu.training import tester as J
from unipre3d_tpu_torch.data.draws import Draws
from unipre3d_tpu_torch.training import tester as T
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def scene(n=400, seed=0, K=3):
    rng = np.random.default_rng(seed)
    coord = rng.uniform(0, 1.0, (n, 3)).astype(np.float32)
    return {"coord": coord, "feat": coord.copy(),
            "color": rng.uniform(0, 255, (n, 3)).astype(np.float32),
            "segment": np.minimum((coord[:, 0] * K).astype(np.int64), K - 1)}


W = np.random.default_rng(9).normal(size=(3, 3)).astype(np.float32)


def jax_predict(d):
    return d["coord"] @ W


def port_predict(d):
    return torch.from_numpy(d["coord"] @ W)


TTA = [[], [["RandomRotate", {"angle": [-1, 1], "axis": "z", "p": 0.5}],
            ["RandomScale", {"scale": [0.8, 1.2]}],
            ["RandomJitter", {"sigma": 0.01}]]]


def same_record(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))


@pytest.mark.parametrize("grid", [0.05, 0.2])
def test_grid_fragments_identical(grid):
    s = scene()
    s["name"] = "x"
    ref = J.grid_fragments(s, grid)
    got = T.grid_fragments(s, grid)
    assert len(got) == len(ref) > 1
    for a, b in zip(ref, got):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))


def test_semseg_tester_matches_jax_with_tta_and_save_path(tmp_path):
    scenes = [scene(400, 0), scene(300, 1)]
    scenes[1]["name"] = "room"
    inverse = np.random.default_rng(3).integers(0, 400, 900)
    scenes[0]["inverse"] = inverse
    scenes[0]["origin_segment"] = scenes[0]["segment"][inverse]
    np.random.seed(4)
    random.seed(4)
    ref = J.SemSegTester(3, jax_predict, 0.1, TTA,
                         save_path=str(tmp_path / "jax")).test(scenes)
    got = T.SemSegTester(3, port_predict, 0.1, TTA,
                         save_path=str(tmp_path / "port")).test(
        scenes, Draws.seeded(4))
    same_record(ref, got)
    for name in ("scene0000_pred.npy", "room_pred.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      np.load(tmp_path / "jax" / name))
    assert np.load(tmp_path / "port" / "scene0000_pred.npy").shape == (900,)


def cls_examples(n=12, K=4):
    rng = np.random.default_rng(5)
    return [{"coord": rng.normal(size=(32, 3)).astype(np.float32),
             "category": i % K} for i in range(n)]


def cls_logits(d):
    return np.tanh(d["coord"]).sum(0) @ np.random.default_rng(1).normal(
        size=(3, 4)).astype(np.float32)


def test_cls_tester_matches_jax():
    exs = cls_examples()
    ref = J.ClsTester(4, cls_logits).test(exs)
    got = T.ClsTester(4, lambda d: torch.from_numpy(cls_logits(d))).test(exs)
    same_record(ref, got)


def test_cls_voting_tester_matches_jax():
    exs = cls_examples()
    aug = [[], [["RandomScale", {"scale": [0.5, 1.5]}]],
           [["RandomRotate", {"angle": [-1, 1], "axis": "z", "p": 1.0}]]]
    np.random.seed(6)
    random.seed(6)
    ref = J.ClsVotingTester(4, cls_logits, num_repeat=3,
                            aug_transforms=aug).test(exs)
    got = T.ClsVotingTester(4, lambda d: torch.from_numpy(cls_logits(d)),
                            num_repeat=3, aug_transforms=aug).test(
        exs, Draws.seeded(6))
    same_record(ref, got)


def test_partseg_tester_matches_jax():
    categories = ["chair", "table", "lamp"]
    c2p = {"chair": [0, 1], "table": [2, 3], "lamp": [4, 5, 6]}
    rng = np.random.default_rng(7)
    exs = []
    for i in range(6):
        coord = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
        ci = i % 2            # no lamp: its category mean counts 0
        parts = c2p[categories[ci]]
        exs.append({"coord": coord, "cls_token": ci,
                    "segment": np.asarray(parts)[(coord[:, 0] > 0)
                                                 .astype(int)]})
    Wp = rng.normal(size=(3, 7)).astype(np.float32)
    aug = [[], [["RandomJitter", {"sigma": 0.05}]]]
    np.random.seed(8)
    random.seed(8)
    ref = J.PartSegTester(7, lambda d: d["coord"] @ Wp, categories, c2p,
                          aug).test(exs)
    got = T.PartSegTester(7, lambda d: torch.from_numpy(d["coord"] @ Wp),
                          categories, c2p, aug).test(exs, Draws.seeded(8))
    same_record(ref, got)


def test_draws_per_scene_do_not_depend_on_the_scenes_before(tmp_path):
    """With a function of the scene's position as ``draws``, a scene's TTA
    is the one it gets alone."""
    s0, s1 = scene(200, 0), scene(200, 1)
    s0["name"], s1["name"] = "a", "b"
    T.SemSegTester(3, port_predict, 0.1, TTA, save_path=str(tmp_path)).test(
        [s0, s1], lambda i: Draws.seeded(100 + i))
    alone = T.SemSegTester(3, port_predict, 0.1, TTA).test_scene(
        s1, Draws.seeded(101))[0]
    np.testing.assert_array_equal(np.load(tmp_path / "b_pred.npy"), alone)
