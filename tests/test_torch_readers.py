"""PyTorch port vs the JAX package: the ShapeNet and ScanNet readers, their
transforms, the dataset factory and the prefetching loader.

Fabricated trees under a temporary directory, built as in
tests/test_shapenet_loader.py and tests/test_transforms_scannet.py (no
dataset is in the repository), go through both packages' readers. The
readers are numpy on both sides (the port's FPS is torch, held to JAX's by
tests/test_torch_point_ops.py), so examples are compared exactly:

* ``val`` and ``test`` examples, array for array;
* ``train`` examples with the augmentations on (the ShapeNet rotation, the
  ScanNet transform pipeline and frame choice), the gravity channel and
  two conditioning views, and the resample of a broken object: JAX draws
  from the global ``random`` / ``np.random``, seeded with ``s``, the port
  from ``Draws.seeded(s)``;
* the PTv3 ScanNet pipeline, whose ``FPS`` caps the cloud (the C++ host
  FPS of each package; tests/test_torch_host_ops.py holds the port's to
  its numpy reference);
* each ported transform on the same input and seed; the point-file
  loaders (.npy, .txt, .ply) and the camera-info reader;
* the prefetching ``Loader`` yields the batches of the in-order path, with
  one worker, four or sixteen (more threads than the host's cores, the
  interpreter switching every 10 us, all filling one reader's cache), and
  resumes at the same batch;
* a root that is not a directory raises in the port (JAX falls back to the
  synthetic set: a held difference);
* the CLI trains a step on a fabricated ShapeNet tree
  (``data.dataset_root``) and on a fabricated ScanNet tree
  (``data.pts_dataset_root``), at the defaults (bfloat16, the cache on).
"""

import itertools
import math
import os
import random
import sys

import numpy as np
import pytest
from PIL import Image as PIL

from unipre3d_tpu.data import dataset_factory as jfactory
from unipre3d_tpu.data import dataset_readers as jreaders
from unipre3d_tpu.data import io as jio
from unipre3d_tpu.data import scannet as jscannet
from unipre3d_tpu.data import shapenet as jshapenet
from unipre3d_tpu.data import transforms as JT
from unipre3d_tpu.data.synthetic import SyntheticDataset as JSynthetic
from unipre3d_tpu.training.config import load_config as jload_config
from unipre3d_tpu_torch import train_network
from unipre3d_tpu_torch.data import Draws, Loader, get_dataset
from unipre3d_tpu_torch.data import dataset_readers as treaders
from unipre3d_tpu_torch.data import io as tio
from unipre3d_tpu_torch.data import scannet as tscannet
from unipre3d_tpu_torch.data import shapenet as tshapenet
from unipre3d_tpu_torch.data import transforms as TT
from unipre3d_tpu_torch.training.config import load_config
from test_torch_utils import (  # noqa: F401
    one_torch_thread, run_dir, trimmed_heap)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPENET_SMALL = ["data.training_resolution=32", "data.num_points=256"]
SCANNET_SMALL = ["data.training_width=32", "data.training_height=32",
                 "data.max_points=1024", "data.input_images=2"]


def assert_examples_equal(a, b, where=""):
    assert set(a) == set(b), where
    for k in a:
        if isinstance(a[k], dict):
            assert_examples_equal(a[k], b[k], f"{where}{k}.")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{where}{k}")


def jax_draws(seed):
    np.random.seed(seed)
    random.seed(seed)


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    """Two classes of five objects, four 48x48 views each: a 7 / 2 / 1
    train / val / test split."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("readers") / "shapenet"
    for cls in ("02691156", "03001627"):
        for o in range(5):
            d = root / cls / f"obj_{o}"
            (d / "easy").mkdir(parents=True)
            (d / "pts").mkdir()
            for v in range(4):
                PIL.fromarray(rng.integers(0, 255, (48, 48, 4),
                                           dtype=np.uint8)).save(
                    d / "easy" / f"{v:03d}.png")
                az = 2 * np.pi * v / 4
                c2w = np.eye(4)
                c2w[:3, :3] = [[np.cos(az), 0, -np.sin(az)], [0, 1, 0],
                               [np.sin(az), 0, np.cos(az)]]
                c2w[:3, 3] = [0, 0, 1.75]
                np.savetxt(d / "easy" / f"{v:03d}.txt", c2w)
            np.save(d / "pts" / "cloud.npy",
                    rng.uniform(-1, 1, (600, 6)).astype(np.float32))
    return str(root)


@pytest.fixture(scope="module")
def scannet_roots(tmp_path_factory):
    """One scene of 2,000 points and 8 frames, under ``train`` and
    ``val``."""
    rng = np.random.default_rng(0)
    base = tmp_path_factory.mktemp("readers")
    pts_root, rgb_root = base / "pts", base / "rgb"
    scene = "scene0000_00"
    n = 2000
    assets = {"coord": rng.uniform(0, 2, (n, 3)).astype(np.float32),
              "color": rng.uniform(0, 255, (n, 3)).astype(np.float32),
              "normal": rng.normal(size=(n, 3)).astype(np.float32),
              "segment20": rng.integers(0, 20, n),
              "instance": rng.integers(0, 5, n)}
    for split in ("train", "val"):
        sdir = pts_root / split / scene
        sdir.mkdir(parents=True)
        for name, arr in assets.items():
            np.save(sdir / f"{name}.npy", arr)
    for sub in ("color", "pose", "depth"):
        (rgb_root / sub / scene).mkdir(parents=True)
    for i in range(8):
        PIL.fromarray(rng.integers(0, 255, (120, 160, 3),
                                   dtype=np.uint8)).save(
            rgb_root / "color" / scene / f"{i}.jpg")
        c2w = np.eye(4)
        c2w[:3, 3] = [1.0, 1.0, 3.0 + 0.1 * i]
        np.savetxt(rgb_root / "pose" / scene / f"{i}.txt", c2w)
        depth = rng.uniform(500, 3000, (120, 160)).astype(np.uint16)
        PIL.fromarray(depth).save(rgb_root / "depth" / scene / f"{i}.png")
    return str(pts_root), str(rgb_root)


def shapenet_cfgs(root, extra=()):
    over = [f"data.dataset_root={root}"] + SHAPENET_SMALL + list(extra)
    return (jload_config("transformer_pretraining", overrides=over),
            load_config("transformer_pretraining", overrides=over))


def scannet_cfgs(roots, extra=(), config="sparseunet_pretraining"):
    over = [f"data.pts_dataset_root={roots[0]}",
            f"data.rgb_dataset_root={roots[1]}"] + SCANNET_SMALL + list(extra)
    return (jload_config(config, overrides=over),
            load_config(config, overrides=over))


@pytest.mark.parametrize("split", ["val", "test"])
def test_shapenet_val_and_test_examples(shapenet_root, split):
    jcfg, tcfg = shapenet_cfgs(shapenet_root)
    jds = jshapenet.ShapeNetDataset(jcfg, split)
    tds = tshapenet.ShapeNetDataset(tcfg, split, device="cpu")
    assert tds.metadata == jds.metadata and len(tds) == {"val": 2,
                                                         "test": 1}[split]
    for i in range(len(tds)):
        assert_examples_equal(jds[i], tds[i], f"{split}[{i}].")
    if split == "test":
        assert tds[0]["gt_images"].shape == (400, 3, 32, 32)


@pytest.mark.parametrize("extra", [["model.aug=true"],
                                   ["model.in_channels=4"],
                                   ["data.input_images=2", "model.aug=true"]],
                         ids=["rotation_aug", "gravity", "two_views"])
def test_shapenet_train_examples_seeded_alike(shapenet_root, extra):
    jcfg, tcfg = shapenet_cfgs(shapenet_root, extra)
    jds = jshapenet.ShapeNetDataset(jcfg, "train")
    tds = tshapenet.ShapeNetDataset(tcfg, "train", device="cpu")
    assert len(tds) == 7
    for i, seed in ((0, 11), (3, 12), (6, 13)):
        jax_draws(seed)
        a = jds[i]
        b = tds.get(i, Draws.seeded(seed))
        assert_examples_equal(a, b, f"train[{i}].")


def test_shapenet_missing_frames_resample_alike(shapenet_root, tmp_path):
    import shutil
    root = tmp_path / "shapenet"
    shutil.copytree(shapenet_root, root)
    jcfg, tcfg = shapenet_cfgs(str(root))
    jds = jshapenet.ShapeNetDataset(jcfg, "train")
    tds = tshapenet.ShapeNetDataset(tcfg, "train", device="cpu")
    for f in os.listdir(os.path.join(tds.metadata[1], "easy")):
        if f.endswith(".txt"):
            os.remove(os.path.join(tds.metadata[1], "easy", f))
    jax_draws(5)
    a = jds[1]
    b = tds.get(1, Draws.seeded(5))
    assert_examples_equal(a, b)


@pytest.mark.parametrize("split,extra", [("train", ["model.aug=true"]),
                                         ("train", []), ("val", [])],
                         ids=["train_aug", "train", "val"])
def test_scannet_examples_seeded_alike(scannet_roots, split, extra):
    jcfg, tcfg = scannet_cfgs(scannet_roots, extra)
    jds = jscannet.ScanNetDataset(jcfg, split)
    tds = tscannet.ScanNetDataset(tcfg, split)
    for seed in (21, 22):
        jax_draws(seed)
        a = jds[0]
        b = tds.get(0, Draws.seeded(seed))
        assert_examples_equal(a, b, f"{split}.")
    assert b["point_cloud"]["coord"].shape == (1024, 3)
    assert b["unprojected_coords"].shape == (2, 32, 32, 4)


@pytest.mark.parametrize("split", ["train", "val"])
def test_scannet_ptv3_reader_caps_with_fps_alike(scannet_roots, split):
    """The PTv3 pipeline appends ``FPS`` after ``Collect``: the scene's
    ~2,000 voxels are capped at ``max_points`` = 1,024 by farthest point
    sampling (the SpUNet reader truncates instead), equal to JAX's reader
    key by key on the same seed."""
    jcfg, tcfg = scannet_cfgs(scannet_roots, config="ptv3_pretraining")
    jds = jscannet.ScanNetDataset(jcfg, split)
    tds = tscannet.ScanNetDataset(tcfg, split)
    assert isinstance(tds.transforms[-1], TT.FPS)
    jax_draws(21)
    a = jds[0]
    b = tds.get(0, Draws.seeded(21))
    assert_examples_equal(a, b, f"{split}.")
    assert b["point_cloud"]["mask"].all()
    spunet = tscannet.ScanNetDataset(scannet_cfgs(scannet_roots)[1], split)
    c = spunet.get(0, Draws.seeded(21))
    assert not np.array_equal(b["point_cloud"]["coord"],
                              c["point_cloud"]["coord"])


def cloud(n=400, seed=0):
    rng = np.random.default_rng(seed)
    w2c = np.eye(4)
    w2c[:3, 3] = [0.3, -0.2, 2.0]
    return {"coord": rng.uniform(0, 2, (n, 3)),
            "color": rng.uniform(0, 255, (n, 3)),
            "normal": rng.normal(size=(n, 3)),
            "segment": rng.integers(0, 20, n),
            "extrinsic": np.stack([w2c, w2c + 0.01])}


TRANSFORMS = {
    "center_shift": lambda M: M.CenterShift(apply_z=True,
                                            keys=["extrinsic"]),
    "rotate_z": lambda M: M.RandomRotate(angle=[-1, 1], axis="z",
                                         center=[0, 0, 0], p=0.5,
                                         keys=["extrinsic"]),
    "rotate_x_always": lambda M: M.RandomRotate(
        angle=[-1 / 64, 1 / 64], axis="x", always_apply=True,
        keys=["extrinsic"]),
    "jitter": lambda M: M.RandomJitter(sigma=0.005, clip=0.02),
    "auto_contrast": lambda M: M.ChromaticAutoContrast(p=1.0),
    "translation": lambda M: M.ChromaticTranslation(p=0.95, ratio=0.05),
    "chromatic_jitter": lambda M: M.ChromaticJitter(p=0.95, std=0.05),
    "grid_sample": lambda M: M.GridSample(
        grid_size=0.1, hash_type="fnv", mode="train",
        keys=("coord", "color", "normal", "segment"),
        return_grid_coord=True, return_inverse=True),
    "grid_sample_ravel_test": lambda M: M.GridSample(
        grid_size=0.1, hash_type="ravel", mode="test",
        return_grid_coord=True),
    "normalize_color": lambda M: M.NormalizeColor(),
    "fps": lambda M: M.FPS(max_points=150),
    "collect": lambda M: M.Collect(keys=("coord", "segment"),
                                   stack_keys=("extrinsic",),
                                   feat_keys=("normal", "color")),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_equal_on_same_input_and_seed(name):
    for seed in (0, 1, 2):
        jax_draws(seed)
        a = TRANSFORMS[name](JT)(cloud())
        b = TRANSFORMS[name](TT)(cloud(), Draws.seeded(seed))
        assert_examples_equal(a, b, f"{name}[{seed}].")


def test_compose_and_hashes_equal():
    names = ["center_shift", "rotate_z", "jitter", "auto_contrast",
             "grid_sample", "normalize_color", "collect"]
    jax_draws(3)
    a = JT.Compose([TRANSFORMS[n](JT) for n in names])(cloud())
    b = TT.Compose([TRANSFORMS[n](TT) for n in names])(cloud(),
                                                       Draws.seeded(3))
    assert_examples_equal(a, b)
    g = np.random.default_rng(4).integers(-50, 50, (300, 3))
    np.testing.assert_array_equal(JT.fnv_hash_vec(g), TT.fnv_hash_vec(g))
    np.testing.assert_array_equal(JT.ravel_hash_vec(g), TT.ravel_hash_vec(g))


def test_point_files_and_camera_infos_equal(scannet_roots, tmp_path):
    pts = np.random.default_rng(5).uniform(-1, 1, (50, 6)).astype(
        np.float32)
    np.save(tmp_path / "a.npy", pts)
    np.savetxt(tmp_path / "a.txt", pts, delimiter=",")
    jio.save_ply(str(tmp_path / "a.ply"), pts)
    for name in ("a.npy", "a.txt", "a.ply"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(jio.load_points(path),
                                      tio.load_points(path), err_msg=name)
    rgb = os.path.join(scannet_roots[1], "color", "scene0000_00")
    pose = os.path.join(scannet_roots[1], "pose", "scene0000_00")
    images = [os.path.join(rgb, f"{i}.jpg") for i in range(8)]
    poses = [os.path.join(pose, f"{i}.txt") for i in range(8)]
    a = jreaders.read_cameras_from_txt(images, poses, 57.95, 0.75,
                                       moving_centers=np.ones(3))
    b = treaders.read_cameras_from_txt(images, poses, 57.95, 0.75,
                                       moving_centers=np.ones(3))
    assert len(a) == len(b) == 8
    for x, y in zip(a, b):
        for k in x._fields:
            np.testing.assert_array_equal(np.asarray(getattr(x, k)),
                                          np.asarray(getattr(y, k)))


def test_loader_prefetch_equals_in_order_and_resumes(shapenet_root):
    _, tcfg = shapenet_cfgs(shapenet_root, ["model.aug=true"])
    ds = tshapenet.ShapeNetDataset(tcfg, "train", device="cpu")
    in_order = Loader(ds, 2, seed=3, num_workers=1)
    straight = list(in_order.epoch(0)) + list(in_order.epoch(1))
    assert len(straight) == 6
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)      # threads interleave often
    try:
        for workers in (1, 4, 16):   # 16 threads share the reader's cache
            fresh = tshapenet.ShapeNetDataset(tcfg, "train", device="cpu")
            loader = Loader(fresh, 2, seed=3, num_workers=workers)
            it = loader.iter_from(0)
            got = list(itertools.islice(it, 6))
            it.close()
            for a, b in zip(straight, got):
                assert_examples_equal(a, b)
            resumed = loader.iter_from(4)
            assert_examples_equal(straight[4], next(resumed))
            assert_examples_equal(straight[5], next(resumed))
            resumed.close()
            loader.close()
    finally:
        sys.setswitchinterval(interval)


def test_missing_root_raises(tmp_path):
    missing = str(tmp_path / "no_such_tree")
    jcfg, tcfg = shapenet_cfgs(missing)
    with pytest.raises(FileNotFoundError, match="not a directory"):
        get_dataset(tcfg, "train", "cpu")
    # held difference: the JAX factory falls back to the synthetic set
    assert isinstance(jfactory.get_dataset(jcfg, "train"), JSynthetic)


def test_factory_selects_the_real_readers(shapenet_root, scannet_roots):
    _, tcfg = shapenet_cfgs(shapenet_root)
    assert isinstance(get_dataset(tcfg, "val", "cpu"),
                      tshapenet.ShapeNetDataset)
    _, tcfg = scannet_cfgs(scannet_roots)
    assert isinstance(get_dataset(tcfg, "train", "cpu"),
                      tscannet.ScanNetDataset)


def test_cli_trains_on_fabricated_trees(shapenet_root, scannet_roots,
                                        run_dir):
    res = train_network.main(
        ["--config-name", "transformer_pretraining", "--device", "cpu",
         "--output-dir", str(run_dir / "shapenet"), "opt.iterations=1",
         "opt.batch_size=2", f"data.dataset_root={shapenet_root}",
         "model.aug=true",
         "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
         "layers_per_block: 1}", "model.backbone_overrides={depth: 2}"]
        + SHAPENET_SMALL)
    assert res["compute_dtype"] == "bfloat16" and res["hit_rate"] is not None
    assert len(res["losses"]) == 1 and math.isfinite(res["losses"][0])
    assert math.isfinite(res["val"][0]["psnr_novel"])
    res = train_network.main(
        ["--config-name", "sparseunet_pretraining", "--device", "cpu",
         "--output-dir", str(run_dir / "scannet"), "opt.iterations=1",
         "opt.batch_size=1", f"data.pts_dataset_root={scannet_roots[0]}",
         f"data.rgb_dataset_root={scannet_roots[1]}"] + SCANNET_SMALL)
    assert len(res["losses"]) == 1 and math.isfinite(res["losses"][0])
    assert res["nan_skipped"] == [0.0]
