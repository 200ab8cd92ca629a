"""ShapeNet multi-view dataset reader (the reference's on-disk layout).

Port of unipre3d_tpu/data/shapenet.py. Reads
``<root>/<class>/<object>/easy/NNN.png`` renders with their ``NNN.txt``
4x4 c2w poses and ``<object>/pts/*`` point clouds:

* a seeded 75/20/5 train/val/test split (``random_seed + 1``);
* per object: the cloud centred, subsampled by farthest point sampling to
  ``data.num_points`` (the port's FPS, ops/point_ops.py, on ``device``;
  once per object, cached), axes remapped ``(2, 0, 1)`` with the new x and
  z negated; images resized to ``training_resolution``, clamped to
  [0, 1];
* ``train``: a random pick of ``imgs_per_obj`` views, the first
  ``input_images`` repeated as conditioning views; ``val``: every view,
  conditioning views first; ``test``: the 400-pose continuous orbit with
  the real renders tiled as placeholders;
* the train rotation augmentation (x and y jitter within +-0.01 pi, a z
  spin within +-2 pi, multiplied in random order) re-derives every camera
  from the rotated w2c extrinsics;
* the gravity channel for 4-channel backbones;
* a missing or corrupt object is replaced by a random other one (up to 8
  tries).

Random draws come from the ``Draws`` an example is read with
(data/draws.py), where the JAX reader draws from the global ``random`` and
``np.random``; seeded alike they draw the same. PIL reads the images and
is imported when the first object is read.
"""

from __future__ import annotations

import glob
import math
import os
import random
from typing import Dict, List

import numpy as np
import torch

from unipre3d_tpu_torch import resolve_device
from unipre3d_tpu_torch.data.draws import Draws
from unipre3d_tpu_torch.ops.point_ops import furthest_point_sample
from unipre3d_tpu_torch.utils import camera as cam_util

FILE_TITLE = "easy"
TRAIN_SPLIT_RATIO = 0.75
VAL_SPLIT_RATIO = 0.2
CAMERA_DISTANCE = 1.75
MAX_RETRIES = 8


def import_pil_image():
    """PIL's ``Image``; real data needs the Pillow package."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading ShapeNet or ScanNet images needs the "
                          "Pillow package (PIL)") from e
    return Image


def generate_continuous_pose(num: int = 200) -> np.ndarray:
    """The test orbit's c2w poses: two pitch sweeps (0 -> 20 and 20 -> 90
    degrees), each zipped with a full -180..180 roll; 2 * num matrices."""
    rolls = np.linspace(-180.0, 180.0, num)
    pitches = np.concatenate([np.linspace(0.0, 20.0, num),
                              np.linspace(20.0, 90.0, num)])
    rolls = np.concatenate([rolls, rolls])
    out = []
    for roll, pitch in zip(rolls, pitches):
        az = math.radians(roll)
        el = math.radians(pitch - 90.0)
        sa, ca = math.sin(az), math.cos(az)
        se, ce = math.sin(el), math.cos(el)
        R = np.array([[ca, ce * sa, se * sa],
                      [-sa, ce * ca, se * ca],
                      [0.0, -se, ce]])
        t = np.array([-CAMERA_DISTANCE * se * sa,
                      -CAMERA_DISTANCE * se * ca,
                      -CAMERA_DISTANCE * ce])
        m = np.eye(4)
        m[:3, :3] = R
        m[:3, 3] = t
        out.append(m)
    return np.asarray(out, dtype=np.float64)


def _rotation_matrix(axis_ind: int, theta: float) -> np.ndarray:
    axis = np.zeros(3)
    axis[axis_ind] = 1.0
    K = np.cross(np.eye(3), axis * theta)
    # the exponential of a cross-product matrix is Rodrigues' rotation
    from scipy.linalg import expm
    return expm(K)


class ShapeNetDataset:
    """One split of a ShapeNet tree; ``get(index, draws)`` reads an example
    with the given random sources (the loader's), ``dataset[index]`` with
    sources seeded by the index."""

    takes_draws = True

    def __init__(self, cfg, split: str = "train", device=None):
        self.cfg = cfg
        self.split = split
        self.device = resolve_device(device)
        self.res = int(cfg.data.training_resolution)
        self.num_points = int(cfg.data.get("num_points", 1024))
        self.imgs_per_obj = int(cfg.opt.imgs_per_obj)
        self.input_images = int(cfg.data.input_images)
        self.fov = float(cfg.data.fov)
        self.znear, self.zfar = float(cfg.data.znear), float(cfg.data.zfar)
        self.aug = bool(cfg.model.aug) and split == "train"
        self.in_channels = int(cfg.model.in_channels)

        root = cfg.data.dataset_root
        metadata: List[str] = []
        for lvl1 in sorted(f.path for f in os.scandir(root) if f.is_dir()):
            metadata.extend(sorted(
                f.path for f in os.scandir(lvl1) if f.is_dir()))
        metadata = sorted(metadata)
        random.Random(int(cfg.general.random_seed) + 1).shuffle(metadata)
        n_train = int(len(metadata) * TRAIN_SPLIT_RATIO)
        n_val = int(len(metadata) * VAL_SPLIT_RATIO)
        if split == "train":
            self.metadata = metadata[:n_train]
        elif split == "val":
            self.metadata = metadata[n_train:n_train + n_val]
        else:
            self.metadata = metadata[n_train + n_val:]

        self._cache: Dict[str, dict] = {}
        fov_r = math.radians(self.fov)
        self._proj = cam_util.get_projection_matrix(
            self.znear, self.zfar, fov_r, fov_r).T
        self._orbit_w2cs = None
        if split == "test":
            c2ws = generate_continuous_pose(200)
            self._orbit_w2cs = np.stack(
                [np.linalg.inv(m) for m in c2ws]).astype(np.float32)

    def __len__(self):
        return len(self.metadata)

    def _load_object(self, obj_dir: str) -> dict:
        if obj_dir in self._cache:
            return self._cache[obj_dir]
        Image = import_pil_image()
        rgb_paths = sorted(glob.glob(os.path.join(obj_dir, FILE_TITLE,
                                                  "*.png")))
        pose_paths = sorted(glob.glob(os.path.join(obj_dir, FILE_TITLE,
                                                   "[0-9]*.txt")))
        pts_paths = sorted(glob.glob(os.path.join(obj_dir, "pts", "*")))
        if not rgb_paths or len(rgb_paths) != len(pose_paths):
            raise ValueError(f"{obj_dir}: {len(rgb_paths)} renders, "
                             f"{len(pose_paths)} poses")

        images, w2cs = [], []
        for rp, pp in zip(rgb_paths, pose_paths):
            img = Image.open(rp).resize((self.res, self.res))
            arr = np.asarray(img, dtype=np.float32) / 255.0
            images.append(np.clip(arr[..., :3], 0, 1).transpose(2, 0, 1))
            c2w = np.loadtxt(pp).reshape(4, 4)
            w2cs.append(np.linalg.inv(c2w).astype(np.float32))

        obj = {"images": np.stack(images), "w2cs": np.stack(w2cs),
               "points": self._load_points(pts_paths[0])}
        self._cache[obj_dir] = obj
        return obj

    def _load_points(self, path: str) -> np.ndarray:
        if path.endswith(".npy"):
            data = np.load(path)
        elif path.endswith(".txt"):
            data = np.loadtxt(path, delimiter=",")
        else:
            raise ValueError(f"unsupported point file: {path}")
        data = data[:, :3].astype(np.float32)
        data -= data.mean(axis=0, keepdims=True)
        with torch.no_grad():
            idx = furthest_point_sample(
                torch.as_tensor(data[None], device=self.device),
                self.num_points)[0].cpu().numpy()
        data = data[idx]
        # axis remap (2, 0, 1) with sign flips
        data = data[:, (2, 0, 1)].copy()
        data[:, 0] *= -1
        data[:, 2] *= -1
        return data

    def _camera_tensors(self, w2cs: np.ndarray) -> dict:
        wv, vw, fp, cc = [], [], [], []
        for w2c in w2cs:
            R = w2c[:3, :3].T   # stored transposed
            T = w2c[:3, 3]
            wvt = cam_util.get_world2view(R, T).T
            wv.append(wvt)
            vw.append(np.linalg.inv(wvt.astype(np.float64)).astype(np.float32))
            fp.append(wvt @ self._proj)
            cc.append(np.linalg.inv(
                wvt.astype(np.float64))[3, :3].astype(np.float32))
        return {"world_view_transforms": np.stack(wv).astype(np.float32),
                "view_to_world_transforms": np.stack(vw),
                "full_proj_transforms": np.stack(fp).astype(np.float32),
                "camera_centers": np.stack(cc)}

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.get(index, Draws.seeded(index))

    def get(self, index: int, draws: Draws, _retries: int = 0
            ) -> Dict[str, np.ndarray]:
        try:
            obj = self._load_object(self.metadata[index % len(self.metadata)])
        except (OSError, ValueError) as e:
            # a missing or corrupt frame: read a random other object
            if _retries >= MAX_RETRIES:
                raise
            print(f"Warning: {self.metadata[index % len(self.metadata)]}: "
                  f"{e}; resampling", flush=True)
            return self.get(int(draws.np_rng.randint(len(self.metadata))),
                            draws, _retries + 1)

        if self.split == "test" and self._orbit_w2cs is not None:
            # the continuous orbit; the real renders tiled as placeholders
            n_total = len(self._orbit_w2cs)
            rate = -(-n_total // obj["images"].shape[0])
            images = np.tile(obj["images"], (rate, 1, 1, 1))[:n_total]
            w2cs_all = self._orbit_w2cs
        else:
            images = obj["images"]
            w2cs_all = obj["w2cs"]
        V = images.shape[0]

        if self.split == "train":
            sel = draws.np_rng.permutation(V)[:self.imgs_per_obj]
            idx = np.concatenate([sel[:self.input_images], sel])
        else:
            cond = list(range(self.input_images))
            rest = [i for i in range(V) if i not in cond]
            idx = np.asarray(cond + rest)

        pts = obj["points"].copy()
        w2cs = w2cs_all[idx].copy()

        if self.aug:
            angles = np.array([0.01, 0.01, 2.0]) * np.pi
            mats = [_rotation_matrix(i, draws.np_rng.uniform(-a, a))
                    for i, a in enumerate(angles)]
            draws.np_rng.shuffle(mats)
            rot = (mats[0] @ mats[1] @ mats[2]).astype(np.float32)
            pts = pts @ rot.T
            S = np.eye(4, dtype=np.float32)
            S[:3, :3] = rot
            S_inv = np.linalg.inv(S)
            w2cs = np.asarray([w @ S_inv for w in w2cs], dtype=np.float32)

        cams = self._camera_tensors(w2cs)
        if self.in_channels == 4:
            grav = pts[:, 1:2] - pts[:, 1].min()
            pts = np.concatenate([pts, grav], axis=1)

        out = {"gt_images": images[idx], "point_cloud": pts}
        out.update(cams)
        return out
