"""ScanNet v2 scene dataset reader (the reference's on-disk layout).

Port of unipre3d_tpu/data/scannet.py. Reads

* ``<pts_root>/<split>/<scene>/{coord,color,normal,segment20,instance}.npy``
  (pointcept-preprocessed assets)
* ``<rgb_root>/{color,pose,depth}/<scene>/NNN.{jpg,txt,png}`` frame dirs

Behavior parity:

* poses recentred by the cloud centroid;
* a fixed 160x120 intrinsic fx = fy ~= 144.47 with resize adjustment
  (``LinkCreator``); per-frame depth unprojection to world coordinates with
  a validity channel;
* frame selection: the sequence split into ``input_images`` (8)
  subsequences, one GT frame each, plus a neighbouring reference frame
  within +-``supervised_max_distance``;
* the transform pipeline (data/transforms.py): train with ``model.aug`` =
  CenterShift / RandomRotate(z, x, y) / Jitter / Chromatic* /
  GridSample(2 cm) / CenterShift(xy) / NormalizeColor / Collect, else
  GridSample / NormalizeColor / Collect; for PTv3 then ``FPS``, which
  caps the cloud at ``data.max_points`` (C++ host FPS, ties to the lowest
  index);
* every example padded to ``data.max_points`` with a validity mask, in the
  scene schema the trainer takes (``point_cloud`` dict, camera stacks,
  ``unprojected_coords``).

Random draws (frame choice, transforms, the resample of a scene with too
few frames) come from the ``Draws`` an example is read with
(data/draws.py), where the JAX reader draws from the global ``random`` and
``np.random``. PIL reads the images.
"""

from __future__ import annotations

import glob
import math
import os
import re
from typing import Dict, List

import numpy as np

from unipre3d_tpu_torch.data import transforms as T
from unipre3d_tpu_torch.data.draws import Draws
from unipre3d_tpu_torch.data.shapenet import import_pil_image
from unipre3d_tpu_torch.utils import camera as cam_util

VALID_ASSETS = ("coord", "color", "normal", "segment20", "segment200",
                "instance")


class LinkCreator:
    """Depth-unprojection helper."""

    def __init__(self, fx=144.46765125, fy=144.46765125, mx=79.5, my=59.5,
                 image_dim=(160, 120)):
        intrinsic = np.eye(4)
        intrinsic[0, 0], intrinsic[1, 1] = fx, fy
        intrinsic[0, 2], intrinsic[1, 2] = mx, my
        self.intrinsic = self._adjust(intrinsic, image_dim, (160, 120))
        self.image_dim = image_dim

    @staticmethod
    def _adjust(intrinsic, intrinsic_image_dim, image_dim):
        if intrinsic_image_dim == image_dim:
            return intrinsic
        resize_width = int(math.floor(
            image_dim[1] * float(intrinsic_image_dim[0])
            / float(intrinsic_image_dim[1])))
        intrinsic[0, 0] *= resize_width / float(intrinsic_image_dim[0])
        intrinsic[1, 1] *= image_dim[1] / float(intrinsic_image_dim[1])
        intrinsic[0, 2] *= (image_dim[0] - 1) / (intrinsic_image_dim[0] - 1)
        intrinsic[1, 2] *= (image_dim[1] - 1) / (intrinsic_image_dim[1] - 1)
        return intrinsic

    def compute_unprojection(self, camera_to_world: np.ndarray,
                             depth: np.ndarray) -> np.ndarray:
        """c2w (transposed storage, row-vector convention) + depth [H, W]
        -> [H, W, 4] world xyz + validity."""
        H, W = depth.shape
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        z = depth
        x = (u - self.intrinsic[0, 2]) * z / self.intrinsic[0, 0]
        y = (v - self.intrinsic[1, 2]) * z / self.intrinsic[1, 1]
        cam = np.stack([x, y, z, np.ones_like(z)], axis=-1).reshape(-1, 4)
        world = cam @ camera_to_world  # row-vector convention
        valid = cam[:, 2] > 5e-2
        out = np.concatenate(
            [world[:, :3], valid[:, None].astype(np.float32)], axis=1)
        return out.reshape(H, W, 4).astype(np.float32)


def extract_number(filename: str) -> int:
    m = re.search(r"\d+", os.path.basename(filename))
    return int(m.group()) if m else -1


class ScanNetDataset:
    """One split of a ScanNet tree; ``get(index, draws)`` reads an example
    with the given random sources (the loader's), ``dataset[index]`` with
    sources seeded by the index."""

    takes_draws = True

    def __init__(self, cfg, split: str = "train", device=None):
        self.cfg = cfg
        self.split = split
        self.pts_root = cfg.data.pts_dataset_root
        self.rgb_root = cfg.data.rgb_dataset_root
        self.W = int(cfg.data.training_width)
        self.H = int(cfg.data.training_height)
        self.input_images = int(cfg.data.input_images)
        self.max_points = int(cfg.data.get("max_points", 80000))
        self.use_ref_images = bool(cfg.data.get("use_neighbor_imgs", True))
        self.supervised_max_distance = int(
            cfg.data.get("supervised_max_distance", 5))

        split_dir = {"train": "train", "val": "val", "test": "val"}[split]
        self.metadata = sorted(
            glob.glob(os.path.join(self.pts_root, split_dir, "*")))
        if not self.metadata:
            raise FileNotFoundError(
                f"no ScanNet scenes under {self.pts_root}/{split_dir}")

        self.link_creator = LinkCreator(image_dim=(self.W, self.H))
        # fov from the intrinsic
        K = self.link_creator.intrinsic
        self.fovx = math.degrees(2 * math.atan2(K[0, 2], K[0, 0]))
        self.fovy = math.degrees(2 * math.atan2(K[1, 2], K[1, 1]))
        self.projection_matrix = cam_util.get_projection_matrix(
            float(cfg.data.znear), float(cfg.data.zfar),
            math.radians(self.fovx), math.radians(self.fovy)).T

        self.transforms = self._make_transforms()
        self._cache: Dict[str, Dict] = {}

    # ------------------------------------------------------------------
    def _make_transforms(self) -> List:
        aug = bool(self.cfg.model.get("aug", False))
        grid = T.GridSample(grid_size=0.02, hash_type="fnv", mode="train",
                            keys=("coord", "color", "normal", "segment"),
                            return_grid_coord=True, return_inverse=True)
        if aug and self.split == "train":
            tfs = [
                T.CenterShift(apply_z=True, keys=["extrinsic"]),
                T.RandomRotate(angle=[-1, 1], axis="z", center=[0, 0, 0],
                               p=0.5, keys=["extrinsic"]),
                T.RandomRotate(angle=[-1 / 64, 1 / 64], axis="x", p=0.5,
                               keys=["extrinsic"]),
                T.RandomRotate(angle=[-1 / 64, 1 / 64], axis="y", p=0.5,
                               keys=["extrinsic"]),
                T.RandomJitter(sigma=0.005, clip=0.02),
                T.ChromaticAutoContrast(p=0.2, blend_factor=None),
                T.ChromaticTranslation(p=0.95, ratio=0.05),
                T.ChromaticJitter(p=0.95, std=0.05),
                grid,
                T.CenterShift(apply_z=False, keys=["extrinsic"]),
                T.NormalizeColor(),
            ]
        else:
            tfs = [grid, T.NormalizeColor()]
        tfs.append(T.Collect(
            keys=("coord", "grid_coord", "segment", "inverse"),
            stack_keys=("extrinsic", "gt_images", "depth"),
            feat_keys=("normal", "color")))
        if self.cfg.model.backbone_type == "ptv3":
            tfs.append(T.FPS(max_points=self.max_points))
        return tfs

    # ------------------------------------------------------------------
    def _load_scene(self, metadata_path: str) -> Dict:
        scene = os.path.basename(metadata_path)
        if scene in self._cache:
            return self._cache[scene]

        data = {}
        for asset in os.listdir(metadata_path):
            name = asset[:-4]
            if asset.endswith(".npy") and name in VALID_ASSETS:
                data[name] = np.load(os.path.join(metadata_path, asset))
        coord = data["coord"].astype(np.float32)
        center = coord.mean(axis=0)
        coord = coord - center

        segment = data.get("segment20", data.get(
            "segment200", -np.ones(len(coord)))).reshape(-1).astype(np.int32)
        instance = data.get("instance",
                            -np.ones(len(coord))).reshape(-1).astype(np.int32)

        rgb_paths = sorted(glob.glob(os.path.join(
            self.rgb_root, "color", scene, "*.jpg")), key=extract_number)
        pose_paths = sorted(glob.glob(os.path.join(
            self.rgb_root, "pose", scene, "*.txt")), key=extract_number)
        depth_paths = sorted(glob.glob(os.path.join(
            self.rgb_root, "depth", scene, "*.png")), key=extract_number)
        if not len(rgb_paths) == len(pose_paths) == len(depth_paths):
            raise ValueError(f"mismatched frame counts in {scene}")

        Image = import_pil_image()
        rgbs, w2cs, wvts, v2ws, fpts, ccs, unprojs, depths = \
            [], [], [], [], [], [], [], []
        for rgb_p, pose_p, depth_p in zip(rgb_paths, pose_paths,
                                          depth_paths):
            c2w = np.loadtxt(pose_p).reshape(4, 4)
            if not np.isfinite(c2w).all():
                continue
            c2w[:3, 3] -= center  # recenter like the cloud
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])  # c2w rotation
            t_vec = w2c[:3, 3]

            img = Image.open(rgb_p).convert("RGB").resize((self.W, self.H))
            rgbs.append(np.asarray(img, dtype=np.float32).transpose(2, 0, 1)
                        / 255.0)
            # depth png: millimeters uint16
            dimg = Image.open(depth_p).resize((self.W, self.H),
                                              Image.NEAREST)
            depth = np.asarray(dimg, dtype=np.float32) / 1000.0
            depths.append(depth)

            wvt = cam_util.get_world2view(R, t_vec).T
            v2w = np.linalg.inv(wvt.astype(np.float64)).astype(np.float32)
            wvts.append(wvt)
            v2ws.append(v2w)
            fpts.append((wvt @ self.projection_matrix).astype(np.float32))
            ccs.append(np.linalg.inv(wvt.astype(np.float64))[3, :3]
                       .astype(np.float32))
            w2cs.append(w2c.astype(np.float32))
            unprojs.append(self.link_creator.compute_unprojection(v2w,
                                                                  depth))

        ex = {
            "coord": coord, "color": data["color"].astype(np.float32),
            "normal": data["normal"].astype(np.float32),
            "segment": segment, "instance": instance,
            "rgbs": np.stack(rgbs) if rgbs else np.zeros((0,)),
            "w2c": np.stack(w2cs) if w2cs else np.zeros((0,)),
            "world_view_transforms": np.stack(wvts),
            "view_to_world_transforms": np.stack(v2ws),
            "full_proj_transforms": np.stack(fpts),
            "camera_centers": np.stack(ccs),
            "unprojected_coords": np.stack(unprojs),
            "depth": np.stack(depths),
        }
        if bool(self.cfg.data.get("record_img", True)):
            self._cache[scene] = ex
        return ex

    # ------------------------------------------------------------------
    def _select_frames(self, num_images: int, draws: Draws) -> List[int]:
        """GT frames (one per subsequence) and their reference frames."""
        choice = draws.py_rng.choice
        n_in = self.input_images
        sub_len, rem = divmod(num_images, n_in)
        subs, start = [], 0
        for i in range(n_in):
            end = start + sub_len + (1 if i < rem else 0)
            subs.append(list(range(start, end)))
            start = end
        if self.split in ("train", "val"):
            gt_idxs = [choice(s) for s in subs]
        else:
            gt_idxs = list(range(num_images))
        if not self.use_ref_images:
            return gt_idxs
        refs = []
        for idx in (gt_idxs if self.split in ("train", "val")
                    else [choice(s) for s in subs]):
            lo = max(0, idx - self.supervised_max_distance)
            hi = min(num_images, idx + self.supervised_max_distance + 1)
            cands = [i for i in range(lo, hi) if i != idx]
            refs.append(choice(cands) if cands else idx)
        if self.split in ("train", "val"):
            return refs + gt_idxs
        return refs + gt_idxs

    # ------------------------------------------------------------------
    def _pad(self, arr: np.ndarray, fill=0) -> np.ndarray:
        M = self.max_points
        n = len(arr)
        if n >= M:
            return arr[:M]
        pad_shape = (M - n, *arr.shape[1:])
        return np.concatenate(
            [arr, np.full(pad_shape, fill, dtype=arr.dtype)])

    def __len__(self):
        return len(self.metadata)

    def __getitem__(self, index: int) -> Dict:
        return self.get(index, Draws.seeded(index))

    def get(self, index: int, draws: Draws) -> Dict:
        ex = self._load_scene(self.metadata[index])
        num_images = len(ex["rgbs"])
        if num_images < 2 * self.input_images:
            return self.get(draws.py_rng.randint(0, len(self.metadata) - 1),
                            draws)
        frame_idxs = self._select_frames(num_images, draws)

        pts = {
            "coord": ex["coord"].copy(), "color": ex["color"].copy(),
            "normal": ex["normal"].copy(), "segment": ex["segment"].copy(),
            "instance": ex["instance"].copy(),
            "extrinsic": ex["w2c"][frame_idxs].copy(),
            "gt_images": ex["rgbs"][frame_idxs].copy(),
            "depth": ex["depth"][frame_idxs].copy(),
        }
        pts = T.Compose(self.transforms)(pts, draws)

        n = len(pts["coord"])
        mask = np.zeros(self.max_points, bool)
        mask[:min(n, self.max_points)] = True
        point_cloud = {
            "coord": self._pad(pts["coord"].astype(np.float32)),
            "grid_coord": self._pad(pts["grid_coord"].astype(np.int32)),
            "feat": self._pad(pts["feat"].astype(np.float32)),
            "mask": mask,
            "min_coord": np.asarray(pts.get(
                "min_coord", pts["coord"].min(axis=0)), dtype=np.float32),
        }
        n_in = self.input_images
        unproj = ex["unprojected_coords"][frame_idxs[:n_in]].astype(
            np.float32)
        cams = {
            "world_view_transforms":
                ex["world_view_transforms"][frame_idxs],
            "view_to_world_transforms":
                ex["view_to_world_transforms"][frame_idxs],
            "full_proj_transforms": ex["full_proj_transforms"][frame_idxs],
            "camera_centers": ex["camera_centers"][frame_idxs],
        }
        if bool(self.cfg.model.get("aug", False)) and self.split == "train":
            # the camera tensors and the unprojections re-derived from the
            # transform-updated extrinsics
            cams = self._cameras_from_extrinsics(pts["extrinsic"])
            S = np.linalg.inv(pts["extrinsic"][0].astype(np.float64)) @ \
                ex["w2c"][frame_idxs[0]].astype(np.float64)
            xyz = unproj[..., :3]
            xyz = xyz @ S[:3, :3].T + S[:3, 3]
            unproj = np.concatenate(
                [xyz.astype(np.float32), unproj[..., 3:]], axis=-1)
        return {
            "point_cloud": point_cloud,
            "gt_images": pts["gt_images"].astype(np.float32),
            "unprojected_coords": unproj,
            **cams,
        }

    def _cameras_from_extrinsics(self, w2cs: np.ndarray) -> Dict:
        wvts, v2ws, fpts, ccs = [], [], [], []
        for w2c in w2cs.astype(np.float64):
            R = np.transpose(w2c[:3, :3])
            t_vec = w2c[:3, 3]
            wvt = cam_util.get_world2view(R, t_vec).T
            wvts.append(wvt)
            v2ws.append(np.linalg.inv(wvt.astype(np.float64))
                        .astype(np.float32))
            fpts.append((wvt @ self.projection_matrix).astype(np.float32))
            ccs.append(np.linalg.inv(wvt.astype(np.float64))[3, :3]
                       .astype(np.float32))
        return {
            "world_view_transforms": np.stack(wvts),
            "view_to_world_transforms": np.stack(v2ws),
            "full_proj_transforms": np.stack(fpts),
            "camera_centers": np.stack(ccs),
        }
