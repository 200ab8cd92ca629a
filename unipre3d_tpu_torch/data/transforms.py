"""Host-side point-cloud transforms of the pretraining readers.

The port's own copy of the part of unipre3d_tpu/data/transforms.py that
the ScanNet pretraining pipeline runs (scannet.py:126-157): ``Compose``,
``Collect``, ``NormalizeColor``, ``CenterShift``, ``RandomRotate``,
``RandomJitter``, ``ChromaticAutoContrast``, ``ChromaticTranslation``,
``ChromaticJitter``, ``GridSample`` with ``fnv_hash_vec`` /
``ravel_hash_vec``, and for PTv3 ``FPS``. Every geometric transform that
moves the cloud also updates the listed camera ``extrinsic`` matrices
(w2c) by right-multiplying them with the inverse world transform, so the
render supervision stays consistent under augmentation.

Each transform is ``t(data_dict, draws)``. The random ones draw from
``draws`` (data/draws.py) where the JAX transforms draw from the global
``random`` and ``np.random``, in the same order and with the same calls,
so equal seeds give equal results. ``FPS`` draws nothing: it caps the
cloud with the C++ host FPS (native/), which breaks ties by the lowest
index. The fine-tuning transforms are not ported yet (ROADMAP.md queue A,
item 16).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from unipre3d_tpu_torch.data.draws import Draws


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, data_dict: Dict, draws: Draws = None) -> Dict:
        for t in self.transforms:
            data_dict = t(data_dict, draws)
        return data_dict


def _apply_world_transform(data_dict, S_inv, keys):
    """Right-multiply each listed camera matrix by the inverse world
    transform."""
    for key in keys:
        mats = data_dict[key]
        data_dict[key] = np.asarray(
            [np.asarray(m) @ S_inv for m in np.asarray(mats)],
            dtype=np.float32)
    return data_dict


class Collect:
    """Assemble ``feat`` from ``feat_keys`` and keep or stack the listed
    keys (and ``min_coord``)."""

    def __init__(self, keys=(), stack_keys=(), feat_keys=("coord",)):
        self.keys = keys
        self.stack_keys = stack_keys
        self.feat_keys = feat_keys

    def __call__(self, data_dict, draws=None):
        out = {k: data_dict[k] for k in self.keys if k in data_dict}
        for k in self.stack_keys:
            if k in data_dict:
                out[k] = np.asarray(data_dict[k])
        out["feat"] = np.concatenate(
            [np.asarray(data_dict[k], dtype=np.float32)
             for k in self.feat_keys], axis=-1)
        for k in ("min_coord",):
            if k in data_dict:
                out[k] = data_dict[k]
        return out


class NormalizeColor:
    """color / 127.5 - 1."""

    def __call__(self, data_dict, draws=None):
        if "color" in data_dict:
            data_dict["color"] = data_dict["color"] / 127.5 - 1.0
        return data_dict


class CenterShift:
    """Shift the cloud's xy centre (and z to its floor with ``apply_z``)
    to the origin, the extrinsics along."""

    def __init__(self, apply_z=True, keys=()):
        self.apply_z = apply_z
        self.keys = keys

    def __call__(self, data_dict, draws=None):
        coord = data_dict["coord"]
        x_min, y_min, z_min = coord.min(axis=0)
        x_max, y_max, _ = coord.max(axis=0)
        shift = np.array([(x_min + x_max) / 2, (y_min + y_max) / 2,
                          z_min if self.apply_z else 0.0])
        data_dict["coord"] = coord - shift
        S = np.eye(4)
        S[:3, 3] = -shift
        return _apply_world_transform(data_dict, np.linalg.inv(S), self.keys)


def _axis_rotation(axis: str, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    raise NotImplementedError(axis)


class _RotateBase:
    def _rotate(self, data_dict, rot_t, keys, center):
        coord = data_dict["coord"]
        if center is None:
            lo, hi = coord.min(axis=0), coord.max(axis=0)
            center = (lo + hi) / 2
        center = np.asarray(center, dtype=np.float64)
        data_dict["coord"] = (coord - center) @ rot_t.T + center
        S1, Sr, S2 = np.eye(4), np.eye(4), np.eye(4)
        S1[:3, 3] = -center
        Sr[:3, :3] = rot_t
        S2[:3, 3] = center
        S_inv = np.linalg.inv(S2 @ Sr @ S1)
        _apply_world_transform(data_dict, S_inv, keys)
        if "normal" in data_dict:
            data_dict["normal"] = data_dict["normal"] @ rot_t.T
        return data_dict


class RandomRotate(_RotateBase):
    """With probability ``p``, rotate about ``axis`` by ``angle`` (a
    range, in units of pi), extrinsics updated."""

    def __init__(self, angle=None, center=None, axis="z",
                 always_apply=False, p=0.5, keys=()):
        self.angle = [-1, 1] if angle is None else angle
        self.axis = axis
        self.p = 1.0 if always_apply else p
        self.center = center
        self.keys = keys

    def __call__(self, data_dict, draws: Draws):
        if draws.py_rng.random() > self.p:
            return data_dict
        angle = draws.np_rng.uniform(self.angle[0], self.angle[1]) * np.pi
        return self._rotate(data_dict, _axis_rotation(self.axis, angle),
                            self.keys, self.center)


class RandomJitter:
    """Gaussian coordinate jitter, clipped."""

    def __init__(self, sigma=0.01, clip=0.05):
        self.sigma = sigma
        self.clip = clip

    def __call__(self, data_dict, draws: Draws):
        j = np.clip(self.sigma * draws.np_rng.randn(
            data_dict["coord"].shape[0], 3), -self.clip, self.clip)
        data_dict["coord"] = data_dict["coord"] + j
        return data_dict


class ChromaticAutoContrast:
    """With probability ``p``, blend toward the contrast-stretched
    colours."""

    def __init__(self, p=0.2, blend_factor=None):
        self.p = p
        self.blend_factor = blend_factor

    def __call__(self, data_dict, draws: Draws):
        if "color" in data_dict and draws.np_rng.rand() < self.p:
            color = data_dict["color"]
            lo = np.min(color, axis=0, keepdims=True)
            hi = np.max(color, axis=0, keepdims=True)
            scale = 255 / np.maximum(hi - lo, 1e-6)
            contrast = (color - lo) * scale
            blend = self.blend_factor if self.blend_factor is not None \
                else draws.np_rng.rand()
            data_dict["color"] = (1 - blend) * color + blend * contrast
        return data_dict


class ChromaticTranslation:
    def __init__(self, p=0.95, ratio=0.05):
        self.p = p
        self.ratio = ratio

    def __call__(self, data_dict, draws: Draws):
        if "color" in data_dict and draws.np_rng.rand() < self.p:
            tr = (draws.np_rng.rand(1, 3) - 0.5) * 255 * 2 * self.ratio
            data_dict["color"] = np.clip(data_dict["color"] + tr, 0, 255)
        return data_dict


class ChromaticJitter:
    def __init__(self, p=0.95, std=0.005):
        self.p = p
        self.std = std

    def __call__(self, data_dict, draws: Draws):
        if "color" in data_dict and draws.np_rng.rand() < self.p:
            noise = draws.np_rng.randn(data_dict["color"].shape[0], 3)
            data_dict["color"] = np.clip(
                data_dict["color"] + noise * self.std * 255, 0, 255)
        return data_dict


def fnv_hash_vec(arr: np.ndarray) -> np.ndarray:
    """FNV64-1A hash of integer coordinate rows."""
    assert arr.ndim == 2
    arr = arr.copy().astype(np.uint64)
    h = np.full(arr.shape[0], 0xCBF29CE484222325, dtype=np.uint64)
    for j in range(arr.shape[1]):
        h *= np.uint64(1099511628211)
        h = np.bitwise_xor(h, arr[:, j])
    return h


def ravel_hash_vec(arr: np.ndarray) -> np.ndarray:
    assert arr.ndim == 2
    arr = arr.copy()
    arr -= arr.min(0)
    arr = arr.astype(np.uint64)
    arr_max = arr.max(0).astype(np.uint64) + 1
    h = np.zeros(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1] - 1):
        h += arr[:, j]
        h *= arr_max[j + 1]
    h += arr[:, -1]
    return h


class GridSample:
    """Voxel dedup: in ``train`` mode one random point per occupied voxel
    (fnv hashing by default), optionally emitting ``grid_coord``,
    ``inverse`` and the shared ``min_coord``; ``test`` mode keeps every
    point."""

    def __init__(self, grid_size=0.05, hash_type="fnv", mode="train",
                 keys=("coord", "color", "normal", "segment"),
                 return_inverse=False, return_grid_coord=False,
                 return_min_coord=False, min_coord=None):
        self.grid_size = grid_size
        self.hash = fnv_hash_vec if hash_type == "fnv" else ravel_hash_vec
        assert mode in ("train", "test")
        self.mode = mode
        self.keys = keys
        self.return_inverse = return_inverse
        self.return_grid_coord = return_grid_coord
        self.return_min_coord = return_min_coord
        self.min_coord = min_coord

    def __call__(self, data_dict, draws: Draws = None):
        coord = data_dict["coord"]
        if self.min_coord is not None:
            min_coord = np.asarray(self.min_coord)
            grid_coord = np.floor(
                (coord - min_coord) / self.grid_size).astype(int)
        else:
            scaled = coord / self.grid_size
            grid_coord = np.floor(scaled).astype(int)
            gmin = grid_coord.min(0)
            min_coord = gmin * self.grid_size
            grid_coord = grid_coord - gmin
        key = self.hash(grid_coord)
        idx_sort = np.argsort(key)
        key_sort = key[idx_sort]
        _, inverse, count = np.unique(key_sort, return_inverse=True,
                                      return_counts=True)
        if self.mode == "train":
            idx_select = (np.cumsum(np.insert(count, 0, 0)[:-1])
                          + draws.np_rng.randint(0, count.max(),
                                                 count.size) % count)
            idx_unique = idx_sort[idx_select]
            if self.return_inverse:
                inv = np.zeros_like(inverse)
                inv[idx_sort] = inverse
                data_dict["inverse"] = inv
            if self.return_grid_coord:
                data_dict["grid_coord"] = grid_coord[idx_unique]
            data_dict["min_coord"] = np.asarray(min_coord).reshape(3)
            for k in self.keys:
                if k in data_dict:
                    data_dict[k] = data_dict[k][idx_unique]
            return data_dict
        if self.return_grid_coord:
            data_dict["grid_coord"] = grid_coord
        data_dict["min_coord"] = np.asarray(min_coord).reshape(3)
        return data_dict


class FPS:
    """Cap the cloud at ``max_points`` by farthest point sampling (seed
    index 0), keeping the selected points in their input order; a cloud
    of at most ``max_points`` passes unchanged."""

    KEYS = ("coord", "color", "normal", "segment", "instance", "grid_coord",
            "feat")

    def __init__(self, max_points=80000):
        self.max_points = max_points

    def __call__(self, data_dict, draws=None):
        if len(data_dict["coord"]) <= self.max_points:
            return data_dict
        from unipre3d_tpu_torch.native import host_fps
        idx = host_fps(np.ascontiguousarray(data_dict["coord"],
                                            dtype=np.float32),
                       self.max_points)
        idx.sort()
        for k in self.KEYS:
            if k in data_dict:
                data_dict[k] = data_dict[k][idx]
        return data_dict
