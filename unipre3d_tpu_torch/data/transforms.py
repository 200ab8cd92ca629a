"""Host-side point-cloud transforms: the pretraining readers' and the
fine-tuning zoo.

Port of unipre3d_tpu/data/transforms.py, all of it: the ``TRANSFORMS``
registry (``register``; pipelines given in config syntax,
``[name, kwargs]``, are built through it), ``Compose``, the ScanNet
pretraining pipeline's transforms (scannet.py:126-157), the fine-tuning
transforms (coordinate, colour, cropping, dropout, elastic distortion,
projection and ray sampling, contrastive views, instance parsing) and the
Mix3d collate hook (``mix3d_pair``, ``make_mix3d_collate``). Every
geometric transform that moves the cloud also updates the listed camera
``extrinsic`` matrices (w2c) by right-multiplying them with the inverse
world transform, so the render supervision stays consistent under
augmentation.

Each transform is ``t(data_dict, draws)``. The random ones draw from
``draws`` (data/draws.py) where the JAX transforms draw from the global
``random`` and ``np.random``, in the same order and with the same calls,
so equal seeds give equal results. ``FPS`` draws nothing: it caps the
cloud with the C++ host FPS (native/), which breaks ties by the lowest
index. The Mix3d hook draws from the ``np.random.Generator`` the loader
hands it for each batch (data/loader.py), where JAX's carries one
generator from batch to batch.
"""

from __future__ import annotations

import copy
from typing import Dict, Sequence

import numpy as np

from unipre3d_tpu_torch.data.draws import Draws

TRANSFORMS = {}


def register(cls):
    TRANSFORMS[cls.__name__] = cls
    return cls


def build_pipeline(spec) -> "Compose":
    """Config-syntax transform list (``[name, kwargs]`` entries or
    transform instances) -> Compose."""
    return Compose([t if not isinstance(t, (tuple, list))
                    else TRANSFORMS[t[0]](**(t[1] if len(t) > 1 else {}))
                    for t in spec])


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


@register
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


@register
class NormalizeColor:
    """color / 127.5 - 1."""

    def __call__(self, data_dict, draws=None):
        if "color" in data_dict:
            data_dict["color"] = data_dict["color"] / 127.5 - 1.0
        return data_dict


@register
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


@register
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


@register
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


@register
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


@register
class ChromaticTranslation:
    def __init__(self, p=0.95, ratio=0.05):
        self.p = p
        self.ratio = ratio

    def __call__(self, data_dict, draws: Draws):
        if "color" in data_dict and draws.np_rng.rand() < self.p:
            tr = (draws.np_rng.rand(1, 3) - 0.5) * 255 * 2 * self.ratio
            data_dict["color"] = np.clip(data_dict["color"] + tr, 0, 255)
        return data_dict


@register
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


@register
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


@register
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


# ---------------------------------------------------------------------------
# the fine-tuning zoo
# ---------------------------------------------------------------------------

@register
class ToTensor:
    """No-op: examples stay numpy until the loader moves a batch
    (data/loader.py:batch_to)."""

    def __call__(self, data_dict, draws=None):
        return data_dict


@register
class NormalizeCoord:
    """Centre on the mean and scale into the unit ball."""

    def __call__(self, data_dict, draws=None):
        c = data_dict["coord"]
        c = c - c.mean(axis=0)
        m = np.max(np.sqrt(np.sum(c ** 2, axis=1)))
        data_dict["coord"] = c / max(m, 1e-12)
        return data_dict


@register
class PositiveShift:
    """Shift so that every coordinate is >= 0."""

    def __call__(self, data_dict, draws=None):
        data_dict["coord"] = data_dict["coord"] - \
            data_dict["coord"].min(axis=0)
        return data_dict


@register
class RandomShift:
    """A uniform shift per axis, the extrinsics along."""

    def __init__(self, shift=((-0.2, 0.2), (-0.2, 0.2), (0, 0)), keys=()):
        self.shift = shift
        self.keys = keys

    def __call__(self, data_dict, draws: Draws):
        s = np.array([draws.np_rng.uniform(*r) for r in self.shift])
        data_dict["coord"] = data_dict["coord"] + s
        S = np.eye(4)
        S[:3, 3] = s
        return _apply_world_transform(data_dict, np.linalg.inv(S), self.keys)


@register
class RandomRotateTargetAngle(_RotateBase):
    """With probability ``p``, rotate about ``axis`` by one of ``angle``
    (in units of pi)."""

    def __init__(self, angle=(1 / 2, 1, 3 / 2), center=None, axis="z",
                 always_apply=False, p=0.75, keys=()):
        self.angle = angle
        self.axis = axis
        self.p = 1.0 if always_apply else p
        self.center = center
        self.keys = keys

    def __call__(self, data_dict, draws: Draws):
        if draws.py_rng.random() > self.p:
            return data_dict
        angle = draws.np_rng.choice(self.angle) * np.pi
        return self._rotate(data_dict, _axis_rotation(self.axis, angle),
                            self.keys, self.center)


@register
class RandomScale:
    """A uniform scale (per axis with ``anisotropic``), the extrinsics
    along."""

    def __init__(self, scale=(0.95, 1.05), anisotropic=False, keys=()):
        self.scale = scale
        self.anisotropic = anisotropic
        self.keys = keys

    def __call__(self, data_dict, draws: Draws):
        s = draws.np_rng.uniform(self.scale[0], self.scale[1],
                                 3 if self.anisotropic else 1)
        data_dict["coord"] = data_dict["coord"] * s
        S = np.eye(4)
        S[:3, :3] = np.diag(np.broadcast_to(s, (3,)))
        return _apply_world_transform(data_dict, np.linalg.inv(S), self.keys)


@register
class RandomFlip:
    """Flip x, then y, each with probability ``p`` (normals and extrinsics
    along)."""

    def __init__(self, p=0.5, keys=()):
        self.p = p
        self.keys = keys

    def __call__(self, data_dict, draws: Draws):
        for axis in (0, 1):
            if draws.np_rng.rand() < self.p:
                data_dict["coord"][:, axis] = -data_dict["coord"][:, axis]
                if "normal" in data_dict:
                    data_dict["normal"][:, axis] = \
                        -data_dict["normal"][:, axis]
                S = np.eye(4)
                S[axis, axis] = -1
                _apply_world_transform(data_dict, np.linalg.inv(S),
                                       self.keys)
        return data_dict


@register
class ClipGaussianJitter:
    """Standard-normal jitter / 3, clipped to [-1, 1], times ``scalar``."""

    def __init__(self, scalar=0.02):
        self.scalar = scalar

    def __call__(self, data_dict, draws: Draws):
        j = draws.np_rng.multivariate_normal(
            np.zeros(3), np.eye(3), data_dict["coord"].shape[0])
        data_dict["coord"] = data_dict["coord"] + \
            self.scalar * np.clip(j / 3.0, -1, 1)
        return data_dict


@register
class RandomColorGrayScale:
    def __init__(self, p=0.1):
        self.p = p

    def __call__(self, data_dict, draws: Draws):
        if "color" in data_dict and draws.np_rng.rand() < self.p:
            gray = data_dict["color"] @ np.array([0.299, 0.587, 0.114])
            data_dict["color"] = np.tile(gray[:, None], (1, 3))
        return data_dict


@register
class RandomDropout:
    """With probability ``dropout_application_ratio``, keep a random
    ``1 - dropout_ratio`` of the points, in input order."""

    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.5):
        self.dropout_ratio = dropout_ratio
        self.p = dropout_application_ratio

    def __call__(self, data_dict, draws: Draws):
        if draws.np_rng.rand() < self.p:
            n = len(data_dict["coord"])
            keep = draws.np_rng.choice(
                n, int(n * (1 - self.dropout_ratio)), replace=False)
            keep.sort()
            for k in ("coord", "color", "normal", "segment", "instance"):
                if k in data_dict:
                    data_dict[k] = data_dict[k][keep]
        return data_dict


@register
class SphereCrop:
    """Keep the ``point_max`` points nearest a random point (``mode``
    random) or the mean (else), in input order."""

    def __init__(self, point_max=80000, sample_rate=None, mode="random"):
        self.point_max = point_max
        self.sample_rate = sample_rate
        self.mode = mode

    def __call__(self, data_dict, draws: Draws):
        coord = data_dict["coord"]
        n = len(coord)
        point_max = (int(self.sample_rate * n)
                     if self.sample_rate is not None else self.point_max)
        if n <= point_max:
            return data_dict
        if self.mode == "random":
            center = coord[draws.np_rng.randint(n)]
        else:
            center = coord.mean(axis=0)
        idx = np.argsort(np.sum((coord - center) ** 2, axis=1))[:point_max]
        idx.sort()
        for k in ("coord", "color", "normal", "segment", "instance",
                  "grid_coord"):
            if k in data_dict:
                data_dict[k] = data_dict[k][idx]
        return data_dict


@register
class ElasticDistortion:
    """A smoothed random displacement field, one per (granularity,
    magnitude) pair."""

    def __init__(self, distortion_params=((0.2, 0.4), (0.8, 1.6))):
        self.params = distortion_params

    def _distort(self, coords, granularity, magnitude, draws):
        from scipy.interpolate import RegularGridInterpolator
        from scipy.ndimage import convolve
        blurx = np.ones((3, 1, 1, 1)) / 3
        blury = np.ones((1, 3, 1, 1)) / 3
        blurz = np.ones((1, 1, 3, 1)) / 3
        coords_min = coords.min(0)
        dims = ((coords - coords_min).max(0) // granularity).astype(int) + 3
        noise = draws.np_rng.randn(*dims, 3).astype(np.float32)
        for _ in range(2):
            noise = convolve(noise, blurx, mode="constant", cval=0)
            noise = convolve(noise, blury, mode="constant", cval=0)
            noise = convolve(noise, blurz, mode="constant", cval=0)
        ax = [np.linspace(d_min, d_max, d)
              for d_min, d_max, d in zip(
                  coords_min - granularity,
                  coords_min + granularity * (np.array(dims) - 2), dims)]
        interp = RegularGridInterpolator(ax, noise, bounds_error=False,
                                         fill_value=0)
        return coords + interp(coords) * magnitude

    def __call__(self, data_dict, draws: Draws):
        for granularity, magnitude in self.params:
            data_dict["coord"] = self._distort(
                data_dict["coord"], granularity, magnitude, draws)
        return data_dict


_FILTER_KEYS = ("coord", "grid_coord", "color", "normal", "segment",
                "instance", "strength", "displacement", "feat")


def _select_points(data_dict, idx, keys=_FILTER_KEYS):
    for k in keys:
        if k in data_dict:
            data_dict[k] = data_dict[k][idx]
    return data_dict


@register
class Copy:
    """Copy keys under new names (coord -> origin_coord, segment ->
    origin_segment by default)."""

    def __init__(self, keys_dict=None):
        if keys_dict is None:
            keys_dict = dict(coord="origin_coord", segment="origin_segment")
        self.keys_dict = keys_dict

    def __call__(self, data_dict, draws=None):
        for src, dst in self.keys_dict.items():
            v = data_dict[src]
            data_dict[dst] = v.copy() if isinstance(v, np.ndarray) \
                else copy.deepcopy(v)
        return data_dict


@register
class Add:
    """Add constant keys to the example."""

    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict or {}

    def __call__(self, data_dict, draws=None):
        data_dict.update(self.keys_dict)
        return data_dict


@register
class PointClip:
    """Clamp coords to an axis-aligned range."""

    def __init__(self, point_cloud_range=(-80, -80, -3, 80, 80, 1)):
        self.range = np.asarray(point_cloud_range, dtype=np.float32)

    def __call__(self, data_dict, draws=None):
        data_dict["coord"] = np.clip(
            data_dict["coord"], a_min=self.range[:3], a_max=self.range[3:])
        return data_dict


@register
class PointRangeFilter:
    """Drop the points outside the range (``sampled_index`` points always
    stay, re-indexed)."""

    def __init__(self, point_cloud_range=(-80, -80, -3, 80, 80, 1),
                 padding=0.0):
        self.range = np.asarray(point_cloud_range, dtype=np.float32)
        self.padding = padding

    def __call__(self, data_dict, draws=None):
        c = data_dict["coord"]
        lo = self.range[:3] + self.padding
        hi = self.range[3:] - self.padding
        idx = np.nonzero(np.all((c > lo) & (c < hi), axis=1))[0]
        if "sampled_index" in data_dict:
            idx = np.unique(np.append(idx, data_dict["sampled_index"]))
            mask = np.zeros(len(data_dict["segment"]), dtype=bool)
            mask[data_dict["sampled_index"]] = True
            data_dict["sampled_index"] = np.nonzero(mask[idx])[0]
        return _select_points(data_dict, idx)


@register
class ProjectOnImage:
    """Each point's pixel coordinates in each view and its visibility;
    with ``filter_overlap`` only the nearest point of a pixel stays
    visible."""

    def __init__(self, filter_overlap=True, close_radius=0.0):
        self.filter_overlap = filter_overlap
        self.close_radius = close_radius

    def __call__(self, data_dict, draws=None):
        coord_h = np.concatenate(
            [data_dict["coord"],
             np.ones_like(data_dict["coord"][:, :1])], axis=-1)
        img_coord, proj_mask = [], []
        for img, l2i in zip(data_dict["img"], data_dict["lidar2img"]):
            pc = coord_h @ np.asarray(l2i).T
            eps = 1e-5
            pc[:, :2] /= np.maximum(pc[:, 2:3], eps)
            m = ((np.linalg.norm(coord_h[:, :2], axis=-1) > self.close_radius)
                 & (pc[:, 2] > eps)
                 & (pc[:, 0] > 0) & (pc[:, 1] > 0)
                 & (pc[:, 0] < img.shape[1]) & (pc[:, 1] < img.shape[0]))
            if self.filter_overlap:
                sel = np.nonzero(m)[0]
                pix = pc[sel, :2].astype(np.int32)
                rank = pix[:, 0] + pix[:, 1] * img.shape[1]
                order = np.argsort(rank + pc[sel, 2] / 100.0)
                r_sorted = rank[order]
                keep = np.ones(len(r_sorted), dtype=bool)
                keep[1:] = r_sorted[1:] != r_sorted[:-1]
                m[sel[order[~keep]]] = False
            img_coord.append(pc[:, :3])
            proj_mask.append(m)
        data_dict["img_coord"] = img_coord
        data_dict["img_proj_mask"] = proj_mask
        return data_dict


@register
class RaySample:
    """Camera-to-point rays of sampled visible points, with their pixel
    colours and segment labels."""

    def __init__(self, point_nsample=None, point_ratio=None,
                 fetch_color=True, fetch_segment=True):
        self.point_nsample = point_nsample
        self.point_ratio = point_ratio
        self.fetch_color = fetch_color
        self.fetch_segment = fetch_segment

    def __call__(self, data_dict, draws: Draws):
        starts, ends, colors, segs = [], [], [], []
        for i, mask in enumerate(data_dict["img_proj_mask"]):
            vis = np.nonzero(mask)[0]
            n = min(len(vis),
                    int(len(vis) * self.point_ratio)
                    if self.point_nsample is None else self.point_nsample)
            if n == 0:
                continue
            vis = vis[draws.np_rng.choice(len(vis), n, replace=False)]
            cam_origin = np.linalg.inv(
                np.asarray(data_dict["lidar2cam"][i]))[:3, 3]
            starts.append(np.repeat(cam_origin[None], n, axis=0))
            ends.append(data_dict["coord"][vis])
            if self.fetch_segment:
                segs.append(data_dict["segment"][vis])
            if self.fetch_color:
                pc = data_dict["img_coord"][i][vis]
                img = data_dict["img"][i]
                colors.append(img[pc[:, 1].astype(np.int32),
                                  pc[:, 0].astype(np.int32)] / 255.0)
        data_dict["ray_start"] = np.concatenate(starts, axis=0)
        data_dict["ray_end"] = np.concatenate(ends, axis=0)
        if self.fetch_segment:
            data_dict["ray_segment"] = np.concatenate(segs, axis=0)
        if self.fetch_color:
            data_dict["ray_color"] = np.concatenate(colors, axis=0)
        return data_dict


def _rgb2hsv(rgb):
    """rgb in [0, 1] -> hsv (torchvision's convention)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.max(rgb, axis=-1)
    minc = np.min(rgb, axis=-1)
    eqc = maxc == minc
    cr = maxc - minc
    s = cr / (eqc + maxc * (1 - eqc))
    crd = eqc + cr * (1 - eqc)
    rc, gc, bc = (maxc - r) / crd, (maxc - g) / crd, (maxc - b) / crd
    h = ((maxc == r) * (bc - gc)
         + ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
         + ((maxc != g) & (maxc != r)) * (4.0 + gc - rc))
    h = (h / 6.0 + 1.0) % 1.0
    return np.stack((h, s, maxc), axis=-1)


def _hsv2rgb(hsv):
    """The inverse of :func:`_rgb2hsv`."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = (h * 6.0) - i
    i = i.astype(np.int32) % 6
    p = np.clip(v * (1.0 - s), 0.0, 1.0)
    q = np.clip(v * (1.0 - s * f), 0.0, 1.0)
    t = np.clip(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)
    sel = i[..., None] == np.arange(6)
    r = np.stack((v, q, p, p, t, v), axis=-1)
    g = np.stack((t, v, v, q, p, p), axis=-1)
    b = np.stack((p, p, t, v, v, q), axis=-1)
    return np.stack([(sel * c).sum(-1) for c in (r, g, b)], axis=-1)


@register
class RandomColorJitter:
    """Brightness, contrast, saturation and hue jitter in a random order,
    each with probability ``p`` (torchvision's), on ``color`` and a paired
    ``rgb``."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 p=0.95):
        self.brightness = self._rng_range(brightness)
        self.contrast = self._rng_range(contrast)
        self.saturation = self._rng_range(saturation)
        self.hue = self._rng_range(hue, center=0.0, clip_zero=False)
        self.p = p

    @staticmethod
    def _rng_range(value, center=1.0, clip_zero=True):
        if isinstance(value, (int, float)):
            lo, hi = center - float(value), center + float(value)
            if clip_zero:
                lo = max(lo, 0.0)
        else:
            lo, hi = value
        return None if lo == hi == center else (lo, hi)

    @staticmethod
    def _blend(c1, c2, ratio):
        return (ratio * c1 + (1.0 - ratio) * c2).clip(0, 255.0) \
            .astype(c1.dtype)

    def _each(self, data_dict, fn):
        for k in ("color", "rgb"):
            if k in data_dict:
                data_dict[k] = fn(data_dict[k])
        return data_dict

    def __call__(self, data_dict, draws: Draws):
        rng = draws.np_rng
        for op in rng.permutation(4):
            bounds = (self.brightness, self.contrast,
                      self.saturation, self.hue)[op]
            if bounds is None or rng.rand() >= self.p:
                continue
            f = rng.uniform(*bounds)
            if op == 0:
                self._each(data_dict,
                           lambda c: self._blend(c, np.zeros_like(c), f))
            elif op == 1:
                gray = np.mean(
                    data_dict["color"] @ np.array([0.299, 0.587, 0.114]))
                self._each(data_dict, lambda c: self._blend(c, gray, f))
            elif op == 2:
                self._each(
                    data_dict,
                    lambda c: self._blend(
                        c, (c @ np.array([0.299, 0.587, 0.114]))[..., None],
                        f))
            else:
                def hue_shift(c):
                    hsv = _rgb2hsv(np.asarray(c, np.float64) / 255.0)
                    hsv[..., 0] = (hsv[..., 0] + f) % 1.0
                    return (_hsv2rgb(hsv) * 255.0).astype(c.dtype)
                self._each(data_dict, hue_shift)
        return data_dict


@register
class HueSaturationTranslation:
    """An additive hue and a multiplicative saturation shift in HSV,
    shared by ``color`` and ``rgb``."""

    def __init__(self, hue_max=0.5, saturation_max=0.2):
        self.hue_max = hue_max
        self.saturation_max = saturation_max

    def __call__(self, data_dict, draws: Draws):
        if "color" not in data_dict:
            return data_dict
        hue = (draws.np_rng.rand() - 0.5) * 2 * self.hue_max
        sat = 1 + (draws.np_rng.rand() - 0.5) * 2 * self.saturation_max
        for k in ("color", "rgb"):
            if k not in data_dict:
                continue
            c = data_dict[k]
            hsv = _rgb2hsv(np.asarray(c[..., :3], np.float64) / 255.0)
            hsv[..., 0] = (hue + hsv[..., 0] + 1) % 1.0
            hsv[..., 1] = np.clip(sat * hsv[..., 1], 0, 1)
            data_dict[k][..., :3] = np.clip(
                _hsv2rgb(hsv) * 255.0, 0, 255).astype(c.dtype)
        return data_dict


@register
class RandomColorDrop:
    """With probability ``p``, colours times ``color_augment`` (0: drop)."""

    def __init__(self, p=0.2, color_augment=0.0):
        self.p = p
        self.color_augment = color_augment

    def __call__(self, data_dict, draws: Draws):
        if "color" in data_dict and draws.np_rng.rand() < self.p:
            data_dict["color"] = data_dict["color"] * self.color_augment
        return data_dict


@register
class ShufflePoint:
    """A random permutation of every per-point array."""

    def __call__(self, data_dict, draws: Draws):
        idx = draws.np_rng.permutation(len(data_dict["coord"]))
        return _select_points(data_dict, idx)


@register
class CropBoundary:
    """Drop the wall (0) and floor (1) points."""

    def __call__(self, data_dict, draws=None):
        seg = data_dict["segment"].reshape(-1)
        return _select_points(data_dict, (seg != 0) & (seg != 1))


@register
class ContrastiveViewsGenerator:
    """Two independently augmented views of ``view_keys``, prefixed
    ``view1_`` and ``view2_``; ``view_trans`` takes instances or
    ``(name, kwargs)`` entries."""

    def __init__(self, view_keys=("coord", "color", "normal",
                                  "origin_coord"), view_trans=()):
        self.view_keys = view_keys
        self.view_trans = build_pipeline(view_trans)

    def __call__(self, data_dict, draws: Draws):
        for prefix in ("view1_", "view2_"):
            view = {k: data_dict[k].copy() for k in self.view_keys}
            for k, v in self.view_trans(view, draws).items():
                data_dict[prefix + k] = v
        return data_dict


@register
class InstanceParser:
    """Dense instance ids over the kept segments, each point's instance
    centroid, and each instance's box [centre(3), size(3), 0, class]
    (classes renumbered past the ignored ones)."""

    def __init__(self, segment_ignore_index=(-1, 0, 1),
                 instance_ignore_index=-1):
        self.segment_ignore_index = segment_ignore_index
        self.instance_ignore_index = instance_ignore_index

    def __call__(self, data_dict, draws=None):
        coord = data_dict["coord"]
        segment = data_dict["segment"]
        instance = np.array(data_dict["instance"])
        mask = ~np.isin(segment, self.segment_ignore_index)
        instance[~mask] = self.instance_ignore_index
        unique, inverse = np.unique(instance[mask], return_inverse=True)
        instance[mask] = inverse
        n_inst = len(unique)
        centroid = np.full((len(coord), 3), self.instance_ignore_index,
                           dtype=np.float64)
        bbox = np.full((n_inst, 8), self.instance_ignore_index,
                       dtype=np.float64)
        vacancy = [i for i in self.segment_ignore_index if i >= 0]
        for inst_id in range(n_inst):
            m = instance == inst_id
            pts = coord[m]
            lo, hi = pts.min(0), pts.max(0)
            cls = float(segment[m][0])
            cls -= float(np.greater(cls, vacancy).sum())
            centroid[m] = pts.mean(0)
            bbox[inst_id] = np.concatenate(
                [(hi + lo) / 2, hi - lo, [0.0], [cls]])
        data_dict["instance"] = instance
        data_dict["instance_centroid"] = centroid
        data_dict["bbox"] = bbox
        return data_dict


# ---------------------------------------------------------------------------
# Mix3d (a loader collate hook)
# ---------------------------------------------------------------------------

POINT_KEYS = ("coord", "grid_coord", "color", "normal", "segment",
              "instance", "feat")


def mix3d_pair(a, b, rng: np.random.Generator, point_keys=POINT_KEYS):
    """Merge two padded scenes into one of the same capacity M: a random
    M of the union of their valid points (``mask``), ``a``'s first, padded
    with zeros; the other keys are ``a``'s."""
    ref_key = next(k for k in point_keys if k in a)
    M = a[ref_key].shape[0]

    def valid(e):
        m = e.get("mask")
        return np.ones(M, bool) if m is None else np.asarray(m, bool)

    idx_a = np.nonzero(valid(a))[0]
    idx_b = np.nonzero(valid(b))[0]
    sel = rng.permutation(len(idx_a) + len(idx_b))[:M]
    take_a = idx_a[sel[sel < len(idx_a)]]
    take_b = idx_b[sel[sel >= len(idx_a)] - len(idx_a)]
    n = len(take_a) + len(take_b)

    out = dict(a)
    for k in point_keys:
        if k in a and k in b:
            merged = np.concatenate([a[k][take_a], b[k][take_b]], axis=0)
            if n < M:
                pad = np.zeros((M - n, *merged.shape[1:]), merged.dtype)
                merged = np.concatenate([merged, pad], axis=0)
            out[k] = merged
    if "mask" in a:
        out["mask"] = np.arange(M) < n
    return out


def make_mix3d_collate(mix_prob: float, point_keys=POINT_KEYS):
    """A loader ``collate_hook(examples, rng)``: with probability
    ``mix_prob`` each example of the batch is merged with a random other
    one (a scene's nested ``point_cloud`` dict, or the example itself),
    drawing from ``rng``, the batch's own generator."""

    def hook(examples, rng: np.random.Generator):
        if len(examples) < 2 or mix_prob <= 0.0:
            return examples
        out = []
        for i, e in enumerate(examples):
            if rng.random() < mix_prob:
                j = (i + 1 + int(rng.integers(len(examples) - 1))) \
                    % len(examples)
                if "point_cloud" in e and isinstance(e["point_cloud"],
                                                     dict):
                    e = dict(e)
                    e["point_cloud"] = mix3d_pair(
                        e["point_cloud"], examples[j]["point_cloud"],
                        rng, point_keys)
                else:
                    e = mix3d_pair(e, examples[j], rng, point_keys)
            out.append(e)
        return out

    return hook
