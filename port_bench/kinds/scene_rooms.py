"""The ``scene_rooms`` traffic kind: procedural rooms of floor, walls and
boxes over a ScanNet-schema config, each with camera frames inside it
(see ``Dataset``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.generator import VIRTUAL_LENGTH, stream_seed


def _surface(rng, origin, u, v, n_pts, normal, base):
    """``n_pts`` points on the parallelogram origin + [0,1]u + [0,1]v with
    ``normal``, coloured ``base`` times a smooth texture."""
    a, b = rng.random((2, n_pts))
    pts = origin + a[:, None] * u + b[:, None] * v
    f = rng.uniform(1.0, 4.0, 2)
    tex = 0.75 + 0.25 * np.sin(2 * np.pi * (f[0] * a + f[1] * b)
                               + rng.uniform(0, 6.3))
    return pts, np.repeat(normal[None], n_pts, 0), base * tex[:, None]


def room_points(rng, mix):
    """A room of floor, ``walls`` walls and ``boxes`` boxes (their five
    visible faces) sampled at ``points_per_m2`` -> coord, colour, normal;
    y up, the floor at y = 0."""
    w, d = rng.uniform(*mix["room_side"], 2)
    h = rng.uniform(*mix["room_height"])
    dens = float(mix["points_per_m2"])
    col = lambda: rng.uniform(0.2, 0.95, 3)
    X, Y, Z = np.eye(3)
    parts = [_surface(rng, np.zeros(3), w * X, d * Z, int(w * d * dens), Y,
                      col())]
    walls = [(np.zeros(3), w * X, Z), (np.zeros(3), d * Z, X),
             (d * Z, w * X, -Z), (w * X, d * Z, -X)]
    for i in rng.permutation(4)[:rng.integers(*mix["walls"], endpoint=True)]:
        o, u, n = walls[i]
        parts.append(_surface(rng, o, u, h * Y, int(np.linalg.norm(u) * h
                                                      * dens), n, col()))
    for _ in range(rng.integers(*mix["boxes"], endpoint=True)):
        sx, sy, sz = rng.uniform(0.3, 1.2, 3) * [1, 0.8, 1]
        o = np.array([rng.uniform(0, w - sx), 0, rng.uniform(0, d - sz)])
        c = col()
        for fo, u, v, n in ((o + sy * Y, sx * X, sz * Z, Y),
                            (o, sx * X, sy * Y, -Z),
                            (o + sz * Z, sx * X, sy * Y, Z),
                            (o, sz * Z, sy * Y, -X),
                            (o + sx * X, sz * Z, sy * Y, X)):
            area = np.linalg.norm(u) * np.linalg.norm(v)
            parts.append(_surface(rng, fo, u, v, int(area * dens), n, c))
    coord, normal, color = (np.concatenate(x) for x in zip(*parts))
    return (coord.astype(np.float32), color.clip(0, 1).astype(np.float32),
            normal.astype(np.float32), np.array([w, h, d]))


def grid_sample(rng, coord, grid, cap):
    """One point a ``grid`` voxel (the first of each), then at most ``cap``
    of them at random (ScanNet's GridSample and point cap) -> (kept rows,
    grid coords, min coord)."""
    min_coord = coord.min(0)
    g = np.floor((coord - min_coord) / grid).astype(np.int64)
    key = (g[:, 0] << 40) | (g[:, 1] << 20) | g[:, 2]
    _, keep = np.unique(key, return_index=True)
    if len(keep) > cap:
        keep = rng.choice(keep, cap, replace=False)
    keep.sort()
    return keep, g[keep].astype(np.int32), min_coord.astype(np.float32)


def look_cameras(rng, n, size, mix, fov_deg, H, W, znear, zfar):
    """``n`` cameras inside a room of ``size`` (w, h, d), at a random
    height, looking level or down at a random heading."""
    w, _, d = size
    pos = np.stack([rng.uniform(0.4, w - 0.4, n),
                    rng.uniform(*mix["camera_height"], n),
                    rng.uniform(0.4, d - 0.4, n)], 1)
    head = rng.uniform(0, 2 * np.pi, n)
    pitch = rng.uniform(*mix["camera_pitch"], n)
    fwd = np.stack([np.cos(pitch) * np.sin(head), np.sin(pitch),
                    np.cos(pitch) * np.cos(head)], 1)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    up = np.cross(right, fwd)
    rot = np.stack([right, -up, fwd], axis=2)
    w2c = np.zeros((n, 4, 4))
    w2c[:, :3, :3] = rot.transpose(0, 2, 1)
    w2c[:, :3, 3] = -np.einsum("nji,nj->ni", rot, pos)
    w2c[:, 3, 3] = 1.0
    tx = math.tan(math.radians(fov_deg) / 2)
    ty = tx * H / W
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1], proj[3, 2] = 1.0 / tx, 1.0 / ty, 1.0
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    world_view = w2c.transpose(0, 2, 1)
    view_to_world = np.linalg.inv(world_view)
    return {"world_view_transforms": world_view.astype(np.float32),
            "full_proj_transforms": (world_view @ proj.T).astype(np.float32),
            "view_to_world_transforms": view_to_world.astype(np.float32),
            "camera_centers": view_to_world[:, 3, :3].astype(np.float32)}


def zbuffer_frames(coord, color, cams, H, W, device):
    """Each camera's nearest point a pixel (holes filled from the 3x3
    neighbourhood) -> (images [n, 3, H, W] quantised to uint8, view-space
    depth [n, H, W] float16, 0 where no point)."""
    pts = torch.as_tensor(coord, device=device)
    col = torch.as_tensor(color, device=device)
    hom = torch.cat([pts, torch.ones_like(pts[:, :1])], 1)
    n = cams["world_view_transforms"].shape[0]
    imgs, depths = [], []
    for f0 in range(0, n, 32):
        wv = torch.as_tensor(cams["world_view_transforms"][f0:f0 + 32],
                             device=device)
        fp = torch.as_tensor(cams["full_proj_transforms"][f0:f0 + 32],
                             device=device)
        z = torch.einsum("pi,fi->fp", hom, wv[:, :, 2])
        clip = torch.einsum("pi,fij->fpj", hom, fp)
        ix = (((clip[..., 0] / clip[..., 3] + 1) * W - 1) / 2).round().long()
        iy = (((clip[..., 1] / clip[..., 3] + 1) * H - 1) / 2).round().long()
        ok = (z > 0.05) & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        key = (z * 1e4).long().clamp(0, 1 << 30) * (1 << 20) \
            + torch.arange(len(coord), device=device)
        key = torch.where(ok, key, torch.full_like(key, 1 << 62))
        best = torch.full((key.shape[0], H * W), 1 << 62, device=device,
                          dtype=torch.long)
        best.scatter_reduce_(1, torch.where(ok, iy * W + ix, 0), key, "amin")
        best = -torch.nn.functional.max_pool2d(
            -best.view(-1, 1, H, W).double(), 3, 1, 1).view(-1, H * W)
        hit = best < (1 << 61)
        idx = torch.where(hit, best.long() % (1 << 20), 0)
        rgb = torch.where(hit[..., None], col[idx], torch.ones(3,
                                                               device=device))
        imgs.append((rgb * 255).round().to(torch.uint8).view(-1, H, W, 3)
                    .permute(0, 3, 1, 2))
        depth = torch.where(hit, torch.gather(z, 1, idx), torch.zeros_like(
            z[:, :1]).expand_as(idx))
        depths.append(depth.view(-1, H, W).half())
    return torch.cat(imgs).cpu().numpy(), torch.cat(depths).cpu().numpy()


def unproject(depth, cams, fov_deg):
    """World coordinates and validity [n, H, W, 4] of view-space depths
    [n, H, W] (0: no point) through the cameras' own projection."""
    n, H, W = depth.shape
    tx = math.tan(math.radians(fov_deg) / 2)
    ty = tx * H / W
    px = (2 * np.arange(W) + 1) / W - 1
    py = (2 * np.arange(H) + 1) / H - 1
    z = depth.astype(np.float32)
    cam = np.stack([px[None, None, :] * tx * z, py[None, :, None] * ty * z,
                    z, np.ones_like(z)], -1)
    world = np.einsum("nhwi,nij->nhwj", cam, cams["view_to_world_transforms"])
    return np.concatenate([world[..., :3], (z > 0)[..., None]],
                          -1).astype(np.float32)


class Dataset:
    """The ``scene_rooms`` mix over a ScanNet-schema config: ``scenes``
    procedural rooms (floor, walls and boxes at ``points_per_m2``, grid
    sampled at the config's 2 cm and capped at its ``max_points``), each
    with ``frames`` camera frames inside it (colour from the room's own
    points, nearest first, and view-space depth). Sample ``i`` is a room
    and ``2 x input_images`` distinct frames of it that ``(seed, i)``
    draw: the conditioning frames with their unprojected depth, then the
    supervision frames. Over ``scenes x frames`` distinct conditioning
    images an LRU of C slots hits about C / (scenes x frames)."""

    def __init__(self, mix: dict, spec: dict, seed: int, device):
        self.seed = int(seed)
        self.n_in = int(spec["input_images"])
        self.fov = float(spec["fov"])
        H, W = int(spec["training_height"]), int(spec["training_width"])
        cap, grid = int(spec["max_points"]), float(spec["grid_size"])
        rng = np.random.default_rng(stream_seed(seed, 3))
        self.n_frames = int(mix["frames"])
        self.rooms, self.images, self.depths, self.cams = [], [], [], []
        for _ in range(int(mix["scenes"])):
            coord, color, normal, size = room_points(rng, mix)
            keep, gcoord, min_coord = grid_sample(rng, coord, grid, cap)
            coord, color, normal = coord[keep], color[keep], normal[keep]
            m = len(keep)
            pad = lambda a: np.concatenate(
                [a, np.zeros((cap - m, *a.shape[1:]), a.dtype)])
            self.rooms.append({
                "coord": pad(coord), "grid_coord": pad(gcoord),
                "feat": pad(np.concatenate([normal, color * 2 - 1], 1)),
                "mask": np.arange(cap) < m, "min_coord": min_coord})
            cams = look_cameras(rng, self.n_frames, size, mix, self.fov, H,
                                W, float(spec["znear"]), float(spec["zfar"]))
            img, depth = zbuffer_frames(coord, color, cams, H, W, device)
            self.images.append((img.astype(np.float32) / 255.0))
            self.depths.append(depth)
            self.cams.append(cams)

    def __len__(self):
        return VIRTUAL_LENGTH

    def draw(self, index: int):
        rng = np.random.default_rng([self.seed, int(index)])
        room = int(rng.integers(len(self.rooms)))
        return room, rng.permutation(self.n_frames)[:2 * self.n_in]

    def __getitem__(self, index: int):
        r, idx = self.draw(index)
        out = {k: v[idx] for k, v in self.cams[r].items()}
        out["gt_images"] = self.images[r][idx]
        cond = idx[:self.n_in]
        out["unprojected_coords"] = unproject(
            self.depths[r][cond], {k: v[cond] for k, v in
                                   self.cams[r].items()}, self.fov)
        out["point_cloud"] = self.rooms[r]
        return out
