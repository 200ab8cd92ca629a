"""The traffic is fixed by the seed, and the object mix keeps the port's
feature cache under an 8% hit rate over a window's worth of batches."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import generator

BENCH = Path(__file__).resolve().parents[1]
SPEC = json.loads((BENCH / "configs" / "transformer_pretraining.json")
                  .read_text())
# the mixes' draws at a small image and cloud size (the draws and the
# number of distinct images do not depend on it)
SMALL = {**SPEC, "training_resolution": 16, "num_points": 64}


def pool(mix_name, seed, **over):
    mix = json.loads((BENCH / "traffic" / f"{mix_name}.json").read_text())
    mix.update(over)
    return generator.make_dataset(mix, SMALL, seed, torch.device("cpu"))


def test_same_seed_same_inputs_other_seed_other_inputs():
    big = 2 ** 31 + 977
    a, b, c = pool("fresh", big, objects=32), pool("fresh", big, objects=32), \
        pool("fresh", big + 1, objects=32)
    for i in (0, 5, 123456):
        for k, v in a[i].items():
            np.testing.assert_array_equal(v, b[i][k])
    assert any(not np.array_equal(a[i]["gt_images"], c[i]["gt_images"])
               for i in range(4))


def test_sample_schema_and_views():
    ds = pool("fresh", 3, objects=8)
    s = ds[17]
    n = SPEC["input_images"] + SPEC["imgs_per_obj"]
    assert s["gt_images"].shape == (n, 3, 16, 16)
    assert s["gt_images"].dtype == np.float32
    assert s["point_cloud"].shape == (64, 3)
    for k in ("world_view_transforms", "view_to_world_transforms",
              "full_proj_transforms"):
        assert s[k].shape == (n, 4, 4)
    o, idx = ds.draw(17)
    # the conditioning view is the first supervision view; those differ
    assert idx[0] == idx[1] and len(set(idx[1:])) == SPEC["imgs_per_obj"]
    # background pixels are exactly the ShapeNet renders' black
    assert (s["gt_images"] == 0).any() and (s["gt_images"] > 0).any()


def test_cameras_see_the_object():
    ds = pool("fresh", 5, objects=8)
    s = ds[0]
    hom = np.concatenate([s["point_cloud"], np.ones((64, 1))], 1)
    clip = hom @ s["full_proj_transforms"][0]
    ndc = clip[:, :2] / clip[:, 3:]
    assert (np.abs(ndc) < 1).mean() > 0.9
    assert (clip[:, 3] > SPEC["znear"]).all()


@pytest.mark.parametrize("mix_name", ["fresh", "fresh_lpips"])
def test_fresh_mix_misses_the_feature_cache(mix_name):
    from unipre3d_tpu_torch.data import Loader
    from unipre3d_tpu_torch.training.feature_cache import DeviceVAECache
    ds = pool(mix_name, 2 ** 33 + 5)
    keys = {ds.images[o, v].tobytes() for o in range(ds.n_obj)
            for v in range(ds.n_views)}
    assert len(keys) == ds.n_obj * ds.n_views       # no two images alike
    cache = DeviceVAECache(lambda x: torch.zeros(x.shape[0], 1, 16, 16),
                           SPEC["vae_cache_entries"], 16, 16, channels=1,
                           device="cpu")
    loader = Loader(ds, SPEC["batch_size"], seed=11, num_workers=1)
    batches = loader.iter_from(0)
    try:
        for i in range(160):            # ~ a 30 s window of the cell
            if i == 20:                 # past the cache's first filling
                h0, m0 = cache.hits, cache.misses
            cache.attach(next(batches), SPEC["input_images"])
    finally:
        batches.close()
        loader.close()
    hits, misses = cache.hits - h0, cache.misses - m0
    assert hits / (hits + misses) < 0.08
    assert hits > 0


SCENE = json.loads((BENCH / "configs" / "sparseunet_pretraining.json")
                   .read_text())


def rooms(seed, **over):
    mix = json.loads((BENCH / "traffic" / "rooms.json").read_text())
    mix.update(over)
    return generator.make_dataset(mix, SCENE, seed, torch.device("cpu"))


def test_scene_rooms_keep_50_to_80_thousand_rows():
    ds = rooms(2 ** 32 + 3, scenes=6, frames=4)
    rows = [int(r["mask"].sum()) for r in ds.rooms]
    assert all(50_000 <= n <= SCENE["max_points"] for n in rows), rows
    assert sum(n == SCENE["max_points"] for n in rows) >= len(rows) // 2


def test_scene_sample_schema_and_unprojection():
    ds = rooms(17, scenes=1, frames=20)
    s = ds[3]
    n_in, H, W = SCENE["input_images"], SCENE["training_height"], \
        SCENE["training_width"]
    assert s["gt_images"].shape == (2 * n_in, 3, H, W)
    assert s["unprojected_coords"].shape == (n_in, H, W, 4)
    pc = s["point_cloud"]
    assert pc["coord"].shape == (SCENE["max_points"], 3)
    assert pc["grid_coord"].dtype == np.int32 and pc["mask"].dtype == bool
    _, idx = ds.draw(3)
    assert len(set(idx)) == 2 * n_in
    # the unprojected pixels fall in the cloud's occupied voxels
    up = s["unprojected_coords"].reshape(-1, 4)
    up = up[up[:, 3] > 0, :3]
    assert len(up) > 0.5 * n_in * H * W
    grid = SCENE["grid_size"]
    occupied = {tuple(c) for c in pc["grid_coord"][pc["mask"]]}
    g = np.floor((up - pc["min_coord"]) / grid).astype(np.int64)
    near = [any((x + dx, y + dy, z + dz) in occupied for dx in (-1, 0, 1)
                for dy in (-1, 0, 1) for dz in (-1, 0, 1))
            for x, y, z in g[::97]]
    assert np.mean(near) > 0.95


def test_scene_traffic_is_fixed_by_the_seed():
    a, b = rooms(2 ** 31 + 1, scenes=2, frames=4), \
        rooms(2 ** 31 + 1, scenes=2, frames=4)
    for k, v in a[11].items():
        if isinstance(v, dict):
            for kk in v:
                np.testing.assert_array_equal(v[kk], b[11][k][kk])
        else:
            np.testing.assert_array_equal(v, b[11][k])
