"""PyTorch port vs the JAX package: the tiled renderer and what routes to
it (``_compact_gather``, ``rasterize_projected`` with its capacity cut,
``rasterize`` for every ``impl``, and the training step's
``render_supervision_views`` on the ``auto`` route above 4096 gaussians;
``render_predicted`` is held in tests/test_torch_eval.py, under the test
renders).

Same numpy inputs through both; the JAX Pallas kernels run in interpret
mode, at <= 16 tiles.

Tolerances and reasons:
* ``_compact_gather``: forward exactly equal (a gather); its cotangent 1e-5
  absolute: JAX forms each segment sum as a difference of one running sum
  over all T*K slots (|sum| ~10 here), which carries that sum's rounding
  (measured 1.8e-6); the port adds each segment directly;
* images: 2e-5 absolute per pixel, at most 2 pixels of a case beyond it
  (with 1e-3 as their bound): both packages cumsum log(1 - alpha) in
  float32 but not in the same order, so a pixel at the T threshold may flip
  (none does here; measured <= 1e-6);
* gradients: 1e-4 relative to each tensor's largest entry (autodiff of the
  same operations, summed in other orders; measured <= 2e-6).

The JAX references run under ``jax.jit`` (compiled once per shape), except
in the N = 5000 case: there the jitted XLA CPU code rounds its fused
exp/log/cumsum otherwise than the same operations run one by one (its
gradients move by 2e-4 relative, and 4 of the 2,048 pixels take the other
stop decision), while the eager JAX run and the port agree to 5e-7.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unipre3d_tpu.ops.rasterizer import render as jrender
from unipre3d_tpu.ops.rasterizer.preprocess import \
    ProjectedGaussians as JProjected
from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu.training.config import load_config as jload_config
from unipre3d_tpu.utils import camera as jcam
from unipre3d_tpu_torch.ops.rasterizer import render as trender
from unipre3d_tpu_torch.ops.rasterizer.preprocess import ProjectedGaussians
from unipre3d_tpu_torch.training import trainer
from unipre3d_tpu_torch.training.config import load_config
from test_torch_splat_binned import FIELDS, projected
from test_torch_splat_stream import one_torch_thread  # noqa: F401
from test_torch_utils import trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RES = 32
BG = np.asarray([0.1, 0.2, 0.3], np.float32)
FOV = math.radians(49.13)


def assert_images(jimg, timg):
    err = np.abs(np.asarray(jimg) - np.asarray(timg)).max(axis=-3)
    flipped = err > 2e-5
    assert flipped.sum() <= 2, (flipped.sum(), err.max())
    assert err.max() <= 1e-3


def assert_grads(names, jg, tg):
    for name, a, b in zip(names, jg, tg):
        a = np.asarray(a).reshape(b.shape)
        assert np.isfinite(b).all(), name
        err = np.abs(a - b).max() / (np.abs(a).max() + 1e-12)
        assert err < 1e-4, (name, err)


def test_compact_gather_forward_and_cotangent():
    rng = np.random.default_rng(0)
    n, T, K = 50, 6, 12
    fields = rng.normal(size=(n, 9)).astype(np.float32)
    cand = rng.integers(0, n, (T, K)).astype(np.int32)
    slot_ok = rng.uniform(size=(T, K)) < 0.7
    dg = rng.normal(size=(T, K, 9)).astype(np.float32)
    jout, vjp = jax.vjp(lambda f: jrender._compact_gather(
        f, jnp.asarray(cand), jnp.asarray(slot_ok)), jnp.asarray(fields))
    f = torch.from_numpy(fields).requires_grad_(True)
    tout = trender._compact_gather(f, torch.from_numpy(cand).long(),
                                   torch.from_numpy(slot_ok))
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    tout.backward(torch.from_numpy(dg))
    np.testing.assert_allclose(f.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(dg))[0]),
                               atol=1e-5)


@pytest.mark.parametrize("capacity,tile", [(16, 8), (1024, 16)])
def test_tiled_renderer_matches_jax(capacity, tile):
    """Capacity 16 cuts most 8x8 tiles (their farthest gaussians dropped);
    1024 keeps every gaussian. Two views in one port call, forward and the
    gradients w.r.t. mean2d, conic, color, opacity and bg."""
    p = projected(n=600, views=2, scale=0.03)
    cot = np.random.default_rng(5).normal(size=(2, 3, RES, RES)).astype(
        np.float32)
    @jax.jit
    def jrun(fields, cot):
        pg = JProjected(*fields)

        def f(m, c, col, o, bg):
            return jrender.rasterize_projected(
                pg._replace(mean2d=m, conic=c, color=col, opacity=o), bg,
                RES, RES, tile, tile, capacity)
        img, vjp = jax.vjp(f, pg.mean2d, pg.conic, pg.color, pg.opacity,
                           BG)
        return img, vjp(cot)
    jimgs, jgs = zip(*(jrun(tuple(jnp.asarray(p[k][v]) for k in FIELDS),
                            jnp.asarray(cot[v])) for v in range(2)))
    t = [torch.from_numpy(p[k]).clone() for k in FIELDS]
    for x in t[:4]:
        x.requires_grad_(True)
    bg = torch.from_numpy(BG).clone().requires_grad_(True)
    timg = trender.rasterize_projected(ProjectedGaussians(*t), bg, RES, RES,
                                       tile, tile, capacity)
    (timg * torch.from_numpy(cot)).sum().backward()
    assert_images(np.stack(jimgs), timg.detach().numpy())
    jg = [np.stack([np.asarray(g[i]) for g in jgs]) for i in range(4)] + \
        [sum(np.asarray(g[4]) for g in jgs)]
    assert_grads(("mean2d", "conic", "color", "opacity", "bg"), jg,
                 [x.grad.numpy() for x in t[:4]] + [bg.grad.numpy()])
    if capacity == 16:
        x0 = torch.arange(16) % 4 * 8
        counts = ((t[0][0, :, 0, None] + t[5][0, :, None] >= x0)
                  & (t[0][0, :, 0, None] - t[5][0, :, None] <= x0 + 7))
        assert int(counts.sum(0).max()) > 16       # a cut tile


def scene_of(n, seed=2):
    """Numpy gaussian dict of one example, in the view of ``camera``."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g = {"xyz": rng.uniform(-0.35, 0.35, (n, 3)),
         "opacity": rng.uniform(0.2, 0.9, (n, 1)),
         "scaling": rng.uniform(0.005, 0.03, (n, 3)),
         "rotation": q,
         "features_dc": rng.uniform(-1, 1, (n, 1, 3)),
         "features_rest": rng.normal(scale=0.2, size=(n, 3, 3))}
    g = {k: v.astype(np.float32) for k, v in g.items()}
    return g


def camera(angle):
    R = np.array([[math.cos(angle), 0, math.sin(angle)], [0, 1, 0],
                  [-math.sin(angle), 0, math.cos(angle)]])
    return jcam.build_camera_tensors(R, np.array([0.0, 0.0, 1.5]), FOV, FOV,
                                     0.5, 2.0)


RASTER_ARGS = ("xyz", "opacity", "scaling", "rotation", "shs")


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_binned"])
def test_rasterize_every_impl_matches_jax(impl):
    """One view at 16x16 with 8x8 tiles and capacity 64 (the tiled route
    cuts tiles), forward and the gradients w.r.t. the 3D parameters."""
    res = 16
    g = scene_of(300)
    shs = np.concatenate([g["features_dc"], g["features_rest"]], 1)
    ins = [g["xyz"], g["opacity"][:, 0], g["scaling"], g["rotation"], shs]
    c = camera(0.3)
    cams = [c["world_view_transform"], c["full_proj_transform"],
            c["camera_center"]]
    mask = np.arange(300) % 7 != 0
    kw = dict(img_h=res, img_w=res, tanfovx=math.tan(FOV / 2),
              tanfovy=math.tan(FOV / 2), sh_degree=1, tile_h=8, tile_w=8,
              capacity=64, impl=impl)
    cot = np.random.default_rng(4).normal(size=(3, res, res)).astype(
        np.float32)
    @jax.jit
    def jrun(ins, cams, mask, cot):
        img, vjp = jax.vjp(lambda *a: jrender.rasterize(
            *a, *cams, bg_color=BG, gaussian_mask=mask, **kw)["render"],
            *ins)
        return img, vjp(cot)
    jimg, jg = jrun(tuple(jnp.asarray(x) for x in ins),
                    tuple(jnp.asarray(x) for x in cams), jnp.asarray(mask),
                    jnp.asarray(cot))
    t = [torch.from_numpy(x).requires_grad_(True) for x in ins]
    out = trender.rasterize(*t, *(torch.from_numpy(x) for x in cams),
                            bg_color=BG.tolist(),
                            gaussian_mask=torch.from_numpy(mask), **kw)
    (out["render"] * torch.from_numpy(cot)).sum().backward()
    assert_images(np.asarray(jimg), out["render"].detach().numpy())
    assert_grads(RASTER_ARGS, jg, [x.grad.numpy() for x in t])
    assert int((out["radii"] > 0).sum()) > 100


GAUSS_KEYS = ("xyz", "opacity", "scaling", "rotation", "features_dc",
              "features_rest")


def test_supervision_views_auto_route_above_4096_matches_jax():
    """render_supervision_views at N = 5000 (B = 1, two supervision views,
    32x32: one tile, capacity 512 of the ~4,000 overlapping gaussians):
    JAX's XLA route and the port's tiled renderer, forward and gradients
    w.r.t. every gaussian field."""
    over = ["data.training_width=32", "data.training_height=32",
            "data.input_images=1", "tpu.raster_tile_capacity=512"]
    jcfg = jload_config("sparseunet_pretraining", overrides=over)
    tcfg = load_config("sparseunet_pretraining", overrides=over)
    assert str(tcfg.tpu.raster_impl_train) == "auto"
    n = 5000
    g = {k: v[None] for k, v in scene_of(n, seed=4).items()}
    mask = (np.arange(n) % 9 != 0)[None]
    cams = [camera(a) for a in (0.0, 0.5, -0.5)]
    batch = {"world_view_transforms": np.stack(
        [c["world_view_transform"] for c in cams])[None],
             "full_proj_transforms": np.stack(
        [c["full_proj_transform"] for c in cams])[None],
             "camera_centers": np.stack([c["camera_center"]
                                         for c in cams])[None],
             "gt_images": np.zeros((1, 3, 3, 32, 32), np.float32)}
    cot = np.random.default_rng(6).normal(size=(1, 2, 3, 32, 32)).astype(
        np.float32)
    bg = np.ones(3, np.float32)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jf(*vals):
        return jtrainer.render_supervision_views(
            dict(zip(GAUSS_KEYS, vals), mask=jnp.asarray(mask)), jbatch,
            jcfg, bg)
    jimg, vjp = jax.vjp(jf, *(jnp.asarray(g[k]) for k in GAUSS_KEYS))
    jg = vjp(jnp.asarray(cot))
    t = {k: torch.from_numpy(g[k]).requires_grad_(True) for k in GAUSS_KEYS}
    timg = trainer.render_supervision_views(
        dict(t, mask=torch.from_numpy(mask)),
        {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
        bg.tolist())
    (timg * torch.from_numpy(cot)).sum().backward()
    assert timg.shape == (1, 2, 3, 32, 32)
    assert_images(np.asarray(jimg), timg.detach().numpy())
    assert_grads(GAUSS_KEYS, jg, [t[k].grad.numpy() for k in GAUSS_KEYS])


@pytest.mark.parametrize("impl", ["pallas", "binned"])
def test_unknown_train_route_raises(impl):
    """The training step has the routes auto, pallas_dense, pallas_binned
    and xla. Any other value raises, the streaming splat's ``pallas``
    included: the JAX trainer reads a value it does not know as ``xla``,
    and the port does not guess."""
    cfg = load_config("transformer_pretraining", overrides=[
        "data.training_resolution=16", f"tpu.raster_impl_train={impl}"])
    g = {k: torch.from_numpy(v[None]) for k, v in scene_of(8).items()}
    c = camera(0.0)
    batch = {k: torch.from_numpy(np.stack([c[src]] * 2)[None]) for k, src in (
        ("world_view_transforms", "world_view_transform"),
        ("full_proj_transforms", "full_proj_transform"),
        ("camera_centers", "camera_center"))}
    with pytest.raises(ValueError, match="raster_impl_train"):
        trainer.render_supervision_views(g, batch, cfg, [0.0] * 3)
