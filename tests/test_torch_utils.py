"""PyTorch port vs the JAX package: config, camera, SH and losses.

Same numpy inputs through both; float32 on the CPU. Tolerances: 1e-6
absolute for elementwise maths of O(1) values (float32 rounding of
reassociated expressions), 1e-5 relative for means over images.

Also the heap fixture every port test module takes (``trimmed_heap``) and
the thread fixture of the torch-heavy ones (``one_torch_thread``).
"""

import ctypes
import gc
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unipre3d_tpu.training.config import load_config as jax_load_config
from unipre3d_tpu.utils import camera as jcam
from unipre3d_tpu.utils import losses as jloss
from unipre3d_tpu.utils import sh as jsh
from unipre3d_tpu_torch import resolve_device
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.utils import camera as tcam
from unipre3d_tpu_torch.utils import losses as tloss
from unipre3d_tpu_torch.utils import sh as tsh


def release_memory():
    """Hand the heap this process has freed back to the OS. The suite runs
    several test processes on one host at once, and glibc keeps what a JAX
    or torch reference freed until it is trimmed (measured: 5.1 of the 5.9
    GiB a JAX scene step leaves resident)."""
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        trim(0)


@pytest.fixture(scope="module", autouse=True)
def trimmed_heap():
    """``release_memory`` after the tests of each port module that imports
    this fixture."""
    yield
    release_memory()


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op torch thread while a module's tests that ask for it run:
    the suite runs several test processes on the host's cores at once,
    where torch's own thread pool would oversubscribe them (its small ops
    gain nothing from more threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_config_matches_jax_except_tpu_block():
    over = ["opt.batch_size=4", "model.backbone_overrides={depth: 2}"]
    t = load_config("transformer_pretraining", overrides=over).to_plain()
    j = jax_load_config("transformer_pretraining", overrides=over).to_plain()
    # the port's tpu block holds the renderer, precision and feature-cache
    # keys it reads, with the JAX package's values
    tt, jt = t.pop("tpu"), j.pop("tpu")
    assert tt == {"raster_impl": "xla", "raster_impl_train": "auto",
                  "raster_tile_capacity": 1024, "compute_dtype": "bfloat16",
                  "param_dtype": "float32", "vae_cache_entries": 512}
    assert all(jt[k] == v for k, v in tt.items())
    assert t == j
    assert load_config("default_config").model.backbone_type == "transformer"


def test_camera_matrices_and_quaternions():
    rng = np.random.default_rng(0)
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    t = rng.normal(size=3)
    fov = math.radians(49.13)
    a = jcam.build_camera_tensors(R, t, fov, fov, 0.5, 2.0)
    b = tcam.build_camera_tensors(R, t, fov, fov, 0.5, 2.0)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(jcam.intrinsics_from_fov(49.13, 128),
                                  tcam.intrinsics_from_fov(49.13, 128))
    q = rng.normal(size=(7, 4)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jcam.quat_to_rotmat(jnp.asarray(q))),
        tcam.quat_to_rotmat(torch.from_numpy(q)).numpy(), atol=1e-6)
    v = rng.uniform(-1, 1, 11).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jcam.ndc2pix(jnp.asarray(v), 128)),
                               tcam.ndc2pix(torch.from_numpy(v), 128).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_eval_and_clamped_rgb(deg):
    rng = np.random.default_rng(deg)
    k = (deg + 1) ** 2
    sh = rng.normal(size=(5, 9, k, 3)).astype(np.float32)
    d = rng.normal(size=(5, 9, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    a = jsh.sh_to_rgb_clamped(deg, jnp.asarray(sh), jnp.asarray(d))
    b = tsh.sh_to_rgb_clamped(deg, torch.from_numpy(sh), torch.from_numpy(d))
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5)
    rgb = rng.uniform(0, 1, (4, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.sh2rgb(tsh.rgb2sh(rgb)), rgb, atol=1e-6)


@pytest.mark.parametrize("white", [False, True])
def test_losses_and_psnr(white):
    rng = np.random.default_rng(1)
    bg = [1.0, 1.0, 1.0] if white else [0.0, 0.0, 0.0]
    gt = rng.uniform(0, 1, (3, 3, 8, 8)).astype(np.float32)
    gt[:, :, :4] = np.asarray(bg, np.float32)[None, :, None, None]
    pred = rng.uniform(0, 1, (3, 3, 8, 8)).astype(np.float32)
    j = lambda f, *a: float(f(jnp.asarray(pred), jnp.asarray(gt), *a))
    t = lambda f, *a: float(f(torch.from_numpy(pred), torch.from_numpy(gt),
                              *a))
    assert t(tloss.focal_l2_loss, bg, 4.0, 1.0) == pytest.approx(
        j(jloss.focal_l2_loss, bg, 4.0, 1.0), rel=1e-5)
    assert t(tloss.l1_loss) == pytest.approx(j(jloss.l1_loss), rel=1e-5)
    assert t(tloss.l2_loss) == pytest.approx(j(jloss.l2_loss), rel=1e-5)
    assert t(tloss.psnr) == pytest.approx(j(jloss.psnr), rel=1e-5)


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
