"""PyTorch port vs the JAX package: weights, backbone, fusion, VAE taps and
the object predictor, on the same weights (a JAX init converted by
unipre3d_tpu_torch/weights.py) and the same numpy inputs.

Small size: 32x32 views, batch 2, 256 points, VAE [32,32,32,32] with one
layer per block, transformer depth 2 without DropPath. Tolerances, each
relative to the largest magnitude of the compared tensor:

* 1e-5 for the backbone tokens and fusion (float32 matmuls summed in
  another order; flax computes LayerNorm and BatchNorm variance as
  E[x^2] - E[x]^2, torch's LayerNorm two-pass);
* 5e-5 for the VAE taps: about twenty convolutions and GroupNorms deep,
  with the same variance difference in every GroupNorm (measured 1.3e-5);
* 1e-4 for the predictor's activated Gaussians and the backbone's
  gradients (deeper chains of the same rounding). Biases ahead of a
  BatchNorm have an analytically zero gradient; there both sides must be
  rounding noise of a sum over 8192 cancelling rows (< 1e-3 of the largest
  gradient; measured up to 1.1e-4).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch, _tiny_cfg
from unipre3d_tpu.models import fusion as jfusion
from unipre3d_tpu.models.transformer import PointTransformerEncoder
from unipre3d_tpu.models.vae import AutoencoderKL, convert_torch_vae_state_dict
from unipre3d_tpu.training.config import apply_overrides
from unipre3d_tpu.training.trainer import create_train_state
from unipre3d_tpu.utils.camera import intrinsics_from_fov
from unipre3d_tpu_torch.models import fusion as tfusion
from unipre3d_tpu_torch.models.gaussian_predictor import build_predictor
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = ["data.training_resolution=32", "opt.batch_size=2",
         "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
         "layers_per_block: 1}",
         "model.backbone_overrides={depth: 2, drop_path_rate: 0.0}"]
PRE_BN_BIASES = ("encoder.conv1.bias", "encoder.conv2.bias",
                 "encoder.conv3.bias")


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-12)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def setup():
    jcfg = _tiny_cfg(tiny_vae=True)
    apply_overrides(jcfg, SMALL[-1:])
    batch = _synthetic_batch(jcfg, 2)
    jmodel, _, state = create_train_state(jcfg, jax.random.PRNGKey(0), batch)
    params, stats = np_tree(state.params), np_tree(state.batch_stats)
    tmodel = build_predictor(load_config("transformer_pretraining",
                                         overrides=SMALL))
    tmodel.load_state_dict(jax_to_state_dict(params, stats))
    return jmodel, params, stats, tmodel, batch


def test_state_dict_covers_every_tensor(setup):
    _, params, stats, tmodel, _ = setup
    sd = jax_to_state_dict(params, stats)
    assert set(sd) == set(tmodel.state_dict())
    n_jax = sum(np.size(v) for v in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in tmodel.parameters()) == n_jax


def test_vae_names_are_diffusers(setup):
    """The port's VAE state dict goes through the JAX package's diffusers
    converter and back unchanged."""
    _, _, _, tmodel, _ = setup
    vae_sd = {k: v.numpy() for k, v in
              tmodel.image_network.state_dict().items()}
    back = jax_to_state_dict({"image_network": convert_torch_vae_state_dict(
        vae_sd, n_blocks=4, layers_per_block=1)})
    assert set(back) == {f"image_network.{k}" for k in vae_sd}
    for k, v in vae_sd.items():
        np.testing.assert_array_equal(back[f"image_network.{k}"].numpy(), v)


def test_vae_decoder_taps(setup):
    _, params, _, tmodel, _ = setup
    img = np.random.default_rng(0).uniform(
        0, 1, (2, 3, 32, 32)).astype(np.float32)
    jvae = AutoencoderKL(block_out_channels=(32, 32, 32, 32),
                         layers_per_block=1)
    a = jvae.apply({"params": params["image_network"]}, jnp.asarray(img))
    with torch.no_grad():
        b = tmodel.image_network(torch.from_numpy(img))
    for k in ("decoder_block_0", "decoder_block_1", "decoder_block_2",
              "decoder_block_3", "sample"):
        assert rel_err(a[k], b[k].numpy()) < 5e-5, k


def test_transformer_train_mode_forward_grads_and_bn_stats(setup):
    _, params, stats, tmodel, batch = setup
    pts = batch["point_cloud"]
    enc_p = params["point_network"]["encoder"]
    enc_s = stats["point_network"]["encoder"]
    jenc = PointTransformerEncoder(num_groups=128, encoder_dims=384, depth=2,
                                   drop_path_rate=0.0)
    w = np.random.default_rng(1).normal(size=(2, 128, 384)).astype(np.float32)

    def jloss(p):
        (tok, _), upd = jenc.apply({"params": p, "batch_stats": enc_s},
                                   jnp.asarray(pts), train=True,
                                   mutable=["batch_stats"])
        return jnp.sum(tok * w), (tok, upd["batch_stats"])

    (_, (jtok, jstats)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        enc_p)
    tenc = copy.deepcopy(tmodel.point_network.encoder).train()
    ttok, _ = tenc(torch.from_numpy(pts))
    (ttok * torch.from_numpy(w)).sum().backward()
    assert rel_err(jtok, ttok.detach().numpy()) < 1e-5
    jg = jax_to_state_dict(np_tree(jgrad))
    gmax = max(np.abs(v.numpy()).max() for v in jg.values())
    for name, p in tenc.named_parameters():
        if name in PRE_BN_BIASES:
            assert np.abs(jg[name].numpy()).max() < 1e-3 * gmax
            assert float(p.grad.abs().max()) < 1e-3 * gmax
        else:
            assert rel_err(jg[name], p.grad.numpy()) < 1e-4, name
    js = jax_to_state_dict({}, np_tree(jstats))
    for name, buf in tenc.named_buffers():
        assert rel_err(js[name], buf.numpy()) < 1e-5, name


def test_fusion_zbuffer_gather_and_projection():
    rng = np.random.default_rng(2)
    batch = _synthetic_batch(_tiny_cfg(), 2)
    c2w = batch["view_to_world_transforms"][:, :1]
    center = rng.uniform(-0.5, 0.5, (2, 128, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 16, 32, 32)).astype(np.float32)
    K = intrinsics_from_fov(49.13434264120263, 32)
    pa, za = jfusion.project_points_to_image(
        jnp.asarray(center), jnp.asarray(c2w[:, 0]), jnp.asarray(K))
    pb, zb = tfusion.project_points_to_image(
        torch.from_numpy(center), torch.from_numpy(c2w[:, 0]),
        torch.from_numpy(K))
    np.testing.assert_array_equal(np.asarray(pa), pb.numpy())
    np.testing.assert_allclose(np.asarray(za), zb.numpy(), atol=1e-6)
    proj = rng.normal(size=(16, 8)).astype(np.float32)
    x = rng.normal(size=(2, 129, 24)).astype(np.float32)
    a = jfusion.feature_fusion(
        jnp.asarray(x), jnp.asarray(center), jnp.asarray(feats),
        jnp.asarray(c2w), jnp.asarray(K), lambda v: v,
        image_proj=lambda r: r @ jnp.asarray(proj))
    b = tfusion.feature_fusion(
        torch.from_numpy(x), torch.from_numpy(center),
        torch.from_numpy(feats), torch.from_numpy(c2w), torch.from_numpy(K),
        lambda v: v, image_proj=lambda r: r @ torch.from_numpy(proj))
    assert rel_err(a, b.numpy()) < 1e-5
    mapped = b.numpy()[:, 1:, 24:]
    hit = np.abs(mapped).sum(-1) > 0
    # some points are occluded (z-buffer losers) or out of view, most not
    assert 0 < hit.sum() < hit.size


def test_predictor_forward(setup):
    jmodel, params, stats, tmodel, batch = setup
    args = (batch["point_cloud"], batch["gt_images"][:, :1],
            batch["view_to_world_transforms"][:, :1])
    a = jmodel.apply({"params": params, "batch_stats": stats},
                     *map(jnp.asarray, args), train=False)
    with torch.no_grad():
        b = tmodel.eval()(*map(torch.from_numpy, args))
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == tuple(b[k].shape), k
        assert rel_err(a[k], b[k].numpy()) < 1e-4, k
