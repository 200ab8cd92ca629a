"""PyTorch port vs the JAX package: the frozen-VAE feature cache.

The cases of tests/test_feature_cache.py, each held against the JAX cache:

* bookkeeping: on the same sequence of batches (duplicates within a batch,
  LRU evictions, the host tier's spills and promotions), the port's
  ``hits`` / ``l2_hits`` / ``misses``, its key -> slot map (in LRU order)
  and its host tier's keys equal JAX's after every ``attach``, and so do
  the attached features (exactly: the fake extractors are exact in
  float32);
* the one departure: the port runs the extractor on the misses as they
  are, where JAX pads them to power-of-two buckets;
* a float32 buffer equals the port's live VAE features bit for bit, and
  the cached predictor's gaussians equal the live ones bit for bit; the
  port's features equal JAX's within the VAE-tap tolerance of
  tests/test_torch_models.py (5e-5 of the largest magnitude); a bfloat16
  buffer is within 1e-2 of the live float32 features (the JAX docstring's
  bound);
* a cached train step's loss equals the live step's: bit for bit with a
  float32 buffer at float32, and in the default run (bfloat16 compute,
  bfloat16 buffer, where the VAE's output is bfloat16 already) too;
* the CLI's default run (bfloat16, the cache on) over a synthetic set
  small enough that conditioning images repeat: ``hit_rate > 0``, finite
  losses, ``metrics.jsonl`` written (three steps of 8 of the 64 object
  views). (The exact-resume test of
  tests/test_torch_eval.py runs at the defaults, the cache on.)
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch, _tiny_cfg
from unipre3d_tpu.training import feature_cache as jcache
from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu.training.config import apply_overrides
from unipre3d_tpu_torch import train_network
from unipre3d_tpu_torch.data import batch_to
from unipre3d_tpu_torch.training import trainer
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.training.feature_cache import (DeviceVAECache,
                                                       make_feature_fn)
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_utils import (  # noqa: F401
    one_torch_thread, run_dir, trimmed_heap)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = ["data.training_resolution=32", "opt.batch_size=2",
         "data.dataset_root=synthetic",
         "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
         "layers_per_block: 1}",
         "model.backbone_overrides={depth: 2, drop_path_rate: 0.0}"]
TOL_VAE_TAP = 5e-5
TOL_BF16_BUFFER = 1e-2


def rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-12)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def setup():
    """The small object predictor: a JAX float32 init and the port's
    models on its weights (float32 and bfloat16)."""
    jcfg = _tiny_cfg(tiny_vae=True)
    apply_overrides(jcfg, SMALL[-1:])
    batch = _synthetic_batch(jcfg, 2)
    jmodel, _, jstate = jtrainer.create_train_state(
        jcfg, jax.random.PRNGKey(0), batch)
    sd = jax_to_state_dict(np_tree(jstate.params),
                           np_tree(jstate.batch_stats))
    cfg = load_config("transformer_pretraining", overrides=SMALL)
    return dict(jcfg=jcfg, batch=batch, jmodel=jmodel, jstate=jstate, sd=sd,
                cfg=cfg, n_in=int(cfg.data.input_images))


def port_model(setup, dtype=torch.float32):
    model, state = trainer.create_train_state(
        setup["cfg"], device="cpu", state_dict=setup["sd"], dtype=dtype)
    return model, state


# -- bookkeeping against the JAX cache, with exact fake extractors ---------

def jax_fake(params, images):
    """Each image's first pixel, broadcast: exact in both packages."""
    return jnp.broadcast_to(images[:, :1, :1, :1],
                            (images.shape[0], 8, 4, 4))


def port_fake(calls):
    def fn(images):
        calls.append(images.shape[0])
        return images[:, :1, :1, :1].expand(images.shape[0], 8, 4, 4)
    return fn


def image_pool(n, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, 3, 4, 4)).astype(np.float32)


def assert_same_state(j, t, jout, tout):
    assert (j.hits, j.l2_hits, j.misses) == (t.hits, t.l2_hits, t.misses)
    assert list(j.slots.items()) == list(t.slots.items())
    assert list(j.host) == list(t.host)
    np.testing.assert_array_equal(np.asarray(jout), tout.numpy())
    assert j.hit_rate == t.hit_rate


def run_both(sequence, capacity, host_capacity=0):
    """Feed the same batches (lists of pool indices, [B, V]) through both
    caches; the states must agree after every attach."""
    pool = image_pool(16)
    j = jcache.DeviceVAECache(jax_fake, capacity, 4, 4, channels=8,
                              dtype=jnp.float32, host_capacity=host_capacity)
    calls = []
    t = DeviceVAECache(port_fake(calls), capacity, 4, 4, channels=8,
                       dtype=torch.float32, host_capacity=host_capacity,
                       device="cpu")
    for sel in sequence:
        sel = np.asarray(sel)
        b = {"gt_images": pool[sel.reshape(-1)].reshape(*sel.shape, 3, 4, 4)}
        n_in = sel.shape[1]
        assert_same_state(j, t, j.attach(b, None, n_in), t.attach(b, n_in))
    return j, t, calls


def test_lru_eviction():
    j, t, _ = run_both([[[1]], [[2]], [[1]], [[3]], [[1]], [[2]]],
                       capacity=2)
    assert t.misses == 4 and t.hits == 2 and len(t.slots) == 2


def test_host_spill_tier():
    j, t, calls = run_both([[[1]], [[2]], [[3]], [[1]]], capacity=2,
                           host_capacity=8)
    assert t.l2_hits == 1 and calls == [1, 1, 1]
    assert t.hit_rate == pytest.approx(1 / 4)


def test_duplicates_evictions_and_host_tier_sequence():
    """Batches of 3 examples x 2 views over a pool of 16 images, with
    repeats inside batches, through 6 slots and a 5-slot host tier."""
    rng = np.random.default_rng(3)
    seq = [rng.integers(0, 10, (3, 2)) for _ in range(12)]
    seq.append([[4, 4], [4, 5], [5, 4]])
    _, t, _ = run_both(seq, capacity=6, host_capacity=5)
    assert t.hits and t.l2_hits and t.misses


def test_miss_batches_run_unpadded():
    """JAX pads the extractor's batch to a power of two; the port runs it
    on the distinct misses as they are, with the same slots and
    counters."""
    _, t, calls = run_both([[[0], [1], [2]], [[3], [4], [5], [6], [7]],
                            [[8]], [[0], [1], [2]]], capacity=64)
    assert calls == [3, 5, 1]
    assert t.misses == 9 and t.hits == 3


def test_buffer_defaults_to_the_card(monkeypatch):
    """Like every entry point of the port, the cache puts its buffer on
    the card unless the caller names another device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceVAECache(port_fake([]), 2, 4, 4, channels=8)
    assert DeviceVAECache(port_fake([]), 2, 4, 4, channels=8,
                          device="cpu").buf.device.type == "cpu"


# -- the real VAE ----------------------------------------------------------

def test_cached_features_match_live_forward(setup):
    model, _ = port_model(setup)
    batch, n_in = setup["batch"], setup["n_in"]
    cache = DeviceVAECache(make_feature_fn(model), capacity=8, img_h=32,
                           img_w=32, channels=32, dtype=torch.float32,
                           device="cpu")
    imgs = torch.from_numpy(batch["gt_images"][:, :n_in])
    live = model.extract_vae_features(imgs.reshape(-1, 3, 32, 32))
    feats = cache.attach(batch, n_in)
    assert cache.misses == 2 * n_in and cache.hits == 0
    assert torch.equal(feats.reshape(live.shape), live)
    jfeats = jcache.make_feature_fn(setup["jmodel"])(
        setup["jstate"].params, jnp.asarray(imgs.reshape(-1, 3, 32, 32)
                                            .numpy()))
    assert rel_err(jfeats, live.numpy()) < TOL_VAE_TAP
    args = (torch.from_numpy(batch["point_cloud"]), imgs,
            torch.from_numpy(batch["view_to_world_transforms"][:, :n_in]))
    model.eval()
    with torch.no_grad():
        a = model(*args)
        b = model(*args, vae_features=feats)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(cache.attach(batch, n_in), feats)
    assert cache.hits == 2 * n_in


def test_bf16_buffer_tolerance(setup):
    model, _ = port_model(setup)
    batch, n_in = setup["batch"], setup["n_in"]
    cache = DeviceVAECache(make_feature_fn(model), capacity=8, img_h=32,
                           img_w=32, channels=32, device="cpu")   # bfloat16
    feats = cache.attach(batch, n_in)
    assert feats.dtype == torch.bfloat16
    live = model.extract_vae_features(torch.from_numpy(
        batch["gt_images"][:, :n_in]).reshape(-1, 3, 32, 32))
    assert rel_err(live.numpy(), feats.float().reshape(live.shape)) \
        < TOL_BF16_BUFFER


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_step_matches_live_loss(setup, dtype):
    """One train step from the same state, live VAE against the cache (the
    buffer in the compute dtype): the same loss and moments."""
    batch, n_in = setup["batch"], setup["n_in"]
    dt = getattr(torch, dtype)
    out = []
    for cached in (False, True):
        model, state = port_model(setup, dt)
        tb = batch_to(batch, "cpu")
        if cached:
            cache = DeviceVAECache(make_feature_fn(model), capacity=8,
                                   img_h=32, img_w=32, channels=32, dtype=dt,
                                   device="cpu")
            tb["vae_features"] = cache.attach(batch, n_in)
        m = trainer.make_train_step(setup["cfg"], model)(state, tb)
        out.append((m, [mu.clone() for mu in state.optimizer.mu]))
    (m_live, mu_live), (m_cached, mu_cached) = out
    assert m_cached["loss"] == m_live["loss"]
    assert math.isfinite(m_cached["loss"]) and m_cached["nan_skipped"] == 0
    for a, b in zip(mu_live, mu_cached):
        assert torch.equal(a, b)


def test_cli_default_run_hits_the_cache(run_dir):
    res = train_network.main(
        ["--config-name", "transformer_pretraining", "--device", "cpu",
         "--output-dir", str(run_dir), "opt.iterations=3",
         "opt.batch_size=8", "logging.loss_log=1", "logging.val_log=100"]
        + SMALL[:1] + SMALL[2:])
    assert res["compute_dtype"] == "bfloat16"
    assert res["hit_rate"] > 0 and res["cache_counts"]["hits"] > 0
    assert len(res["losses"]) == 3 and len(res["cache_ms"]) == 3
    assert all(math.isfinite(x) for x in res["losses"] + res["grad_norms"])
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    train = [x for x in lines if "train/loss" in x]
    assert [x["step"] for x in train] == [1, 2, 3]
    assert train[-1]["train/vae_cache_hit_rate"] == round(res["hit_rate"], 4)
    assert all(x["train/samples_per_sec"] > 0 for x in train)
    assert any("val/psnr_novel" in x for x in lines)
