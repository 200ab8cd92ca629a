"""PyTorch port vs the JAX package: the eval side of the trainer (SSIM, the
eval step, ``evaluate_dataset``), the eval and train CLIs with their
checkpoints, and the test renders (``render_predicted`` at ``xla`` and
``pallas``, the orbit, the render | GT views).

Both packages run the small object configuration of
tests/test_torch_train_step.py (32x32, VAE [32,32,32,32] x1, depth 2) from
the same weights (a JAX init converted by unipre3d_tpu_torch/weights.py),
with an EMA that differs from the parameters, on the same numpy batches.

Tolerances and reasons:
* SSIM alone: 1e-6 absolute (the same 11x11 depthwise convolution, summed
  in another order);
* eval PSNR and SSIM: 1e-5 relative, and SSIM also 1e-6 absolute: SSIM
  of these random-noise ground truths is small (~0.04) and its float32
  rounding, a difference of nearly cancelling window sums, ~1e-6 absolute
  (measured 9e-7, 2.4e-5 relative, on one example; PSNR ~1e-7 relative);
* rendered views: 5e-5 absolute: their gaussians come out of two float32
  forwards (VAE features, transformer, head) that agree to ~1e-6 relative
  (measured 1.6e-5);
* ``render_predicted``: 2e-5 absolute (the renderers' own tolerance, see
  tests/test_torch_render_tiled.py and test_torch_splat_stream.py);
* test renders: uint8 frames within 1 level (a float32 difference can move
  a value across a rounding boundary of the 0-255 scale);
* the resumed run: bit-identical to the uninterrupted one (one process on
  the CPU, same operations in the same order).
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
from unipre3d_tpu.ops.rasterizer import render as jrender
from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu.training import video as jvideo
from unipre3d_tpu.training.config import apply_overrides
from unipre3d_tpu.training.config import load_config as jload_config
from unipre3d_tpu.utils import losses as jloss
from unipre3d_tpu_torch import eval as teval
from unipre3d_tpu_torch import train_network
from unipre3d_tpu_torch.data import Loader, batch_to, get_dataset
from unipre3d_tpu_torch.ops.rasterizer import render as trender
from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
from unipre3d_tpu_torch.training import checkpoint as ckpt_lib
from unipre3d_tpu_torch.training import trainer, video
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.utils import losses as tloss
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_splat_stream import one_torch_thread  # noqa: F401
from test_torch_utils import trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = ["data.training_resolution=32", "opt.batch_size=2",
         "data.dataset_root=synthetic", "opt.ema.update_after_step=1",
         "opt.ema.update_every=1",
         "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
         "layers_per_block: 1}",
         "model.backbone_overrides={depth: 2, drop_path_rate: 0.0}"]


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_matches_jax(size_average):
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (2, 3, 3, 20, 24)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(
        np.float32)
    want = np.asarray(jloss.ssim(jnp.asarray(a), jnp.asarray(b),
                                 size_average=size_average))
    got = tloss.ssim(torch.from_numpy(a), torch.from_numpy(b),
                     size_average=size_average).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


class ListLoader:
    """A fixed list of numpy batches, as Loader.epoch gives them."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, _):
        yield from self.batches


@pytest.fixture(scope="module")
def pair():
    """Both packages' models from one JAX init, the JAX EMA perturbed away
    from the parameters (the frozen VAE's EMA stays equal to them), and a
    jitted JAX eval step."""
    jcfg = _tiny_cfg(tiny_vae=True)
    apply_overrides(jcfg, SMALL[-3:])
    batch = _synthetic_batch(jcfg, 1, seed=0)
    jmodel, _, jstate = jtrainer.create_train_state(
        jcfg, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(1)

    def perturb(path, v):
        if jtrainer._is_frozen(path):
            return v
        v = np.asarray(v)
        return jnp.asarray(v * (1 + 0.05 * rng.normal(size=v.shape))
                           .astype(np.float32))
    jstate = jstate._replace(ema_params=jax.tree_util.tree_map_with_path(
        perturb, jstate.params))
    tcfg = load_config("transformer_pretraining", overrides=SMALL)
    tmodel, tstate = trainer.create_train_state(
        tcfg, device="cpu", state_dict=jax_to_state_dict(
            np_tree(jstate.params), np_tree(jstate.batch_stats)))
    ema = jax_to_state_dict(np_tree(jstate.ema_params))
    for n in tstate.ema:
        tstate.ema[n].copy_(ema[n])
    batches = [_synthetic_batch(jcfg, 1, seed=s) for s in range(3)]
    batches[1]["gt_images"][0, 2] = 0.0         # an all-black novel view
    return dict(jcfg=jcfg, jmodel=jmodel, jstate=jstate, tcfg=tcfg,
                tmodel=tmodel, tstate=tstate, batches=batches,
                jeval=jax.jit(jtrainer.make_eval_step(jcfg, jmodel)))


def test_eval_step_matches_jax_with_the_ema(pair):
    batch = pair["batches"][0]
    jm = pair["jeval"](pair["jstate"], batch)
    tstep = trainer.make_eval_step(pair["tcfg"], pair["tmodel"])
    tm = tstep(pair["tstate"], batch_to(batch, "cpu"))
    for k in ("psnr_cond", "psnr_novel", "ssim_cond", "ssim_novel"):
        assert float(tm[k]) == pytest.approx(
            float(jm[k]), rel=1e-5, abs=1e-6 if "ssim" in k else 0), k
    assert tm["rendered"].shape == (1, 3, 3, 32, 32)
    np.testing.assert_allclose(tm["rendered"].numpy(),
                               np.asarray(jm["rendered"]), atol=5e-5)
    # the EMA, not the parameters: the renders differ without it
    raw = trainer.make_eval_step(pair["tcfg"], pair["tmodel"],
                                 use_ema=False)(pair["tstate"],
                                                batch_to(batch, "cpu"))
    assert float((raw["rendered"] - tm["rendered"]).abs().max()) > 1e-3


def test_evaluate_dataset_matches_jax(pair, tmp_path):
    from eval import evaluate_dataset as jevaluate
    loader = ListLoader(pair["batches"])
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    want = jevaluate(pair["jmodel"], pair["jeval"], pair["jstate"], loader,
                     pair["jcfg"], str(jdir))
    got = teval.evaluate_dataset(
        pair["tmodel"], trainer.make_eval_step(pair["tcfg"], pair["tmodel"]),
        pair["tstate"], loader, pair["tcfg"], str(tdir), save_vis=1)
    assert set(got) == set(want) == set(teval.SCORE_KEYS)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert got[k] == pytest.approx(
                v, rel=1e-5, abs=1e-6 if "SSIM" in k else 0), k
    jl = (jdir / "scores.txt").read_text().splitlines()
    tl = (tdir / "scores.txt").read_text().splitlines()
    assert len(jl) == len(tl) == 3
    for a, b in zip(jl, tl):
        (ja, *jn), (ta, *tn) = a.split(), b.split()
        assert ja == ta and jn[2] == tn[2] == "None"
        assert float(tn[0]) == pytest.approx(float(jn[0]), rel=1e-5)
        assert float(tn[1]) == pytest.approx(float(jn[1]), rel=1e-5,
                                             abs=1e-6)
    vis = sorted(os.listdir(tdir / "vis_0000"))
    assert len(vis) == 6 and vis[0] == "00000_gt.png"


def checkpoint_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "best_psnr"}


def test_exact_resume_checkpoint_round_trip_and_eval_cli(tmp_path):
    """One step, stop, resume to two == two straight (DropPath on, the EMA
    decaying every step): every array of the checkpoint bit for bit; a
    checkpoint loaded into a fresh model and state holds what was saved;
    and the eval CLI scores the run's test split."""
    over = SMALL[:-1] + ["model.backbone_overrides={depth: 2}",
                         "logging.val_log=100"]
    args = ["--config-name", "transformer_pretraining", "--device", "cpu",
            "logging.loss_log=1"] + over
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    first = train_network.main(args + ["--output-dir", a, "opt.iterations=1"])
    second = train_network.main(args + ["--output-dir", a,
                                        "opt.iterations=2"])
    straight = train_network.main(args + ["--output-dir", b,
                                          "opt.iterations=2"])
    assert len(first["losses"]) == 1 and len(second["losses"]) == 1
    assert second["losses"] == straight["losses"][1:]
    assert [v["iteration"] for v in straight["val"]] == [2]
    assert math.isfinite(straight["val"][0]["psnr_novel"])
    ca = checkpoint_arrays(os.path.join(a, "model_latest.ckpt"))
    cb = checkpoint_arrays(os.path.join(b, "model_latest.ckpt"))
    assert set(ca) == set(cb) and int(ca["step"]) == 2
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)
    cfg = load_config("transformer_pretraining", overrides=over)
    model, state = trainer.create_train_state(cfg, device="cpu", seed=5)
    state, best = ckpt_lib.load_checkpoint(
        os.path.join(b, "model_latest.ckpt"), model, state)
    assert state.step == 2 and state.optimizer.count == 2 and best == 0.0
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), cb[f"model/{k}"])
    for k, v in state.ema.items():
        np.testing.assert_array_equal(v.numpy(), cb[f"ema/{k}"])
    assert os.path.exists(os.path.join(b, ".hydra", "config.yaml"))
    assert os.path.exists(os.path.join(b, "model_best.ckpt"))
    scores = teval.main([b, "--device", "cpu"])
    assert set(scores) == set(teval.SCORE_KEYS)
    for k in ("PSNR_cond", "PSNR_novel", "SSIM_cond", "SSIM_novel"):
        assert math.isfinite(scores[k]), k
    assert scores["LPIPS_novel"] is None and scores["LPIPS_cond"] is None
    with open(os.path.join(b, "test_scores.json")) as f:
        assert json.load(f) == scores
    lines = open(os.path.join(b, "scores.txt")).read().splitlines()
    assert len(lines) == len(get_dataset(cfg, "test", "cpu")) == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            teval.main([b])


def gaussian_dict(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"xyz": rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
            "opacity": np.full((n, 1), 0.8, np.float32),
            "scaling": rng.uniform(0.03, 0.08, (n, 3)).astype(np.float32),
            "rotation": np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
            "features_dc": rng.uniform(-1, 1, (n, 1, 3)).astype(np.float32),
            "features_rest": np.zeros((n, 3, 3), np.float32)}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_orbit_and_test_view_frames_match_jax(impl):
    over = ["data.training_resolution=32", f"tpu.raster_impl={impl}",
            "tpu.raster_tile_capacity=128"]
    jcfg = jload_config("transformer_pretraining", overrides=over)
    tcfg = load_config("transformer_pretraining", overrides=over)
    g = gaussian_dict()
    mask = np.arange(64) % 6 != 0
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    want = jvideo.render_orbit(jg, jcfg, num_frames=4,
                               gaussian_mask=jnp.asarray(mask))
    got = video.render_orbit(tg, tcfg, 4, torch.from_numpy(mask))
    assert got.shape == want.shape == (4, 32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert got.max() > 0
    # render_predicted itself, then the render | GT views as
    # jvideo.generate_test_examples composes them
    batch = _synthetic_batch(jcfg, 1, seed=4)
    frames = []
    for r in range(3):
        cams = [batch[k][0, r] for k in ("world_view_transforms",
                                         "full_proj_transforms",
                                         "camera_centers")]
        img = np.asarray(jrender.render_predicted(
            jg, *(jnp.asarray(c) for c in cams), np.zeros(3, np.float32),
            jcfg, gaussian_mask=jnp.asarray(mask))["render"])
        timg = trender.render_predicted(
            tg, *(torch.from_numpy(c) for c in cams), [0.0, 0.0, 0.0], tcfg,
            gaussian_mask=torch.from_numpy(mask))["render"].numpy()
        assert np.abs(timg - img).max() <= 2e-5
        pair = np.concatenate([np.clip(img, 0, 1),
                               np.clip(batch["gt_images"][0, r], 0, 1)], 2)
        frames.append((pair.transpose(1, 2, 0) * 255).astype(np.uint8))
    assert max(float(np.abs(f).max()) for f in frames) > 0
    got = video.test_view_frames(tg, torch.from_numpy(mask), tcfg, batch)
    assert got.shape == (3, 32, 64, 3)
    assert np.abs(got.astype(int) - np.stack(frames).astype(int)).max() <= 1


@pytest.mark.parametrize("sh_degree", [1, 0])
def test_test_renders_take_one_streaming_call(monkeypatch, sh_degree):
    """On the ``pallas`` route the views of a test example, and the frames
    of an orbit, each go through one call of the streaming splat (R = V
    renders) and equal the one-call-a-view renders bit for bit (the
    preprocess is elementwise and each render is sorted and composited on
    its own); masked gaussians included. At SH degree 0 the colour does not
    depend on the camera and is still given to every render."""
    over = ["data.training_resolution=32", "tpu.raster_impl=pallas",
            f"model.max_sh_degree={sh_degree}"]
    cfg = load_config("transformer_pretraining", overrides=over)
    g = {k: torch.from_numpy(v) for k, v in gaussian_dict().items()}
    mask = torch.from_numpy(np.arange(64) % 6 != 0)
    batch = _synthetic_batch(jload_config("transformer_pretraining",
                                          overrides=over), 1, seed=4)
    calls = []

    def counted(data, *args):
        calls.append(data.shape[0])
        return stream_fwd(data, *args)
    stream_fwd = ss.stream_fwd
    monkeypatch.setattr(ss, "stream_fwd", counted)
    for cams in ({k: batch[k][0] for k in video.CAMERA_KEYS},
                 video.orbit_camera_tensors(cfg, 6)):
        V = len(cams["camera_centers"])
        calls.clear()
        one = video.render_views(g, cams, cfg, mask)
        assert calls == [V]
        calls.clear()
        each = torch.stack([trender.render_predicted(
            g, *(torch.as_tensor(cams[k][i]) for k in video.CAMERA_KEYS),
            trainer.bg_color_of(cfg), cfg, gaussian_mask=mask)["render"]
            for i in range(V)]).numpy()
        assert calls == [1] * V
        assert one.shape == (V, 3, 32, 32) and one.max() > 0
        np.testing.assert_array_equal(one, each)
    calls.clear()
    assert video.render_orbit(g, cfg, 6, mask).shape == (6, 32, 32, 3)
    assert calls == [6]


def test_test_videos_written(tmp_path):
    cfg = load_config("transformer_pretraining",
                      overrides=SMALL + ["tpu.raster_impl=pallas"])
    model, state = trainer.create_train_state(cfg, device="cpu", seed=0)
    loader = Loader(get_dataset(cfg, "test", "cpu"), 1, shuffle=False,
                    drop_last=False)
    paths = video.generate_test_examples(model, state, cfg, loader,
                                         str(tmp_path), iteration=7,
                                         orbit_frames=4)
    assert [os.path.basename(p).rsplit(".", 1)[0] for p in paths] == [
        "test_views_7_0", "test_orbit_7_0"]
    for p in paths:
        assert p.endswith((".mp4", ".gif")) and os.path.getsize(p) > 0
