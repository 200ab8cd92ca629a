"""PyTorch port vs the JAX package: LPIPS, the LPIPS term of the train step
and the LPIPS columns of eval.

No published LPIPS weights are in the repository: both packages take the
same random weights in torchvision's and lpips' layout (convolutions
normal with He's variance, so activations keep their scale through the 13
layers; the per-channel weights normal, a third of them negative, which the
metric clamps to 0), written to a temporary ``.pth`` or ``.npz``.

Held, float32 on the CPU:

* the converter and loader: the same parameter tree as JAX's, bit for bit,
  from a ``.pth`` under both key spellings and from an ``.npz``;
* the distance on 32x32 image pairs and its gradient to the first image:
  ``TOL_LPIPS = 1e-5`` relative (13 float32 convolutions summed in another
  order, then a normalized difference; measured 1.3e-7) and
  ``TOL_LPIPS_GRAD = 1e-4`` of the largest entry (measured 6.6e-6) on
  noise images. At a step's renders (large flat backgrounds) the gradient
  is ill-conditioned: feature vectors near zero are divided by
  ``sqrt(sum a^2 + 1e-10)``, which multiplies rounding by up to 1e5, and
  JAX's float32 gradient is 7.9% of its largest entry from a float64 one
  (1.3% in L2). There the port's float32 gradient must be no farther from
  float64 than ``FLOAT64_MULTIPLE = 2`` times JAX's (measured 5.6% against
  7.9%);
* the small object step of tests/test_torch_train_step.py with the term
  (``opt.lambda_lpips=0.5``, so that it weighs in the gradients, and
  ``opt.start_lpips_after=0``) on both sides of the gate: at step 0 the
  gate is shut (``lpips`` exactly 0, the loss without the term) and held
  as in that file (loss, PSNR, gradient norm 1e-5 relative, gradients 1e-4
  of each tensor's largest, analytically zero ones noise); at step 1 it is
  open: loss 1e-5 relative, ``lpips`` ``TOL_LPIPS``, but the gradient norm
  1e-3 relative (measured 1.6e-4) and the gradients ``TOL_LPIPS_STEP_GRAD
  = 2e-3`` of each tensor's largest (measured 5.7e-4), the renders' LPIPS
  gradient above reaching them. The gate reads the step before its
  increment, strictly: ``-1`` opens it at step 0, as ``0`` does at step 1;
* eval's per-view LPIPS (``Metricator``) and ``evaluate_dataset``'s
  columns and ``scores.txt`` against JAX's on the same renders, and the
  CLIs: a two-step run with the term and ``eval.main`` with LPIPS, and the
  raise for a set LPIPS path that does not exist (JAX skips it).
"""

import json
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch, _tiny_cfg
from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu.training.config import apply_overrides
from unipre3d_tpu.utils import lpips as jlpips
from unipre3d_tpu_torch import eval as teval
from unipre3d_tpu_torch import train_network
from unipre3d_tpu_torch.data import batch_to
from unipre3d_tpu_torch.training import trainer
from unipre3d_tpu_torch.training.config import load_config, save_config
from unipre3d_tpu_torch.utils import lpips as tlpips
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_scene_step import adam_state, shared_across_workers
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL_LPIPS = 1e-5
TOL_LPIPS_GRAD = 1e-4
TOL_LPIPS_STEP_GRAD = 2e-3
FLOAT64_MULTIPLE = 2.0
SMALL = ["data.training_resolution=32", "opt.batch_size=2",
         "data.dataset_root=synthetic", "opt.ema.update_after_step=1",
         "opt.ema.update_every=1",
         "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
         "layers_per_block: 1}",
         "model.backbone_overrides={depth: 2, drop_path_rate: 0.0}"]
LPIPS_TERM = ["opt.lambda_lpips=0.5", "opt.start_lpips_after=0"]


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def torchvision_weights(seed=0):
    """Random ``vgg16().features`` weights (``features.N.*``) and lpips
    heads (``linN.model.1.weight`` [1, C, 1, 1]), numpy."""
    rng = np.random.default_rng(seed)
    vgg, cin = {}, 3
    for idxs, chans in zip(tlpips.VGG_SLICES, tlpips.VGG_CHANNELS):
        for idx, ch in zip(idxs, chans):
            vgg[f"features.{idx}.weight"] = rng.normal(
                0, math.sqrt(2.0 / (9 * cin)), (ch, cin, 3, 3)).astype(
                    np.float32)
            vgg[f"features.{idx}.bias"] = rng.normal(0, 0.05, ch).astype(
                np.float32)
            cin = ch
    lin = {f"lin{i}.model.1.weight": (rng.normal(0, 1, (1, c[-1], 1, 1))
                                      + 0.5).astype(np.float32)
           for i, c in enumerate(tlpips.VGG_CHANNELS)}
    return vgg, lin


def write_pth(path, spelling="features"):
    vgg, lin = torchvision_weights()
    if spelling == "bare":
        vgg = {k[len("features."):]: v for k, v in vgg.items()}
        lin = {k.replace("lin", "lins.", 1): v for k, v in lin.items()}
    torch.save({k: torch.from_numpy(v) for k, v in {**vgg, **lin}.items()},
               path)
    return path


def write_npz(path):
    params = jlpips.convert_lpips_torch_state_dict(*torchvision_weights())
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for conv, leaves in v.items():
                for leaf, a in leaves.items():
                    flat[f"{k}/{conv}/{leaf}"] = a
        else:
            flat[k] = v
    np.savez(path, **flat)
    return path


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The random weights as an ``.npz`` of the converted tree and their
    tree."""
    path = write_npz(str(tmp_path_factory.mktemp("lpips") / "lpips.npz"))
    return path, jlpips.load_lpips_params(path)


def tree_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("kind", ["features", "bare", "npz"])
def test_converter_and_loader_match_jax(tmp_path, kind):
    if kind == "npz":
        path = write_npz(str(tmp_path / "w.npz"))
    else:
        path = write_pth(str(tmp_path / "w.pth"), kind)
    want = dict(tree_items(jlpips.load_lpips_params(path)))
    got = dict(tree_items(tlpips.load_lpips_params(path)))
    assert set(got) == set(want) and len(got) == 2 * 13 + 5
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = tlpips.build_lpips(tlpips.load_lpips_params(path))
    assert model.vgg.conv28.weight.shape == (512, 512, 3, 3)
    assert not any(p.requires_grad for p in model.parameters())
    os.remove(path)             # 59 MB: the suite's temporary files stay small


def image_pairs(n, res=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3, res, res)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, x.shape), -1, 1).astype(np.float32)
    return x, y


def distances_and_grads(params, x, y, cot, dtype=torch.float32):
    """JAX's and the port's distances of image pairs [4, 3, 32, 32] and
    the gradient of ``sum(cot * d)`` to ``x``; the port's in ``dtype``."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)

    def f(a, b, c):
        d = jlpips.lpips_fn(jp, a, b)
        return jnp.sum(d * c), d
    (_, jd), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(cot))
    model = tlpips.build_lpips(params).to(dtype)
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    td = model(tx, torch.from_numpy(y).to(dtype))
    (td * torch.from_numpy(cot).to(dtype)).sum().backward()
    return (np.asarray(jd), np.asarray(jg), td.detach().numpy(),
            tx.grad.numpy())


def rel_max(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_forward_and_input_gradient_match_jax(weights):
    _, params = weights
    x, y = image_pairs(4)
    cot = np.random.default_rng(1).uniform(0.5, 1.5, 4).astype(np.float32)
    want, jgrad, got, tgrad = distances_and_grads(params, x, y, cot)
    assert got.shape == (4,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=TOL_LPIPS)
    assert rel_max(tgrad, jgrad) < TOL_LPIPS_GRAD
    # identical images are at distance 0
    model = tlpips.build_lpips(params)
    assert float(tlpips.lpips_fn(model, torch.from_numpy(y),
                                 torch.from_numpy(y)).abs().max()) < 1e-6


def test_input_gradient_at_renders_as_near_float64_as_jax(weights):
    """At the small step's renders (see the module's docstring) against
    their ground truth: distances within ``TOL_LPIPS``; the port's float32
    gradient no farther from the float64 one than FLOAT64_MULTIPLE times
    JAX's float32 gradient, which is itself more than 1e-3 from it."""
    _, params = weights
    cfg = load_config("transformer_pretraining", overrides=SMALL)
    model, _ = trainer.create_train_state(cfg, device="cpu")
    batch = batch_to(_synthetic_batch(_tiny_cfg(tiny_vae=True), 2), "cpu")
    with torch.no_grad():
        r = trainer.render_supervision_views(
            trainer.predict(model, batch, 1), batch, cfg,
            trainer.bg_color_of(cfg))
    x = (r.flatten(0, 1) * 2 - 1).numpy()
    y = (batch["gt_images"][:, 1:].flatten(0, 1) * 2 - 1).numpy()
    cot = np.full(4, 0.25, np.float32)
    want, jgrad, got, tgrad = distances_and_grads(params, x, y, cot)
    np.testing.assert_allclose(got, want, rtol=TOL_LPIPS)
    *_, g64 = distances_and_grads(params, x, y, cot, torch.float64)
    port, ref = rel_max(tgrad, g64), rel_max(jgrad, g64)
    assert ref > 1e-3 and port <= FLOAT64_MULTIPLE * ref, (port, ref)


def jax_lpips_steps(params):
    """One JAX step with LPIPS from step 0 (the gate shut) and from step 1
    (open) of the same state: the converted init, each step's metrics and
    Adam's first moment."""
    jcfg = _tiny_cfg(tiny_vae=True)
    apply_overrides(jcfg, SMALL[-3:] + LPIPS_TERM)
    batch = _synthetic_batch(jcfg, 2)
    jmodel, tx, jstate = jtrainer.create_train_state(
        jcfg, jax.random.PRNGKey(0), batch)
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jmodel, tx))
    lp = jax.tree_util.tree_map(jnp.asarray, params)
    out = {"init": jax_to_state_dict(np_tree(jstate.params),
                                     np_tree(jstate.batch_stats))}
    for k in (0, 1):
        s, m = jstep(jstate._replace(step=jstate.step + k), batch, lp)
        out[f"m{k}"] = {n: torch.tensor(float(v)) for n, v in m.items()}
        out[f"mu{k}"] = jax_to_state_dict(np_tree(adam_state(s.opt_state).mu))
    return out


@pytest.fixture(scope="module")
def steps(weights, tmp_path_factory):
    """The JAX steps (once a run) and the port's: from step 0 and step 1
    with ``start_lpips_after=0``, and from step 0 with ``-1``."""
    _, params = weights
    j = shared_across_workers(tmp_path_factory, "jax_lpips_steps",
                              lambda: jax_lpips_steps(params))
    batch = _synthetic_batch(_tiny_cfg(tiny_vae=True), 2)
    lpips = tlpips.build_lpips(params)
    port = {}
    for tag, start, k in (("0", 0, 0), ("1", 0, 1), ("-1", -1, 0)):
        cfg = load_config("transformer_pretraining", overrides=SMALL + [
            "opt.lambda_lpips=0.5", f"opt.start_lpips_after={start}"])
        model, state = trainer.create_train_state(cfg, device="cpu",
                                                  state_dict=j["init"])
        state.step = k
        m = trainer.make_train_step(cfg, model, lpips)(
            state, batch_to(batch, "cpu"))
        names = [n for n, _ in trainer.split_frozen(model)[0]]
        port[tag] = (m, dict(zip(names, state.optimizer.mu)))
    return j, port


@pytest.mark.parametrize("k", [0, 1])
def test_lpips_step_matches_jax_on_both_sides_of_the_gate(steps, k):
    j, port = steps
    jm = {n: float(v) for n, v in j[f"m{k}"].items()}
    tm, tmu = port[str(k)]
    assert tm["nan_skipped"] == 0.0
    for n in ("loss", "psnr"):
        assert tm[n] == pytest.approx(jm[n], rel=1e-5), n
    assert tm["grad_norm"] == pytest.approx(jm["grad_norm"],
                                            rel=1e-5 if k == 0 else 1e-3)
    if k == 0:
        assert tm["lpips"] == jm["lpips"] == 0.0
    else:
        assert jm["lpips"] > 0.05
        assert tm["lpips"] == pytest.approx(jm["lpips"], rel=TOL_LPIPS)
        # the term is in the loss, at its weight
        m0 = port["0"][0]
        assert tm["loss"] - m0["loss"] == pytest.approx(
            0.5 * tm["lpips"], rel=1e-4)
    jmu = j[f"mu{k}"]
    tol = 1e-4 if k == 0 else TOL_LPIPS_STEP_GRAD
    gmax = max(float(v.abs().max()) for v in jmu.values())
    for n, t in tmu.items():
        ref = jmu[n]
        if float(ref.abs().max()) < 1e-3 * gmax:     # analytically zero
            assert float(t.abs().max()) < 1e-3 * gmax, n
        else:
            assert float((t - ref).abs().max() / ref.abs().max()) < tol, n


def test_gate_reads_the_step_before_its_increment(steps):
    """``start_lpips_after=-1`` at step 0 takes the same step as ``0`` at
    step 1, and its gradients differ from the shut gate's."""
    _, port = steps
    (a, amu), (b, bmu), (_, shut) = port["-1"], port["1"], port["0"]
    for n in ("loss", "lpips", "psnr", "grad_norm"):
        assert a[n] == b[n], n
    moved = 0
    for n in amu:
        torch.testing.assert_close(amu[n], bmu[n], rtol=0, atol=0)
        moved += not torch.equal(amu[n], shut[n])
    assert moved > len(amu) // 2


def test_no_weights_no_lpips_key():
    cfg = load_config("transformer_pretraining", overrides=SMALL)
    model, state = trainer.create_train_state(cfg, device="cpu")
    batch = batch_to(_synthetic_batch(_tiny_cfg(tiny_vae=True), 2), "cpu")
    assert "lpips" not in trainer.make_train_step(cfg, model)(state, batch)


class ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def epoch(self, _):
        yield from self.batches


def renders(n=3, views=3, seed=0):
    """Numpy batches of one example and each one's fixed render."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        gt = rng.uniform(0, 1, (1, views, 3, 32, 32)).astype(np.float32)
        if i == 1:
            gt[0, 2] = 0.0                    # an all-black novel view
        r = np.clip(gt + rng.normal(0, 0.2, gt.shape), 0, 1).astype(
            np.float32)
        out.append(({"gt_images": gt}, r))
    return out


def test_eval_lpips_columns_match_jax(weights, tmp_path):
    """``evaluate_dataset`` on the same renders (a stand-in eval step hands
    each package the fixed render of its example): every score, LPIPS
    included, and each line of ``scores.txt`` equal JAX's; the per-view
    metrics too, in chunks of 2 views on the port's side."""
    from eval import Metricator as JMetricator
    from eval import evaluate_dataset as jevaluate
    _, params = weights
    cases = renders()
    cfg = load_config("transformer_pretraining", overrides=SMALL)

    def jstep(state, jb):
        # JAX's evaluate_dataset maps the batch to device arrays first
        return {"rendered": jnp.asarray(next(
            r for b, r in cases if np.array_equal(b["gt_images"],
                                                  np.asarray(jb["gt_images"]))
        ))}

    def tstep(state, tb):
        return {"rendered": torch.from_numpy(next(
            r for b, r in cases
            if np.array_equal(b["gt_images"], tb["gt_images"].numpy())))}
    loader = ListLoader([b for b, _ in cases])
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jlp = jax.tree_util.tree_map(jnp.asarray, params)
    want = jevaluate(None, jstep, None, loader, cfg, str(jdir),
                     lpips_params=jlp)
    lpips = tlpips.build_lpips(params)
    got = teval.evaluate_dataset(torch.nn.Linear(1, 1), tstep, None, loader,
                                 cfg, str(tdir), lpips=lpips)
    assert set(got) == set(want) == set(teval.SCORE_KEYS)
    for k, v in want.items():
        assert v is not None and got[k] == pytest.approx(
            v, rel=TOL_LPIPS if "LPIPS" in k else 1e-5,
            abs=1e-6 if "SSIM" in k else 0), k
    for a, b in zip((jdir / "scores.txt").read_text().splitlines(),
                    (tdir / "scores.txt").read_text().splitlines()):
        (ja, *jn), (ta, *tn) = a.split(), b.split()
        assert ja == ta
        for x, y, tol in zip(jn, tn, (1e-5, 1e-5, TOL_LPIPS)):
            assert float(y) == pytest.approx(float(x), rel=tol, abs=1e-6)
    # per view, with chunks that split the example
    r, g = cases[1][1][0], cases[1][0]["gt_images"][0]
    jm = JMetricator(jlp).compute_metrics_batched(jnp.asarray(r),
                                                  jnp.asarray(g))
    metricator = teval.Metricator(lpips)
    metricator.CHUNK = 2
    tm = metricator.compute_metrics_batched(torch.from_numpy(r),
                                            torch.from_numpy(g))
    assert set(tm) == set(jm) == {"psnr", "ssim", "black", "lpips"}
    np.testing.assert_array_equal(tm["black"], jm["black"])
    np.testing.assert_allclose(tm["lpips"], jm["lpips"], rtol=TOL_LPIPS)


def test_cli_trains_with_lpips_and_eval_scores_it(weights, tmp_path):
    """Two CPU steps with the term from step 1 (``start_lpips_after=0``):
    ``lpips`` is 0 at the first step and above 0 at the second, and is
    logged; ``eval.main`` reports both LPIPS columns."""
    path, _ = weights
    run = str(tmp_path / "run")
    res = train_network.main([
        "--config-name", "transformer_pretraining", "--device", "cpu",
        "--output-dir", run, "opt.iterations=2", "logging.loss_log=1",
        f"opt.lpips_weights={path}", "opt.start_lpips_after=0"] + SMALL)
    assert res["lpips"][0] == 0.0 and res["lpips"][1] > 0.0
    assert not any(res["nan_skipped"])
    logged = [json.loads(line) for line in
              open(os.path.join(run, "metrics.jsonl"))]
    assert [x["train/lpips"] for x in logged if "train/lpips" in x] == \
        res["lpips"]
    scores = teval.main([run, "--device", "cpu"])
    for k in ("LPIPS_cond", "LPIPS_novel"):
        assert math.isfinite(scores[k]) and scores[k] > 0, k
    last = open(os.path.join(run, "scores.txt")).read().splitlines()[-1]
    assert math.isfinite(float(last.split()[3]))
    shutil.rmtree(run)          # the suite's temporary files stay small


def test_missing_lpips_weights_raise(tmp_path):
    """A set ``opt.lpips_weights`` that does not exist raises in the train
    and eval CLIs."""
    missing = f"opt.lpips_weights={tmp_path / 'none.npz'}"
    with pytest.raises(FileNotFoundError, match="opt.lpips_weights"):
        train_network.main(["--config-name", "transformer_pretraining",
                            "--device", "cpu", "--output-dir",
                            str(tmp_path / "a"), missing])
    run = tmp_path / "b"
    save_config(load_config("transformer_pretraining", overrides=[missing]),
                str(run / ".hydra" / "config.yaml"))
    with pytest.raises(FileNotFoundError, match="opt.lpips_weights"):
        teval.main([str(run), "--device", "cpu"])
