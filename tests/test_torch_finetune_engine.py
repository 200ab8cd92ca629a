"""PyTorch port vs the JAX package: the fine-tuning engine (hooks,
trainer, evaluators, checkpoint), and the slice as a whole, a narrow
SparseUNet semantic-segmentation fine-tune.

* The JAX engine's toy classification task (tests/test_finetune_engine.py)
  through both engines, from carried weights, on the same batches (both
  loaders shuffle with ``default_rng(seed + epoch)``): per-step losses
  within 1e-5 relative, equal ``val_acc``, both checkpoints and
  ``train.jsonl``.
* A resume restores the model, the optimizer's whole state, the step and
  the generator bit for bit (SGD with momentum and adamw), and the next
  step is then bit for bit the uninterrupted run's.
* ``SemSegEvaluator`` and ``InsSegEvaluator`` against JAX's on random
  predictions: exact (numpy on equal inputs).
* ``RuntimeProfiler`` writes a trace on the CPU.
* Two fine-tune steps (cross entropy with ignore -1, SGD nesterov, cosine
  with a 2-step warm-up) of a narrow two-stage SpUNet with 5 classes on a small
  labelled scene, JAX against the port from the same weights: the loss
  within 1e-5 relative; the parameters after step 2, as their moves from
  the start, within 5e-2 relative L2 over all of them (the scene step's
  rule, tests/test_torch_scene_step.py: ReLU ties flip between two float32
  implementations); BatchNorm running stats 1e-4 of each tensor's largest.
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from unipre3d_tpu.data.loader import Loader as JLoader
from unipre3d_tpu.models import sparseunet as jsp
from unipre3d_tpu.training import hooks as jhooks
from unipre3d_tpu.training import optim_factory as jopt
from unipre3d_tpu.utils import losses_seg as jloss
from unipre3d_tpu_torch.data import Loader
from unipre3d_tpu_torch.models.sparseunet import SpUNet
from unipre3d_tpu_torch.training import hooks
from unipre3d_tpu_torch.training import optim_factory as topt
from unipre3d_tpu_torch.utils import losses_seg as tloss
from unipre3d_tpu_torch.weights import jax_to_state_dict, state_dict_to_jax
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

sys.path.insert(0, os.path.dirname(__file__))
from test_finetune_engine import ToyClsDataset, make_task  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


class ClsHead(nn.Module):
    """The toy task's head under flax's names: Dense(32), ReLU, max over
    the points, Dense(2)."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(3, 32)
        self.Dense_1 = nn.Linear(32, 2)

    def forward(self, pts):
        return self.Dense_1(torch.relu(self.Dense_0(pts)).amax(1))


def cls_train_step(state, batch):
    params = state.params
    loss = tloss.cross_entropy(state.model(batch["points"]), batch["label"])
    grads = torch.autograd.grad(loss, list(params.values()))
    updates, state.opt_state = state.tx.update(
        dict(zip(params, grads)), state.opt_state, params)
    topt.apply_updates(params, updates)
    state.step += 1
    return state, {"loss": float(loss.detach())}


def cls_predict(state, batch):
    with torch.no_grad():
        return state.model(batch["points"])


class Losses(jhooks.HookBase, hooks.HookBase):
    def __init__(self):
        self.losses = []

    def after_step(self, metrics):
        self.losses.append(float(metrics["loss"]))


def port_cls_state(params, tx):
    model = ClsHead()
    model.load_state_dict(jax_to_state_dict(np_tree(params)))
    return hooks.FinetuneState.create(model, tx,
                                      torch.Generator().manual_seed(0))


def test_toy_task_matches_jax_engine(tmp_path):
    jstate, jstep, jpredict = make_task(jax.random.PRNGKey(0))
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jl, tl = Losses(), Losses()
    jt = jhooks.FinetuneTrainer(
        jstate, jstep, JLoader(ToyClsDataset(32), 8, shuffle=True), out_j,
        max_epoch=3, predict_fn=jpredict,
        val_loader=JLoader(ToyClsDataset(16, seed=1), 8, shuffle=False),
        hooks=[jhooks.CheckpointLoader(), jhooks.IterationTimer(),
               jhooks.InformationWriter(log_every=4),
               jhooks.ClsEvaluator(2), jhooks.CheckpointSaver("val_acc"), jl])
    tstate = port_cls_state(jstate.params, topt.build_optimizer("adam", 1e-2))
    tt = hooks.FinetuneTrainer(
        tstate, cls_train_step, Loader(ToyClsDataset(32), 8, shuffle=True),
        out_t, max_epoch=3, predict_fn=cls_predict,
        val_loader=Loader(ToyClsDataset(16, seed=1), 8, shuffle=False),
        hooks=[hooks.CheckpointLoader(), hooks.IterationTimer(),
               hooks.InformationWriter(log_every=4),
               hooks.ClsEvaluator(2), hooks.CheckpointSaver("val_acc"), tl])
    jt.train()
    tt.train()
    assert len(tl.losses) == len(jl.losses) == 12
    np.testing.assert_allclose(tl.losses, jl.losses, rtol=1e-5)
    assert tt.eval_metrics["val_acc"] == jt.eval_metrics["val_acc"] > 0.9
    assert tt.state.step == 12
    for name in ("model_latest.ckpt", "model_best.ckpt", "train.jsonl"):
        assert os.path.exists(os.path.join(out_t, name)), name
    rows = [[json.loads(x) for x in open(os.path.join(d, "train.jsonl"))]
            for d in (out_j, out_t)]
    assert [sorted(r) for r in rows[0]] == [sorted(r) for r in rows[1]]
    np.testing.assert_allclose([r["loss"] for r in rows[1]],
                               [r["loss"] for r in rows[0]], rtol=1e-5)


def snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() if torch.is_tensor(v) else v
             for k, v in state.opt_state.items()},
            state.step, state.generator.get_state().clone())


def assert_same_state(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert list(x) == list(y)
        for k in x:
            if torch.is_tensor(x[k]):
                assert torch.equal(x[k], y[k]), k
            else:
                assert x[k] == y[k], k
    assert a[2] == b[2] and torch.equal(a[3], b[3])


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_resume_restores_the_optimizer_state_bit_for_bit(tmp_path, name):
    jstate, _, _ = make_task(jax.random.PRNGKey(0))
    sched = topt.make_schedule("cosine", 1e-2, total_steps=12,
                               warmup_steps=2)
    tx = lambda s: topt.build_optimizer(name, sched, params=s.params)
    state = port_cls_state(jstate.params, topt.build_optimizer("sgd", 0.1))
    state.tx = tx(state)
    state.opt_state = state.tx.init(state.params)
    state.generator.manual_seed(3)
    torch.rand(5, generator=state.generator)    # a generator moved on
    out = str(tmp_path)
    t = hooks.FinetuneTrainer(state, cls_train_step,
                              Loader(ToyClsDataset(32), 8), out, 1,
                              hooks=[hooks.CheckpointSaver()])
    t.train()
    saved = snapshot(t.state)
    assert saved[2] == 4 and any(k.endswith("count") for k in saved[1])
    fresh = port_cls_state(make_task(jax.random.PRNGKey(1))[0].params,
                           topt.build_optimizer("sgd", 0.1))
    fresh.tx = tx(fresh)
    fresh.opt_state = fresh.tx.init(fresh.params)
    r = hooks.FinetuneTrainer(fresh, cls_train_step,
                              Loader(ToyClsDataset(32), 8), out, 0,
                              hooks=[hooks.CheckpointLoader()])
    r.train()
    assert_same_state(snapshot(r.state), saved)
    batch = {k: torch.as_tensor(v) for k, v in
             next(Loader(ToyClsDataset(32), 8, seed=9).epoch(0)).items()}
    batch["points"] = batch["points"].float()
    cls_train_step(t.state, batch)
    cls_train_step(r.state, batch)
    assert_same_state(snapshot(r.state), snapshot(t.state))


def fake(out_dir, batches, predict):
    """What an evaluator reads of its trainer: a val loader over
    ``batches`` and ``predict``."""
    loader = types.SimpleNamespace(epoch=lambda e: iter(batches))
    return types.SimpleNamespace(out_dir=out_dir, epoch=0, eval_metrics={},
                                 val_loader=loader, predict=predict)


def test_semseg_evaluator_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    batches = [{"segment": rng.integers(-1, 6, (2, 300))} for _ in range(3)]
    logits = [rng.normal(size=(2, 300, 6)).astype(np.float32)
              for _ in range(3)]
    it_j, it_t = iter(logits), iter(logits)
    jt = fake(str(tmp_path), batches, lambda b: jnp.asarray(next(it_j)))
    tt = fake(str(tmp_path), batches, lambda b: torch.from_numpy(next(it_t)))
    je, te = jhooks.SemSegEvaluator(6), hooks.SemSegEvaluator(6)
    je.trainer, te.trainer = jt, tt
    je.after_epoch()
    te.after_epoch()
    assert tt.eval_metrics == jt.eval_metrics
    assert 0 < tt.eval_metrics["val_miou"] < 1


def ins_scene(rng, n=1200):
    segment = rng.integers(0, 4, n)
    instance = rng.integers(0, 8, n)
    segment[rng.random(n) < 0.05] = -1
    K = 10
    masks = np.zeros((K, n), np.int32)
    for k in range(K):
        iid = rng.integers(0, 8)
        hit = instance == iid
        masks[k] = hit & (rng.random(n) < rng.uniform(0.3, 1.0))
        masks[k] |= rng.random(n) < 0.05
    return ({"segment": segment, "instance": instance},
            {"pred_classes": rng.integers(0, 4, K),
             "pred_scores": rng.random(K), "pred_masks": masks})


def test_insseg_evaluator_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    scenes = [ins_scene(rng) for _ in range(3)]
    batches = [s[0] for s in scenes]
    preds = [s[1] for s in scenes]
    it_j, it_t = iter(preds), iter(preds)
    jt = fake(str(tmp_path), batches, lambda b: next(it_j))
    tt = fake(str(tmp_path), batches, lambda b: {
        k: torch.from_numpy(np.asarray(v)) for k, v in next(it_t).items()})
    kw = dict(num_classes=4, segment_ignore_index=(-1,), min_region_size=20)
    je, te = jhooks.InsSegEvaluator(**kw), hooks.InsSegEvaluator(**kw)
    je.trainer, te.trainer = jt, tt
    je.after_epoch()
    te.after_epoch()
    assert tt.eval_metrics == jt.eval_metrics
    assert tt.eval_metrics["val_ap25"] > 0


def test_runtime_profiler_writes_a_trace_on_the_cpu(tmp_path):
    jstate, _, _ = make_task(jax.random.PRNGKey(0))
    state = port_cls_state(jstate.params, topt.build_optimizer("adam", 1e-2))
    prof = hooks.RuntimeProfiler(start_step=1, num_steps=2)
    hooks.FinetuneTrainer(state, cls_train_step,
                          Loader(ToyClsDataset(32), 8), str(tmp_path), 1,
                          hooks=[prof]).train()
    path = tmp_path / "profile" / "trace.json"
    events = json.load(open(path))["traceEvents"]
    assert path == type(path)(prof.trace_path) and len(events) > 10
    assert prof.profile is not None and not prof._active


# -- the slice as a whole: a narrow SparseUNet fine-tune ------------------

NARROW = dict(num_classes=5, channels=(16, 24, 24, 16),
              layers=(1, 1, 1, 1))


def labelled_scene(M=700, seed=0):
    """A floor, a wall and two boxes, labelled 0-3, 3% at -1, with
    colours and normals, in a 1.5 m room at 2 cm voxels."""
    rng = np.random.default_rng(seed)
    n = M // 4
    floor = np.c_[rng.uniform(0, 1.5, (n, 2)), np.zeros(n)]
    wall = np.c_[rng.uniform(0, 1.5, n), np.zeros(n), rng.uniform(0, 1, n)]
    box1 = rng.uniform([0.2, 0.2, 0], [0.5, 0.6, 0.4], (n, 3))
    box2 = rng.uniform([0.9, 0.7, 0], [1.3, 1.2, 0.7], (M - 3 * n, 3))
    coord = np.concatenate([floor, wall, box1, box2]).astype(np.float32)
    seg = np.repeat(np.arange(4), [n, n, n, M - 3 * n])
    seg[rng.random(M) < 0.03] = -1
    color = (np.array([40, 90, 160, 220])[np.maximum(seg, 0)][:, None]
             + rng.normal(0, 10, (M, 3)))
    normal = np.zeros((M, 3))
    normal[:n, 2] = 1
    normal[n:2 * n, 1] = 1
    normal[2 * n:] = rng.normal(size=(M - 2 * n, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    feat = np.c_[color / 127.5 - 1, normal].astype(np.float32)
    grid = np.floor(coord / 0.02).astype(np.int32)
    mask = np.ones(M, bool)
    mask[-20:] = False               # padding rows
    return {"coord": coord[None], "grid_coord": grid[None], "feat": feat[None],
            "mask": mask[None], "min_coord": np.zeros((1, 3), np.float32)}, \
        np.where(mask, seg, -1)[None]


def jax_steps(data, labels_sorted, params, stats):
    model = jsp.SpUNet(**NARROW)
    tx = jopt.build_optimizer("sgd", jopt.make_schedule(
        "cosine", 0.05, warmup_steps=2, total_steps=6), momentum=0.9,
        nesterov=True)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}

    @jax.jit
    def step(params, stats, opt_state):
        def loss_fn(p):
            (f, _, _), new = model.apply(
                {"params": p, "batch_stats": stats}, jdata, train=True,
                method=model.forward_point_fusion, mutable=["batch_stats"])
            return jloss.cross_entropy(f.reshape(-1, 5),
                                       labels_sorted.reshape(-1)), new
        (loss, new), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        u, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, u), new["batch_stats"], \
            opt_state, loss

    opt_state = tx.init(params)
    losses = []
    for _ in range(2):
        params, stats, opt_state, loss = step(params, stats, opt_state)
        losses.append(float(loss))
    return losses, params, stats


def port_seg_step(state, batch):
    """One fine-tune step: logits in the geometry's voxel order, labels
    gathered alike (padding rows ignored), CE, the factory optimizer."""
    model, params = state.model, state.params
    geo = model.build_geometry(batch, None, False)
    logits, _, _ = model.forward_point_fusion(batch, geometry=geo)
    labels = torch.gather(batch["segment"], 1, geo.order0)
    labels = torch.where(geo.mask0, labels, torch.full_like(labels, -1))
    loss = tloss.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
    grads = torch.autograd.grad(loss, list(params.values()))
    updates, state.opt_state = state.tx.update(
        dict(zip(params, grads)), state.opt_state, params)
    topt.apply_updates(params, updates)
    state.step += 1
    return state, {"loss": float(loss.detach()), "labels": labels}


def test_narrow_spunet_finetune_steps_match_jax():
    data, seg = labelled_scene()
    torch.manual_seed(0)
    model = SpUNet(**NARROW)
    # the port's init carried to JAX (the exact inverse map), with BN
    # scales and biases moved off their init
    with torch.no_grad():
        for n, p in model.named_parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape))
    # copies: the arrays would share memory with the tensors the port's
    # steps update in place
    p0, s0 = jax.tree_util.tree_map(
        np.copy, state_dict_to_jax(model.state_dict()))
    model.train()
    tx = topt.build_optimizer("sgd", topt.make_schedule(
        "cosine", 0.05, warmup_steps=2, total_steps=6), momentum=0.9,
        nesterov=True)
    state = hooks.FinetuneState.create(model, tx)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    batch["segment"] = torch.from_numpy(seg)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    losses = []
    for _ in range(2):
        state, m = port_seg_step(state, batch)
        losses.append(m["loss"])
    labels_sorted = m["labels"].numpy()
    assert (labels_sorted >= 0).sum() > 600
    jlosses, jp, js = jax_steps(data, jnp.asarray(labels_sorted), p0, s0)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    ref = jax_to_state_dict(np_tree(jp), np_tree(js))
    got = model.state_dict()
    names = [n for n in state.params]
    diff = sum(float(((got[n] - ref[n]) ** 2).sum()) for n in names)
    move = sum(float(((ref[n] - start[n]) ** 2).sum()) for n in names)
    assert move > 0 and (diff / move) ** 0.5 < 5e-2
    stats = [k for k in ref if "running_" in k]
    assert len(stats) > 20
    for k in stats:
        assert float((got[k] - ref[k]).abs().max()
                     / ref[k].abs().max()) < 1e-4, k


def test_misc_helpers_match_jax():
    """``safe_state`` seeds ``random`` and ``numpy`` as JAX's does (and
    returns a seeded generator where JAX returns a key); the worker
    streams are equal; the stdout shim stamps each line once; ``to_device``
    moves a nested numpy batch."""
    import io
    import random

    from unipre3d_tpu.utils import misc as jmisc
    from unipre3d_tpu_torch.utils import misc as tmisc
    jmisc.safe_state(5, timestamp_stdout=False)
    ref = (random.random(), np.random.rand(3))
    g = tmisc.safe_state(5, timestamp_stdout=False)
    got = (random.random(), np.random.rand(3))
    assert ref[0] == got[0] and np.array_equal(ref[1], got[1])
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=torch.Generator()
                                  .manual_seed(5)))
    assert np.array_equal(jmisc.seeded_worker(2, 7).random(4),
                          tmisc.seeded_worker(2, 7).random(4))
    out = io.StringIO()
    shim = tmisc._TimestampedStdout(out)
    shim.write("a\nb")
    shim.write("c\n\n")
    lines = out.getvalue().split("\n")
    assert lines[0].endswith("] a") and lines[1].endswith("] bc")
    assert lines[0].startswith("[") and lines[2] == ""
    b = tmisc.to_device({"x": np.ones((2, 3)), "pc": {"m": np.arange(3)}},
                        "cpu")
    assert b["x"].dtype == torch.float32 and b["pc"]["m"].dtype == torch.int64
    np.testing.assert_array_equal(
        tmisc.to_numpy({"t": torch.ones(2, requires_grad=True)})["t"],
        np.ones(2, np.float32))
