"""Hook-driven training engine for downstream fine-tuning.

Port of unipre3d_tpu/training/hooks.py: an epoch-based trainer whose
behaviour is assembled from hooks: ``IterationTimer``,
``InformationWriter`` (``train.jsonl`` and the ``[finetune]`` lines),
``CheckpointSaver`` and ``CheckpointLoader`` (``model_latest.ckpt``,
``model_best.ckpt``), the evaluators (classification accuracy,
semantic-segmentation mIoU, ScanNet-protocol instance AP) and
``RuntimeProfiler`` (``torch.profiler`` where JAX takes
``jax.profiler``).

The caller builds the task, as the JAX engine's callers do: a
:class:`FinetuneState` (model, factory optimizer and its state, step,
generator), ``train_step(state, batch) -> (state, metrics)`` and
``predict_fn(state, batch)``. The trainer moves each batch to the state's
device before it calls them (where JAX calls ``jnp.asarray``); the
evaluators bring the predictions back to the host with
``utils.misc.to_numpy``, which also takes a CUDA tensor.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from unipre3d_tpu_torch.data.loader import batch_to
from unipre3d_tpu_torch.training import checkpoint as ckpt_lib
from unipre3d_tpu_torch.utils.misc import to_numpy


@dataclass
class FinetuneState:
    """What a fine-tune step updates and a checkpoint holds: the model
    (parameters and buffers), the factory optimizer ``tx``
    (training/optim_factory.py) and its ``opt_state``, the ``step`` and an
    optional generator (the model's random draws)."""
    model: nn.Module
    tx: object
    opt_state: Dict
    step: int = 0
    generator: Optional[torch.Generator] = None

    @classmethod
    def create(cls, model: nn.Module, tx, generator=None) -> "FinetuneState":
        return cls(model, tx, tx.init(trainable_params(model)), 0, generator)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return trainable_params(self.model)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def trainable_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters that take gradients, by name."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


class HookBase:
    trainer: "FinetuneTrainer" = None

    def before_train(self): ...
    def before_epoch(self): ...
    def before_step(self): ...
    def after_step(self, metrics: Dict): ...
    def after_epoch(self): ...
    def after_train(self): ...


class IterationTimer(HookBase):
    """Each step's time on the host clock, and their mean after
    ``warmup_iter`` steps, as JAX's. The clock stops when ``train_step``
    returns: a step whose metrics are Python floats (``float(loss)``) has
    waited for the device, one that returns device tensors has not, and
    then this is the time to enqueue it."""

    def __init__(self, warmup_iter: int = 2):
        self.warmup_iter = warmup_iter
        self._times: List[float] = []

    def before_step(self):
        self._t0 = time.perf_counter()

    def after_step(self, metrics):
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        if len(self._times) > self.warmup_iter:
            metrics["iter_time"] = dt
            metrics["iter_time_avg"] = float(
                np.mean(self._times[self.warmup_iter:]))


class InformationWriter(HookBase):
    """Metrics to ``train.jsonl`` and a ``[finetune]`` line every
    ``log_every`` steps."""

    def __init__(self, log_every: int = 10):
        self.log_every = log_every

    def before_train(self):
        os.makedirs(self.trainer.out_dir, exist_ok=True)
        self._f = open(os.path.join(self.trainer.out_dir, "train.jsonl"),
                       "a")

    def after_step(self, metrics):
        it = self.trainer.global_step
        if it % self.log_every == 0:
            flat = {k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()}
            flat.update(step=it, epoch=self.trainer.epoch)
            self._f.write(json.dumps(flat) + "\n")
            self._f.flush()
            msg = " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                           else f"{k}={v}" for k, v in flat.items())
            print(f"[finetune] {msg}", flush=True)

    def after_train(self):
        self._f.close()


class CheckpointSaver(HookBase):
    """``model_latest.ckpt`` every epoch, ``model_best.ckpt`` when
    ``metric`` improves (training/checkpoint.py's fine-tune layout)."""

    def __init__(self, metric: str = "val_acc", mode: str = "max"):
        self.metric = metric
        self.mode = mode
        self.best: Optional[float] = None

    def after_epoch(self):
        t = self.trainer
        ckpt_lib.save_finetune_checkpoint(
            os.path.join(t.out_dir, "model_latest.ckpt"), t.state,
            self.best or 0.0)
        cur = t.eval_metrics.get(self.metric)
        if cur is None:
            return
        better = self.best is None or (
            cur > self.best if self.mode == "max" else cur < self.best)
        if better:
            self.best = float(cur)
            ckpt_lib.save_finetune_checkpoint(
                os.path.join(t.out_dir, "model_best.ckpt"), t.state,
                self.best)


class CheckpointLoader(HookBase):
    """Resume from ``model_latest.ckpt`` when it exists: parameters,
    buffers, the optimizer's whole state, the step and the generator, bit
    for bit."""

    def before_train(self):
        path = os.path.join(self.trainer.out_dir, "model_latest.ckpt")
        if os.path.exists(path):
            self.trainer.state, _ = ckpt_lib.load_finetune_checkpoint(
                path, self.trainer.state)
            print(f"[finetune] resumed from {path}")


class RuntimeProfiler(HookBase):
    """A ``torch.profiler`` trace (CPU and, on a card, CUDA activity) of
    the steps from the one that starts at ``global_step == start_step``
    until ``global_step`` reaches ``start_step + num_steps - 1`` after a
    step (the JAX hook's rule), written as a Chrome trace to
    ``out_dir/profile/trace.json``; ``self.profile`` keeps the profile."""

    def __init__(self, start_step: int = 3, num_steps: int = 2):
        self.start_step = start_step
        self.num_steps = num_steps
        self.profile = None
        self._active = False

    def before_step(self):
        if self.trainer.global_step == self.start_step:
            self._dir = os.path.join(self.trainer.out_dir, "profile")
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.trainer.state.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.profile = torch.profiler.profile(activities=acts)
            self.profile.__enter__()
            self._active = True

    def after_step(self, metrics):
        if self._active and self.trainer.global_step >= \
                self.start_step + self.num_steps - 1:
            if self.trainer.state.device.type == "cuda":
                torch.cuda.synchronize()
            self.profile.__exit__(None, None, None)
            self._active = False
            os.makedirs(self._dir, exist_ok=True)
            self.trace_path = os.path.join(self._dir, "trace.json")
            self.profile.export_chrome_trace(self.trace_path)
            print(f"[finetune] profile written to {self._dir}")


class ClsEvaluator(HookBase):
    """Each epoch's classification accuracy and mean class accuracy over
    ``trainer.val_loader``."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def after_epoch(self):
        t = self.trainer
        if t.val_loader is None:
            return
        correct = np.zeros(self.num_classes)
        seen = np.zeros(self.num_classes)
        for batch in t.val_loader.epoch(0):
            pred = to_numpy(t.predict(batch)).argmax(-1).reshape(-1)
            lab = np.asarray(batch["label"]).reshape(-1)
            for c in range(self.num_classes):
                m = lab == c
                seen[c] += m.sum()
                correct[c] += (pred[m] == c).sum()
        acc = correct.sum() / max(seen.sum(), 1)
        macc = float(np.mean(correct[seen > 0] / seen[seen > 0])) \
            if (seen > 0).any() else 0.0
        t.eval_metrics.update(val_acc=float(acc), val_macc=macc)
        print(f"[finetune] epoch {t.epoch}: acc={acc:.4f} mAcc={macc:.4f}")


class SemSegEvaluator(HookBase):
    """Each epoch's mIoU, mAcc and allAcc over ``trainer.val_loader``;
    ``predict`` returns logits aligned with the batch's ``segment``."""

    def __init__(self, num_classes: int, ignore_index: int = -1):
        self.num_classes = num_classes
        self.ignore_index = ignore_index

    def after_epoch(self):
        t = self.trainer
        if t.val_loader is None:
            return
        inter = np.zeros(self.num_classes)
        union = np.zeros(self.num_classes)
        target = np.zeros(self.num_classes)
        correct = 0
        total = 0
        for batch in t.val_loader.epoch(0):
            pred = to_numpy(t.predict(batch)).argmax(-1).reshape(-1)
            lab = np.asarray(batch["segment"]).reshape(-1)
            ok = lab != self.ignore_index
            pred, lab = pred[ok], lab[ok]
            correct += (pred == lab).sum()
            total += len(lab)
            for c in range(self.num_classes):
                p, lc = pred == c, lab == c
                inter[c] += (p & lc).sum()
                union[c] += (p | lc).sum()
                target[c] += lc.sum()
        present = target > 0
        iou = inter[present] / np.maximum(union[present], 1)
        macc = inter[present] / np.maximum(target[present], 1)
        t.eval_metrics.update(
            val_miou=float(iou.mean()) if present.any() else 0.0,
            val_macc=float(macc.mean()) if present.any() else 0.0,
            val_allacc=float(correct / max(total, 1)))
        print(f"[finetune] epoch {t.epoch}: "
              f"mIoU={t.eval_metrics['val_miou']:.4f} "
              f"allAcc={t.eval_metrics['val_allacc']:.4f}")


class InsSegEvaluator(HookBase):
    """ScanNet-protocol instance-segmentation AP: per class, predictions
    greedily matched to ground-truth instances at IoU thresholds
    {0.5..0.9 step 0.05} and 0.25, regions under ``min_region_size``
    points left out, AP from the step-integrated precision-recall curve;
    reports mAP, AP50 and AP25.

    ``trainer.predict(batch)`` returns a dict of ``pred_classes`` [K],
    ``pred_scores`` [K] and ``pred_masks`` [K, N] (binary).
    """

    def __init__(self, num_classes: int, class_names=None,
                 segment_ignore_index=(-1,), instance_ignore_index=-1,
                 min_region_size: int = 100):
        self.num_classes = num_classes
        self.class_names = list(class_names) if class_names else \
            [str(i) for i in range(num_classes)]
        self.segment_ignore_index = set(segment_ignore_index)
        self.instance_ignore_index = instance_ignore_index
        self.overlaps = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
        self.min_region_size = min_region_size
        self.valid_classes = [c for c in range(num_classes)
                              if c not in self.segment_ignore_index]

    def _match_scene(self, pred, segment, instance):
        """Predictions and ground-truth instances of one scene, each with
        its overlaps with the other side."""
        segment = np.asarray(segment).reshape(-1)
        instance = np.asarray(instance).reshape(-1)
        void_mask = np.isin(segment, list(self.segment_ignore_index))
        gts = {c: [] for c in self.valid_classes}
        ids, first, counts = np.unique(instance, return_index=True,
                                       return_counts=True)
        for iid, seg, cnt in zip(ids, segment[first], counts):
            if iid == self.instance_ignore_index or \
                    seg in self.segment_ignore_index:
                continue
            gts[int(seg)].append({"id": int(iid), "verts": int(cnt),
                                  "matched": []})
        preds = {c: [] for c in self.valid_classes}
        pred = to_numpy(pred)
        classes = pred["pred_classes"].reshape(-1)
        scores = pred["pred_scores"].reshape(-1)
        masks = pred["pred_masks"].astype(bool)
        for k in range(len(classes)):
            c = int(classes[k])
            if c in self.segment_ignore_index or c not in preds:
                continue
            mask = masks[k]
            verts = int(mask.sum())
            if verts < self.min_region_size:
                continue
            p = {"score": float(scores[k]), "verts": verts,
                 "void": int((void_mask & mask).sum()), "matched": []}
            for g in gts[c]:
                inter = int(((instance == g["id"]) & mask).sum())
                if inter > 0:
                    p["matched"].append((g, inter))
                    g["matched"].append((p, inter))
            preds[c].append(p)
        return {"gt": gts, "pred": preds}

    def _ap(self, scenes):
        """AP table [n_valid_classes, n_overlaps] (NaN where a class has
        no ground truth)."""
        ap = np.full((len(self.valid_classes), len(self.overlaps)), np.nan)
        for oi, th in enumerate(self.overlaps):
            for li, c in enumerate(self.valid_classes):
                y_true, y_score = [], []
                hard_fn = 0
                has_gt = has_pred = False
                visited = set()
                for scene in scenes:
                    gts = [g for g in scene["gt"][c]
                           if g["verts"] >= self.min_region_size]
                    preds = scene["pred"][c]
                    has_gt |= bool(gts)
                    has_pred |= bool(preds)
                    for g in gts:
                        best = None
                        extras = []
                        for p, inter in g["matched"]:
                            if id(p) in visited:
                                continue
                            iou = inter / (g["verts"] + p["verts"] - inter)
                            if iou > th:
                                if best is None:
                                    best = p
                                elif p["score"] > best["score"]:
                                    extras.append(best)
                                    best = p
                                else:
                                    extras.append(p)
                        if best is None:
                            hard_fn += 1
                        else:
                            visited.add(id(best))
                            y_true.append(1)
                            y_score.append(best["score"])
                            for p in extras:
                                y_true.append(0)
                                y_score.append(p["score"])
                    for p in preds:
                        hit = any(
                            inter / (g["verts"] + p["verts"] - inter) > th
                            for g, inter in p["matched"])
                        if hit:
                            continue
                        ignore = p["void"] + sum(
                            inter for g, inter in p["matched"]
                            if g["verts"] < self.min_region_size)
                        if ignore / p["verts"] <= th:
                            y_true.append(0)
                            y_score.append(p["score"])
                if not has_gt:
                    continue
                if not has_pred or not y_true:
                    ap[li, oi] = 0.0
                    continue
                order = np.argsort(y_score)[::-1]
                yt = np.asarray(y_true)[order]
                tp = np.cumsum(yt)
                fp = np.cumsum(1 - yt)
                denom = max(int(tp[-1]) + hard_fn, 1)
                prec = np.concatenate([[1.0], tp / np.maximum(tp + fp, 1)])
                rec = np.concatenate([[0.0], tp / denom])
                ap[li, oi] = float(np.sum(np.diff(rec) * prec[1:]))
        return ap

    def after_epoch(self):
        t = self.trainer
        if t.val_loader is None:
            return
        scenes = [self._match_scene(t.predict(batch), batch["segment"],
                                    batch["instance"])
                  for batch in t.val_loader.epoch(0)]
        ap = self._ap(scenes)
        o25 = np.isclose(self.overlaps, 0.25)
        o50 = np.isclose(self.overlaps, 0.5)
        m = {"val_map": float(np.nanmean(ap[:, ~o25])),
             "val_ap50": float(np.nanmean(ap[:, o50])),
             "val_ap25": float(np.nanmean(ap[:, o25]))}
        t.eval_metrics.update({k: (0.0 if np.isnan(v) else v)
                               for k, v in m.items()})
        print(f"[finetune] epoch {t.epoch}: mAP={m['val_map']:.4f} "
              f"AP50={m['val_ap50']:.4f} AP25={m['val_ap25']:.4f}")


class FinetuneTrainer:
    """Epoch-based hook-driven trainer. ``train_step(state, batch) ->
    (state, metrics)`` and ``predict_fn(state, batch)`` are the task's;
    each batch reaches them on ``state.device``."""

    def __init__(self, state: FinetuneState, train_step: Callable,
                 train_loader, out_dir: str, max_epoch: int,
                 predict_fn: Optional[Callable] = None, val_loader=None,
                 hooks: Sequence[HookBase] = ()):
        self.state = state
        self.train_step = train_step
        self.predict_fn = predict_fn
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.out_dir = out_dir
        self.max_epoch = max_epoch
        self.hooks = list(hooks)
        for h in self.hooks:
            h.trainer = self
        self.epoch = 0
        self.global_step = 0
        self.eval_metrics: Dict[str, float] = {}

    def predict(self, batch):
        return self.predict_fn(self.state, batch_to(batch, self.state.device))

    def _call(self, name, *a):
        for h in self.hooks:
            getattr(h, name)(*a)

    def train(self) -> FinetuneState:
        self._call("before_train")
        for self.epoch in range(self.epoch, self.max_epoch):
            self._call("before_epoch")
            for batch in self.train_loader.epoch(self.epoch):
                self._call("before_step")
                self.state, metrics = self.train_step(
                    self.state, batch_to(batch, self.state.device))
                self.global_step += 1
                self._call("after_step", dict(metrics))
            self._call("after_epoch")
        self._call("after_train")
        return self.state
