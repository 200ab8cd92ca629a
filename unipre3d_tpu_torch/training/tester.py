"""Downstream evaluation: fragment voting and test-time augmentation.

Port of unipre3d_tpu/training/tester.py. ``SemSegTester`` evaluates a
whole scene by

1. TTA: each augmentation pipeline over the raw scene (identity by
   default);
2. fragmenting: test-mode grid sampling splits each augmented scene into
   ``count.max()`` fragments, fragment ``i`` taking the ``i % count``-th
   point of every voxel, each with ``index`` back into the scene
   (``grid_fragments``);
3. voting: each fragment's class probabilities are added into a whole-scene
   [n, K] accumulator at ``index``;
4. the argmax against the labels: per-class intersection, union and target,
   mIoU, mAcc and allAcc.

``ClsTester``, ``ClsVotingTester`` and ``PartSegTester`` are the object
testers. The model is ``predict_fn(dict) -> logits``; its output goes
through ``utils.misc.to_numpy``, so it may be a CUDA tensor.

Augmentation pipelines are transform lists in config syntax or callables
``(data_dict, draws)``. Their random draws come from ``draws``, a
``data.draws.Draws`` (or a function of the example's position that returns
one) given to ``test``; JAX's draw from the global ``random`` and
``np.random``, so seeding both alike gives equal records.
"""

from __future__ import annotations

import os
import random
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from unipre3d_tpu_torch.data.draws import Draws
from unipre3d_tpu_torch.data.transforms import build_pipeline, fnv_hash_vec
from unipre3d_tpu_torch.utils.misc import to_numpy

_POINT_KEYS = ("coord", "grid_coord", "color", "normal", "segment",
               "instance", "feat", "displacement")


def _identity(data_dict, draws=None):
    return data_dict


def _augs(aug_transforms):
    if aug_transforms is None:
        return [_identity]
    return [a if callable(a) else build_pipeline(a) for a in aug_transforms]


def _draws_of(draws, i: int) -> Draws:
    """The draws of the ``i``-th example: ``draws(i)`` when a function,
    else ``draws`` itself (one source carried through the examples, as
    JAX's globals are); a fresh unseeded source when None."""
    if draws is None:
        return Draws(np.random.RandomState(), random.Random())
    return draws(i) if callable(draws) else draws


def _copy(d):
    return {k: (np.copy(v) if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


def _softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def grid_fragments(data_dict: Dict[str, np.ndarray], grid_size: float,
                   keys: Sequence[str] = ("coord", "color", "normal",
                                          "feat"),
                   return_grid_coord: bool = True
                   ) -> List[Dict[str, np.ndarray]]:
    """Split a scene into voxel-stratified fragments that cover every
    point; each carries ``index``, its points' rows in the input."""
    coord = np.asarray(data_dict["coord"])
    grid_coord = np.floor(coord / grid_size).astype(np.int64)
    gmin = grid_coord.min(0)
    grid_coord = grid_coord - gmin
    key = fnv_hash_vec(grid_coord)
    idx_sort = np.argsort(key)
    _, count = np.unique(key[idx_sort], return_counts=True)
    starts = np.cumsum(np.insert(count, 0, 0)[:-1])
    fragments = []
    for i in range(int(count.max())):
        idx_part = idx_sort[starts + i % count]
        part = {"index": idx_part}
        if return_grid_coord:
            part["grid_coord"] = grid_coord[idx_part].astype(np.int32)
        part["min_coord"] = (gmin * grid_size).astype(np.float32)
        for k, v in data_dict.items():
            if k in ("index", "min_coord"):
                continue
            if k in keys or (k in _POINT_KEYS and k != "grid_coord"):
                part[k] = v[idx_part]
            else:
                part[k] = v
        fragments.append(part)
    return fragments


def _intersection_union(pred, label, K, ignore_index):
    """Per-class intersection, union and target counts of 1-D labels."""
    ok = label != ignore_index
    p, lab = pred[ok], label[ok]
    inter, union, target = np.zeros(K), np.zeros(K), np.zeros(K)
    for c in range(K):
        pc, lc = p == c, lab == c
        inter[c] = int((pc & lc).sum())
        union[c] = int((pc | lc).sum())
        target[c] = int(lc.sum())
    return inter, union, target


class SemSegTester:
    """Fragment-voting semantic-segmentation tester.

    num_classes: K. predict_fn: ``(fragment_dict) -> [n_frag, K]``
    logits. grid_size: the fragmenting voxel. aug_transforms: TTA
    pipelines (default: identity). ignore_index: the label left out.
    save_path: when set, each scene's argmax as ``{name}_pred.npy``.
    """

    def __init__(self, num_classes: int, predict_fn: Callable,
                 grid_size: float = 0.02,
                 aug_transforms: Optional[Sequence] = None,
                 ignore_index: int = -1,
                 save_path: Optional[str] = None):
        self.num_classes = num_classes
        self.predict_fn = predict_fn
        self.grid_size = grid_size
        self.ignore_index = ignore_index
        self.save_path = save_path
        self.augs = _augs(aug_transforms)

    def test_scene(self, data_dict: Dict[str, np.ndarray], draws=None):
        """One scene -> (pred [n], accumulated probabilities [n, K])."""
        draws = _draws_of(draws, 0)
        n = len(data_dict["coord"])
        probs = np.zeros((n, self.num_classes), np.float64)
        for aug in self.augs:
            aug_dict = aug(_copy(data_dict), draws)
            for frag in grid_fragments(aug_dict, self.grid_size):
                probs[frag["index"]] += _softmax(
                    to_numpy(self.predict_fn(frag)))
        return probs.argmax(-1), probs

    def test(self, scenes, draws=None) -> Dict[str, Any]:
        """``scenes``: dicts with at least coord and segment (optionally
        name, inverse, origin_segment); ``draws``: the TTA draws, a
        ``Draws`` or a function of the scene's position. Returns mIoU,
        mAcc, allAcc and the per-class IoU."""
        K = self.num_classes
        inter, union, target = np.zeros(K), np.zeros(K), np.zeros(K)
        correct, total = 0, 0
        for idx, scene in enumerate(scenes):
            pred, _ = self.test_scene(scene, _draws_of(draws, idx))
            segment = np.asarray(scene["segment"]).reshape(-1)
            if "origin_segment" in scene and "inverse" in scene:
                # labels of the cloud before voxelisation: the voxels'
                # predictions through the recorded inverse
                pred = pred[np.asarray(scene["inverse"]).reshape(-1)]
                segment = np.asarray(scene["origin_segment"]).reshape(-1)
            if self.save_path:
                os.makedirs(self.save_path, exist_ok=True)
                name = scene.get("name", f"scene{idx:04d}")
                np.save(os.path.join(self.save_path, f"{name}_pred.npy"),
                        pred)
            ok = segment != self.ignore_index
            p, lab = pred[ok], segment[ok]
            correct += int((p == lab).sum())
            total += int(len(lab))
            i, u, t = _intersection_union(p, lab, K, self.ignore_index)
            inter += i
            union += u
            target += t
        present = target > 0
        iou_class = inter / np.maximum(union, 1e-10)
        acc_class = inter / np.maximum(target, 1e-10)
        return {
            "mIoU": float(iou_class[present].mean()) if present.any()
            else 0.0,
            "mAcc": float(acc_class[present].mean()) if present.any()
            else 0.0,
            "allAcc": float(correct / max(total, 1)),
            "iou_class": iou_class,
        }


class ClsTester:
    """Single-pass shape classification: argmax of each example's class
    logits (``predict_fn(example) -> [K] or [B, K]``) against its
    ``category``; mIoU, mAcc, allAcc over the examples."""

    def __init__(self, num_classes: int, predict_fn: Callable,
                 ignore_index: int = -1):
        self.num_classes = num_classes
        self.predict_fn = predict_fn
        self.ignore_index = ignore_index

    def test(self, examples) -> Dict[str, Any]:
        K = self.num_classes
        inter, union, target = np.zeros(K), np.zeros(K), np.zeros(K)
        for ex in examples:
            logits = to_numpy(self.predict_fn(ex))
            if logits.ndim == 1:
                logits = logits[None]
            pred = logits.argmax(-1).reshape(-1)
            label = np.asarray(ex["category"]).reshape(-1)
            i, u, t = _intersection_union(pred, label, K, self.ignore_index)
            inter += i
            union += u
            target += t
        iou_class = inter / (union + 1e-10)
        acc_class = inter / (target + 1e-10)
        return {
            "mIoU": float(iou_class.mean()),
            "mAcc": float(acc_class.mean()),
            "allAcc": float(inter.sum() / (target.sum() + 1e-10)),
            "iou_class": iou_class,
        }


class ClsVotingTester:
    """TTA-voting classification: each example is augmented by every
    pipeline of ``aug_transforms``; a repeat's prediction is the softmax
    sum over the copies; of ``num_repeat`` repeats the best by ``metric``
    is kept. ``predict_fn(copy) -> [K]``."""

    def __init__(self, num_classes: int, predict_fn: Callable,
                 num_repeat: int = 10, metric: str = "allAcc",
                 aug_transforms: Optional[Sequence] = None,
                 ignore_index: int = -1):
        self.num_classes = num_classes
        self.predict_fn = predict_fn
        self.num_repeat = num_repeat
        self.metric = metric
        self.ignore_index = ignore_index
        self.augs = _augs(aug_transforms)

    def test_once(self, examples, draws=None) -> Dict[str, float]:
        K = self.num_classes
        inter, target = np.zeros(K), np.zeros(K)
        for i, ex in enumerate(examples):
            d = _draws_of(draws, i)
            probs = np.zeros((K,), np.float64)
            for aug in self.augs:
                probs += _softmax(to_numpy(
                    self.predict_fn(aug(_copy(ex), d))).reshape(-1))
            label = np.asarray(ex["category"]).reshape(-1)
            a, _, t = _intersection_union(np.asarray([probs.argmax()]),
                                          label, K, self.ignore_index)
            inter += a
            target += t
        acc_class = inter / (target + 1e-10)
        return {
            "mAcc": float(acc_class.mean()),
            "allAcc": float(inter.sum() / (target.sum() + 1e-10)),
        }

    def test(self, examples, draws=None) -> Dict[str, float]:
        """``draws``: a ``Draws`` carried through every repeat, or a
        function of the example's position (the same draws each
        repeat)."""
        best = None
        for i in range(self.num_repeat):
            rec = self.test_once(examples, draws)
            if best is None or rec[self.metric] > best[self.metric]:
                best = dict(rec, best_repeat=i)
        return best


class PartSegTester:
    """Part segmentation: per shape, per-point part probabilities summed
    over the TTA copies, argmaxed, and scored as the mean IoU over the
    parts of the shape's category (a part absent from both counts 1);
    instance-average ``ins_mIoU`` and category-average ``cat_mIoU``.
    ``predict_fn(example) -> [n, K]``; examples carry ``cls_token`` and
    ``segment``; ``category2part`` maps a category name to its labels."""

    def __init__(self, num_classes: int, predict_fn: Callable,
                 categories: Sequence[str],
                 category2part: Dict[str, Sequence[int]],
                 aug_transforms: Optional[Sequence] = None):
        self.num_classes = num_classes
        self.predict_fn = predict_fn
        self.categories = list(categories)
        self.category2part = category2part
        self.augs = _augs(aug_transforms)

    def test(self, examples, draws=None) -> Dict[str, Any]:
        n_cat = len(self.categories)
        iou_category, iou_count = np.zeros(n_cat), np.zeros(n_cat)
        for i, ex in enumerate(examples):
            d = _draws_of(draws, i)
            label = np.asarray(ex["segment"]).reshape(-1)
            probs = np.zeros((label.size, self.num_classes), np.float64)
            for aug in self.augs:
                probs += _softmax(to_numpy(self.predict_fn(aug(_copy(ex),
                                                               d))))
            pred = probs.argmax(-1)
            ci = int(ex["cls_token"])
            parts = self.category2part[self.categories[ci]]
            parts_iou = np.zeros(len(parts))
            for j, part in enumerate(parts):
                if (label == part).sum() == 0 and (pred == part).sum() == 0:
                    parts_iou[j] = 1.0
                else:
                    a = ((label == part) & (pred == part)).sum()
                    u = ((label == part) | (pred == part)).sum()
                    parts_iou[j] = a / (u + 1e-10)
            iou_category[ci] += parts_iou.mean()
            iou_count[ci] += 1
        return {
            "ins_mIoU": float(iou_category.sum()
                              / (iou_count.sum() + 1e-10)),
            "cat_mIoU": float((iou_category
                               / (iou_count + 1e-10)).mean()),
            "iou_category": iou_category / (iou_count + 1e-10),
        }
