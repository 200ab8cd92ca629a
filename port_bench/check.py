"""The comparison that decides ``correct``: the program's first steps
against the plain reference's over the same weights and batches.

Each number is a gap, read so that 0 is agreement. Those that
``limits/<cell>.json`` names are compared (PERF.md gives the readings
each limit was set from); the others are printed for the record:

* ``loss_<s>``: step s's loss, |program - reference| / |reference|;
* ``grad_worst``, ``grad_median``: over the leaves, the gap between the
  norms of step 1's gradient as the optimizer took it (after the clip),
  |program - reference| / max(reference, the median leaf's reference),
  its largest and its median;
* ``update_worst``, ``update_median``: the same of the norm of each
  leaf's change after the last check step;
* ``ema_worst``: the same of the EMA's change;
* ``bn_worst``, ``bn_median``: the same of the change of each BatchNorm
  running statistic (mean and variance, moved by every step's batch
  statistics) after the last check step; ``bn1_worst``, ``bn1_median``
  after step 1;
* ``grad_diff``, ``grad_diff_median``: the norm of the difference of
  step 1's gradients over the reference's norm, for the whole gradient
  (the kept leaves) and the median leaf (over max(leaf, median leaf));
* ``vae``: the largest gap of step 1's conditioning features (what the
  feature cache's ``attach`` returned) over their largest magnitude;
  ``vae_rms``: the norm of their difference over the reference's norm;
* ``gauss_worst``, ``gauss_median``: step 1's gaussians (the model's
  output: positions, opacities, scales, rotations, colours) sample by
  sample and field by field, the norm of the difference over the
  reference's norm, the largest over every (sample, field) and the median
  over the samples of each sample's largest. A sample the program did not
  produce, or a scene row whose validity differs, reads infinity: every
  sample of the batch is compared;
* ``head_worst``: the same of the Gaussian head's raw channels (before
  the activations), sample by sample;
* ``render_worst``, ``render_median``: the same of each sample's
  supervision renders of step 1;
* ``splat_worst``: the render stage on its own: each supervision render
  of step 1 (one a sample and view) against the plain renderer's view of
  the program's own step 1 gaussians (judged above by themselves), the
  largest gap;
* ``update_cos``, ``grad_cos``: over the leaves, the largest 1 - cosine
  between the program's and the reference's change of the leaf after the
  last check step (its direction, which Adam's normalisation does not
  hide), and of step 1's gradient; ``grad_cos_all``: 1 - cosine of step
  1's whole gradient (the kept leaves as one vector).

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the leaf gaps: their gradient is nought to
rounding (a bias before a BatchNorm), and Adam moves them by the sign of
that rounding alone.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

import torch

DEAD_LEAF = 1e-3


def kept_leaves(ref_grads: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grads.values())
    return [n for n, g in ref_grads.items() if g >= DEAD_LEAF * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Tuple[float, float]:
    med = statistics.median(ref[n] for n in leaves)
    gaps = [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves]
    return max(gaps), statistics.median(gaps)


def sample_gaps(prog, ref) -> List[float]:
    """Per sample (the first axis of ``ref``), the norm of the difference
    over the reference's norm; infinity where the program has no such
    sample."""
    if prog is None or prog.shape[1:] != ref.shape[1:]:
        return [math.inf] * ref.shape[0]
    out = []
    for b in range(ref.shape[0]):
        if b >= prog.shape[0]:
            out.append(math.inf)
            continue
        r = ref[b].double()
        d = float((prog[b].double() - r).norm())
        out.append(d / max(float(r.norm()), 1e-30))
    return out


def gaussian_gaps(prog: Optional[dict], ref: dict) -> List[float]:
    """Each sample's largest gap over the gaussians' fields; a scene's
    fields on the rows its reference mask keeps, and infinity where the
    masks differ."""
    prog = prog or {}
    mask = ref.get("mask")
    worst = [0.0] * next(v for k, v in ref.items() if k != "mask").shape[0]
    for key, r in ref.items():
        if key == "mask":
            continue
        p = prog.get(key)
        if mask is not None:
            pm = prog.get("mask")
            same = pm is not None and pm.shape == mask.shape and \
                bool((pm == mask).all())
            rows = [r[b][mask[b]] for b in range(r.shape[0])]
            gaps = [sample_gaps(p[b][mask[b]][None], rows[b][None])[0]
                    if same and p is not None else math.inf
                    for b in range(r.shape[0])]
        else:
            gaps = sample_gaps(p, r)
        worst = [max(w, g) for w, g in zip(worst, gaps)]
    return worst


def cosine_gap(a, b) -> float:
    """1 - cos(a, b); 1 where either is nought."""
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = float(a.norm()), float(b.norm())
    if na == 0.0 or nb == 0.0:
        return 1.0
    return 1.0 - float(a @ b) / (na * nb)


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared, from ``driver.program_readings`` and the
    reference's ``run_steps``."""
    out = {}
    for s, (lp, lr) in enumerate(zip(prog["losses"], ref["losses"]), 1):
        out[f"loss_{s}"] = abs(lp - lr) / max(abs(lr), 1e-30)
    leaves = kept_leaves(ref["grad_norms"])
    out["grad_worst"], out["grad_median"] = leaf_gaps(
        prog["grad_norms"], ref["grad_norms"], leaves)
    out["update_worst"], out["update_median"] = leaf_gaps(
        prog["update_norms"], ref["update_norms"], leaves)
    out["ema_worst"], _ = leaf_gaps(prog["ema_norms"], ref["ema_norms"],
                                    leaves)
    stats = sorted(ref["bn_norms"])
    out["bn_worst"], out["bn_median"] = leaf_gaps(prog["bn_norms"],
                                                  ref["bn_norms"], stats)
    out["bn1_worst"], out["bn1_median"] = leaf_gaps(
        prog["bn1_norms"], ref["bn1_norms"], stats)
    gp, gr = prog.get("grads"), ref.get("grads")
    if gp is not None and gr is not None:
        diff = {n: float((gp[n] - gr[n]).norm()) for n in leaves}
        total = sum(ref["grad_norms"][n] ** 2 for n in leaves) ** 0.5
        out["grad_diff"] = sum(d * d for d in diff.values()) ** 0.5 / total
        med = statistics.median(ref["grad_norms"][n] for n in leaves)
        out["grad_diff_median"] = statistics.median(
            diff[n] / max(ref["grad_norms"][n], med) for n in leaves)
    for key, name in (("updates", "update_cos"), ("grads", "grad_cos")):
        if prog.get(key) is not None and ref.get(key) is not None:
            out[name] = max(cosine_gap(prog[key][n], ref[key][n])
                            for n in leaves)
    if gp is not None and gr is not None:
        out["grad_cos_all"] = cosine_gap(
            torch.cat([gp[n].flatten() for n in leaves]),
            torch.cat([gr[n].flatten() for n in leaves]))
    if ref.get("gaussians") is not None:
        gaps = gaussian_gaps(prog.get("gaussians"), ref["gaussians"])
        out["gauss_worst"] = max(gaps)
        out["gauss_median"] = statistics.median(gaps)
    if ref.get("head") is not None:
        mask = (ref.get("gaussians") or {}).get("mask")
        pm = (prog.get("gaussians") or {}).get("mask")
        head = {"head": ref["head"]}
        if mask is not None:
            head["mask"] = mask
        out["head_worst"] = max(gaussian_gaps(
            None if prog.get("head") is None else
            {"head": prog["head"], "mask": pm}, head))
    if ref.get("splat_renders") is not None:
        out["splat_worst"] = max(sample_gaps(
            None if prog.get("renders") is None else
            prog["renders"].flatten(0, 1), ref["splat_renders"].flatten(0, 1)))
    if ref.get("renders") is not None:
        gaps = sample_gaps(prog.get("renders"), ref["renders"])
        out["render_worst"] = max(gaps)
        out["render_median"] = statistics.median(gaps)
    fp, fr = prog.get("vae_features"), ref.get("vae_features")
    if fp is not None and fr is not None:
        out["vae"] = float((fp - fr).abs().max() / fr.abs().max())
        out["vae_rms"] = float((fp - fr).norm() / fr.norm())
    return out


def decide(values: Dict[str, float], limits: Optional[Dict[str, float]]
           ) -> Tuple[bool, List[Tuple[str, float, Optional[float]]]]:
    """(correct, [(name, value, limit or None)]): correct when every
    number that has a limit is finite and at most its limit, and some
    number has one."""
    limits = limits or {}
    rows = [(k, v, limits.get(k)) for k, v in values.items()]
    missing = [k for k in limits if k not in values]
    compared = [(v, lim) for _, v, lim in rows if lim is not None]
    ok = bool(compared) and not missing and all(
        math.isfinite(v) and v <= lim for v, lim in compared)
    rows += [(k, float("nan"), limits[k]) for k in missing]
    return ok, rows
