"""Classification and segmentation losses of the fine-tuning engine.

Port of unipre3d_tpu/utils/losses_seg.py: cross entropy with label
smoothing, per-class weights and an ignored label, ``smooth_cross_entropy``,
the focal, Dice and Lovász-Softmax losses. Every function takes logits
[N, C] and integer labels [N]; ``ignore_index`` (-1) masks labels out.

Lovász sorts each class's errors in descending order with a stable sort,
as ``jnp.argsort`` does, ignored points last under the error -1: equal
errors keep their input order, so the Jaccard gradient's steps fall where
JAX's do.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F


def _valid(labels, ignore_index):
    return labels != ignore_index


def _nll_mean(loss, valid):
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    return loss.sum() / valid.sum().clamp_min(1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: int = -1) -> torch.Tensor:
    """Cross entropy over the valid labels; with ``label_smoothing`` the
    target is ``onehot (1 - s) + s / C``; ``weight`` [C] weighs each point
    by its label's class (the mean still divides by the valid count)."""
    C = logits.shape[-1]
    valid = _valid(labels, ignore_index)
    safe = labels.clamp(0, C - 1).long()
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(safe, C).to(logp.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / C
    nll = -(onehot * logp).sum(-1)
    if weight is not None:
        nll = nll * weight[safe]
    return _nll_mean(nll, valid)


def smooth_cross_entropy(logits, labels, num_classes: Optional[int] = None,
                         eps: float = 0.2, ignore_index: int = -1):
    """Cross entropy with label smoothing ``eps`` (0.2 by default)."""
    return cross_entropy(logits, labels, label_smoothing=eps,
                         ignore_index=ignore_index)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0, alpha: float = 0.5,
               ignore_index: int = -1) -> torch.Tensor:
    """Multi-class focal loss ``alpha (1 - p_t)^gamma CE``."""
    C = logits.shape[-1]
    valid = _valid(labels, ignore_index)
    safe = labels.clamp(0, C - 1).long()
    logp_t = torch.gather(F.log_softmax(logits, dim=-1), 1,
                          safe[:, None])[:, 0]
    loss = alpha * (1 - torch.exp(logp_t)) ** gamma * -logp_t
    return _nll_mean(loss, valid)


def dice_loss(logits: torch.Tensor, labels: torch.Tensor,
              smooth: float = 1.0, exponent: float = 2.0,
              ignore_index: int = -1) -> torch.Tensor:
    """One minus the mean Dice coefficient over the classes."""
    C = logits.shape[-1]
    valid = _valid(labels, ignore_index)[:, None]
    probs = F.softmax(logits, dim=-1) * valid
    onehot = F.one_hot(labels.clamp(0, C - 1).long(), C).to(probs.dtype) \
        * valid
    num = 2 * (probs * onehot).sum(0) + smooth
    den = (probs ** exponent + onehot ** exponent).sum(0) + smooth
    return 1.0 - (num / den).mean()


def lovasz_softmax(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = -1) -> torch.Tensor:
    """Lovász-Softmax over the classes present in ``labels``: for each
    class, the errors sorted in descending order (stable; ignored points
    last) weigh the steps of the Jaccard loss's gradient."""
    N, C = logits.shape
    valid = _valid(labels, ignore_index)
    probs = F.softmax(logits, dim=-1)
    safe = labels.clamp(0, C - 1).long()
    fg = ((safe[None, :] == torch.arange(C, device=logits.device)[:, None])
          & valid[None, :]).to(probs.dtype)                      # [C, N]
    errors = torch.where(valid[None, :], (fg - probs.T).abs(),
                         torch.full_like(fg, -1.0))
    order = torch.sort(-errors, dim=1, stable=True).indices
    err_s = torch.gather(errors, 1, order)
    fg_s = torch.gather(fg, 1, order)
    gts = fg_s.sum(1, keepdim=True)
    inter = gts - torch.cumsum(fg_s, 1)
    union = gts + torch.cumsum(1.0 - fg_s, 1)
    jaccard = 1.0 - inter / union.clamp_min(1e-12)
    grad = torch.diff(jaccard, dim=1, prepend=torch.zeros_like(jaccard[:, :1]))
    idx_ok = torch.arange(N, device=logits.device)[None, :] < valid.sum()
    loss_c = torch.where(idx_ok, err_s.clamp_min(0.0) * grad,
                         torch.zeros_like(grad)).sum(1)
    present = gts[:, 0] > 0
    losses = torch.where(present, loss_c, torch.zeros_like(loss_c))
    return losses.sum() / present.to(losses.dtype).sum().clamp_min(1.0)
