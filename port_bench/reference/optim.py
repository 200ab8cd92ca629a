"""Plain reference of the update: optax's ``apply_if_finite(chain(
clip_by_global_norm(1.0), adamw(lr, b1, b2, eps=1e-15, weight_decay=0.01)))``
with the step-decay schedule and the EMA of UniPre3D's pretraining (a copy
of the parameters up to ``update_after_step``, then every
``update_every`` steps ``ema = beta ema + (1 - beta) p``), one leaf at a
time in float32."""

from __future__ import annotations

from typing import Dict, List

import torch


class AdamW:
    def __init__(self, params: List[torch.Tensor], base_lr, step_lr, gamma,
                 b1=0.9, b2=0.999, eps=1e-15, weight_decay=0.01,
                 max_norm=1.0):
        self.params = params
        self.base_lr, self.step_lr, self.gamma = base_lr, step_lr, gamma
        self.b1, self.b2, self.eps = b1, b2, eps
        self.wd, self.max_norm = weight_decay, max_norm
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Apply one update; returns the gradients as the moments take them
        (after the clip), or None where a gradient is not finite (no
        update)."""
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            return None
        norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
        if norm >= self.max_norm:
            grads = [g / norm * self.max_norm for g in grads]
        k = self.count + 1
        lr = self.base_lr * self.gamma ** (self.count // self.step_lr)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(g * g * (1 - self.b2))
            upd = (m / (1 - self.b1 ** k)) / (
                torch.sqrt(v / (1 - self.b2 ** k)) + self.eps)
            p.add_(-lr * (upd + self.wd * p))
        self.count += 1
        return grads


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], named, step, beta, every,
               after):
    """The EMA after the update that made the state's step ``step``."""
    if step <= after:
        for n, p in named:
            ema[n].copy_(p)
    elif step % every == 0:
        for n, p in named:
            ema[n].mul_(beta).add_(p * (1.0 - beta))
