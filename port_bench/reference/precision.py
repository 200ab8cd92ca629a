"""The precision the plain reference computes in.

The reference keeps every tensor in float32 and rounds, with a
``Rounding``, where the program casts to its compute dtype: the inputs,
weights and biases of linear and convolution layers, and the outputs of
norms and softmaxes. ``float32`` rounds nothing (the reference proper);
``fp8`` rounds each tensor to float8 e4m3 with one scale per tensor (its
largest magnitude mapped to e4m3's 448), the precision below the
configurations' bfloat16 and the control of the correctness check.
Rounding passes the gradient straight through.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
KINDS = ("float32", "fp8")


class Rounding:
    def __init__(self, kind: str = "float32"):
        if kind not in KINDS:
            raise ValueError(f"rounding {kind!r}: one of {KINDS}")
        self.kind = kind

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        amax = x.detach().abs().amax().float()
        scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
        y = (x * scale).clamp(-E4M3_MAX, E4M3_MAX)
        return y.to(torch.float8_e4m3fn).float() / scale

    def __call__(self, x):
        if x is None or self.kind == "float32":
            return None if x is None else x.float()
        x = x.float()
        return x + (self._round(x.detach()) - x).detach()
