"""Random weights from a seed, made on the device in one draw.

Both sides of the correctness check receive these weights: the program
loads them into its model, the reference makes them again from the same
seed. The rules are flax's initialisers as the program's ``init_like_flax``
applies them: kernels of linear and convolution layers normal with
variance 1/fan_in, biases 0, norm scales 1, the CLS token 0 and its
position N(0, 1); LPIPS's per-channel weights uniform in [0, 1/C).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch


def _rule(name: str, shape) -> Tuple[str, float]:
    """(draw, scale) of one leaf: draw ``normal``, ``uniform``, ``zeros`` or
    ``ones``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "cls_pos":
        return "normal", 1.0
    if leaf == "cls_token" or leaf == "bias":
        return "zeros", 0.0
    if leaf.startswith("lin") and len(shape) == 1:      # LPIPS's weights
        return "uniform", 1.0 / shape[0]
    if leaf == "weight" and len(shape) == 1:            # norm scales
        return "ones", 0.0
    if leaf == "weight":
        return "normal", 1.0 / math.sqrt(math.prod(shape[1:]))
    raise ValueError(f"no initialiser for {name} {tuple(shape)}")


def make_weights(shapes: Iterable[Tuple[str, torch.Size]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every (name, shape), drawn
    from one normal and one uniform buffer of a generator seeded
    ``seed``."""
    shapes = list(shapes)
    rules = [_rule(n, s) for n, s in shapes]
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(z for z, (d, _) in zip(sizes, rules) if d == "normal")
    n_unif = sum(z for z, (d, _) in zip(sizes, rules) if d == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device)
    out, i_n, i_u = {}, 0, 0
    for (name, shape), size, (draw, scale) in zip(shapes, sizes, rules):
        if draw == "normal":
            t = normal[i_n:i_n + size].view(shape).mul_(scale)
            i_n += size
        elif draw == "uniform":
            t = unif[i_u:i_u + size].view(shape).mul_(scale)
            i_u += size
        elif draw == "ones":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        out[name] = t
    return out


def shapes_of(module) -> list:
    """(name, shape) of a module's parameters, in its order."""
    return [(n, p.shape) for n, p in module.named_parameters()]
