"""JAX parameters -> the port's ``state_dict``.

Turns the JAX package's ``params`` and ``batch_stats`` trees, given as
nested dicts of numpy arrays, into a ``state_dict`` of
``GaussianSplatPredictor`` so both packages can run on the same weights:

* a path ``a/b/c/leaf`` becomes ``a.b.c.<name>``: ``kernel`` and ``scale``
  (LayerNorm, RMSNorm) -> ``weight``, ``bias`` stays, batch-stat
  ``mean``/``var`` -> ``running_mean``/``running_var``, other leaves keep
  their name and layout (``cls_token``, ``cls_pos``, the Mamba mixer's
  ``conv_weight [K, D]``, ``conv_bias``, ``A_log``, ``D``, ``dt_bias``,
  the groupers' and LNP's ``affine_*``, PCM's ``order_prompt``). Modules
  under ``nn.remat`` (PCM's ``PCMStage``, ``MambaBlock``) keep their given
  names in the tree, so they resolve like any other;
* a Dense kernel ``[in, out]`` becomes a Linear weight ``[out, in]``; a
  Conv kernel HWIO becomes OIHW;
* the SD-VAE subtree (``image_network``) takes diffusers' module names
  (the inverse of unipre3d_tpu/models/vae.py:convert_torch_vae_state_dict).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}

_VAE_RULES = [
    (r"down_(\d+)_resnet_(\d+)", r"down_blocks.\1.resnets.\2"),
    (r"down_(\d+)_downsample", r"down_blocks.\1.downsamplers.0.conv"),
    (r"up_(\d+)_resnet_(\d+)", r"up_blocks.\1.resnets.\2"),
    (r"up_(\d+)_upsample", r"up_blocks.\1.upsamplers.0.conv"),
    (r"mid/resnets_(\d+)", r"mid_block.resnets.\1"),
    (r"mid/attentions_(\d+)", r"mid_block.attentions.\1"),
    (r"to_out$", r"to_out.0"),
]


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _module_path(path: Tuple[str, ...]) -> str:
    mod = "/".join(path)
    if path[0] == "image_network":
        for pat, rep in _VAE_RULES:
            mod = re.sub(pat, rep, mod)
    return mod.replace("/", ".")


def _convert(leaf: str, v: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and v.ndim == 2:
        return v.T
    if leaf == "kernel" and v.ndim == 4:
        return np.transpose(v, (3, 2, 0, 1))
    return v


def jax_to_state_dict(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """Nested ``params`` (and ``batch_stats``) -> flat torch state_dict.
    Also converts a gradient tree shaped like ``params``."""
    sd = {}
    for tree in (params, batch_stats or {}):
        for path, v in _flatten(tree):
            leaf = path[-1]
            name = _LEAF.get(leaf, leaf)
            key = f"{_module_path(path[:-1])}.{name}" if len(path) > 1 \
                else name
            sd[key] = torch.from_numpy(
                np.ascontiguousarray(_convert(leaf, v)).astype(np.float32))
    return sd
