"""JAX parameters <-> the port's ``state_dict``.

``jax_to_state_dict`` turns the JAX package's ``params`` and
``batch_stats`` trees, given as nested dicts of numpy arrays, into a
``state_dict`` of ``GaussianSplatPredictor`` so both packages can run on
the same weights:

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

``state_dict_to_jax`` is its exact inverse: the port's ``state_dict`` back
to the nested (``params``, ``batch_stats``) numpy trees, the layout the
exporters (export/) read. A 1-D ``weight`` is a norm's ``scale``, any
other ``weight`` a ``kernel`` (2-D transposed back to ``[in, out]``, 4-D
to HWIO, 3-D sparse-conv kernels as they are); ``running_mean`` /
``running_var`` go to ``batch_stats``; the VAE's diffusers names go back
to flax's.


``shard_state_dict`` / ``gather_state_dict`` split a ``state_dict`` over M
model ranks and join it back, bit for bit, by the tensor-parallel splits
(``TP_RULES``: JAX's rules of unipre3d_tpu/parallel/mesh.py written
against the port's names; ``TP_CHANNEL_RULES``: the Mamba mixers'
per-channel parameters). A torch ``Linear.weight`` is ``[out, in]``, the
transpose of flax's ``[in, out]`` kernel, so JAX's column split
``P(None, "model")`` cuts the torch weight's dim 0 and its row split
``P("model", None)`` dim 1.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Optional, Sequence, Tuple

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
# the inverse, on the dotted module path
_VAE_RULES_INV = [
    (r"down_blocks\.(\d+)\.resnets\.(\d+)", r"down_\1_resnet_\2"),
    (r"down_blocks\.(\d+)\.downsamplers\.0\.conv", r"down_\1_downsample"),
    (r"up_blocks\.(\d+)\.resnets\.(\d+)", r"up_\1_resnet_\2"),
    (r"up_blocks\.(\d+)\.upsamplers\.0\.conv", r"up_\1_upsample"),
    (r"mid_block\.resnets\.(\d+)", r"mid.resnets_\1"),
    (r"mid_block\.attentions\.(\d+)", r"mid.attentions_\1"),
    (r"to_out\.0$", r"to_out"),
]
_STATS = {"running_mean": "mean", "running_var": "var"}


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


def _jax_leaf(name: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    if name != "weight":
        return name, v
    if v.ndim == 1:
        return "scale", v
    if v.ndim == 2:
        return "kernel", v.T
    if v.ndim == 4:
        return "kernel", np.transpose(v, (2, 3, 1, 0))
    return "kernel", v


def state_dict_to_jax(state_dict) -> Tuple[Dict, Dict]:
    """Flat ``state_dict`` (tensors or arrays) -> nested (``params``,
    ``batch_stats``) numpy trees, the inverse of ``jax_to_state_dict``."""
    params, stats = {}, {}
    for key, v in state_dict.items():
        v = np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
        mod, _, name = key.rpartition(".")
        if mod.startswith("image_network."):
            for pat, rep in _VAE_RULES_INV:
                mod = re.sub(pat, rep, mod)
        if name in _STATS:
            tree, leaf = stats, _STATS[name]
        else:
            tree, (leaf, v) = params, _jax_leaf(name, v)
        node = tree
        for part in mod.split(".") if mod else ():
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(v)
    return params, stats


# Tensor parallelism. A rule is (pattern, dim, blocks): the torch tensor's
# dimension ``dim`` holds ``blocks`` equal blocks laid end to end, and
# model rank m of M keeps the m-th of M equal parts of each block. JAX's
# TP_RULES (unipre3d_tpu/parallel/mesh.py:65-74) cut the columns
# contiguously, a layout GSPMD computes on whole; here each rank computes
# on its part, so the qkv rows ([3][H][hd]) are cut head-aligned (rank m
# takes heads [m H/M, (m+1) H/M) of each of q, k and v) and in_proj's rows
# ([x | z]) by half, rank m taking the channels m of both x and z.
TP_RULES: Tuple[Tuple[str, int, int], ...] = (
    (r"attn\.qkv\.weight$", 0, 3),        # column parallel, by heads
    (r"attn\.qkv\.bias$", 0, 3),
    (r"attn\.proj\.weight$", 1, 1),       # row parallel
    (r"mlp\.fc1\.weight$", 0, 1),
    (r"mlp\.fc1\.bias$", 0, 1),
    (r"mlp\.fc2\.weight$", 1, 1),
    (r"mixer\.in_proj\.weight$", 0, 2),   # the d_inner channels of x and z
    (r"mixer\.out_proj\.weight$", 1, 1),
)
# A mixer split by TP_RULES scans its own channels of d_inner: the
# per-channel parameters go with them, and x_proj, which reads every
# channel, is row parallel. JAX replicates these; GSPMD computes the same.
TP_CHANNEL_RULES: Tuple[Tuple[str, int, int], ...] = (
    (r"mixer\.(fwd|bwd)\.conv_weight$", 1, 1),        # [K, d_inner]
    (r"mixer\.(fwd|bwd)\.(conv_bias|dt_bias|A_log|D)$", 0, 1),
    (r"mixer\.(fwd|bwd)\.dt_proj\.weight$", 0, 1),    # [d_inner, dt_rank]
    (r"mixer\.(fwd|bwd)\.x_proj\.weight$", 1, 1),     # [dt_rank + 2N, d_inner]
)


def tp_split(name: str, rules=TP_RULES + TP_CHANNEL_RULES
             ) -> Optional[Tuple[int, int]]:
    """(dim, blocks) of the first rule whose pattern ``name`` matches, or
    None (replicated): JAX's ``_spec_for``."""
    for pat, dim, blocks in rules:
        if re.search(pat, name):
            return dim, blocks
    return None


def shard_tensor(t: torch.Tensor, dim: int, blocks: int, m: int, M: int
                 ) -> torch.Tensor:
    """Model rank m's part of ``t`` (a new contiguous tensor); a dimension
    that ``blocks`` x M does not divide raises. GSPMD's sharding stands in
    its place in JAX."""
    n = t.shape[dim]
    if n % (blocks * M):
        raise ValueError(f"dimension {dim} of a {tuple(t.shape)} tensor "
                         f"({blocks} block(s)) does not split over {M} "
                         f"model ranks")
    part = t.unflatten(dim, (blocks, M, n // (blocks * M))).select(dim + 1, m)
    return part.flatten(dim, dim + 1).clone(
        memory_format=torch.contiguous_format)


def gather_tensor(parts: Sequence[torch.Tensor], dim: int, blocks: int
                  ) -> torch.Tensor:
    """The inverse of ``shard_tensor`` over the parts of ranks 0..M-1
    (JAX's global arrays need none)."""
    k = parts[0].shape[dim] // blocks
    return torch.stack([p.unflatten(dim, (blocks, k)) for p in parts],
                       dim + 1).flatten(dim, dim + 2)


def shard_state_dict(sd, m: int, M: int) -> Dict[str, torch.Tensor]:
    """Model rank m's ``state_dict`` of M: every tensor a rule names cut to
    its part, the others as they are (JAX: ``replicate``'s shardings)."""
    out = {}
    for k, v in sd.items():
        split = tp_split(k)
        out[k] = v if split is None else shard_tensor(v, *split, m, M)
    return out


def gather_state_dict(shards: Sequence[Dict[str, torch.Tensor]]
                      ) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` from model ranks 0..M-1's
    (``shard_state_dict``'s inverse, bit for bit)."""
    out = {}
    for k, v in shards[0].items():
        split = tp_split(k)
        out[k] = v if split is None else gather_tensor(
            [s[k] for s in shards], *split)
    return out
