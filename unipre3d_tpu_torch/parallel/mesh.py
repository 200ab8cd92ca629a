"""The rank's device, its (data, model) grid and the replicated and split
state: counterpart of unipre3d_tpu/parallel/mesh.py.

The JAX package lays a 1-D ``data`` mesh over every device, or with
``model_parallel = M`` a 2-D ``(data, model)`` grid: the batch is sharded
over ``data``, the parameters its ``TP_RULES`` match are split over
``model`` (Megatron's column and row splits of the transformer's attention
and MLP, PTv3's attention and the Mamba mixers' projections) and the rest
replicated, and GSPMD inserts the collectives. The port runs one process
per rank on one device each (parallel/distributed.py):

* ``make_mesh(device, model_parallel=M)`` forms the grid
  (``distributed.form_grid``: rank ``d * M + m``, a world M does not divide
  raises) and returns the rank's device; ``grid()`` is its place in the
  grid;
* ``TP_RULES`` are JAX's rules written against the port's parameter names
  (weights.py, with the torch weight's transposed layout), and
  ``tp_matched_paths`` returns the parameters they match: the same set as
  JAX's on the same model, through weights.py's names;
* ``replicate`` broadcasts rank 0's whole state, then keeps each rank's
  part of every split tensor (``weights.shard_tensor``: the parameters,
  their EMA and Adam moments); the modules that hold a split read it off
  their weights' shapes and call the collectives GSPMD would insert
  (parallel/tensor.py). ``require_tp_match`` raises, as JAX's
  does, when the grid has a model axis and nothing matches;
* ``gathered_state_dict`` joins the split tensors back (no counterpart:
  JAX's arrays are global).

Held differences: a head count or ``d_inner`` that M does not divide
raises (GSPMD would pad); the qkv and in_proj rows are split head- and
half-aligned (weights.TP_RULES) where JAX's contiguous split is only a
layout to GSPMD; the mixers' per-channel parameters (conv, dt_proj, dt_bias,
A_log, D) and x_proj's input are split with their channels, where JAX
replicates them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from unipre3d_tpu_torch import resolve_device
from unipre3d_tpu_torch.parallel.distributed import (broadcast_, form_grid,
                                                     grid, local_rank,
                                                     process_count)
from unipre3d_tpu_torch.weights import (TP_RULES, gather_tensor,
                                        shard_tensor, tp_split)

__all__ = ["TP_RULES", "make_mesh", "tp_matched_paths", "replicate",
           "gathered_state_dict", "is_model_shard"]


def make_mesh(device=None, model_parallel: int = 1) -> torch.device:
    """Form the ``(data, model)`` grid of ``model_parallel`` model ranks
    (1: the data-parallel world; ``distributed.form_grid``) and return the
    device of this rank: what ``device`` names, except that ``None`` or a
    bare ``"cuda"`` is the card ``LOCAL_RANK % device_count`` (ranks of one
    host share a card when there are fewer cards than ranks). A missing
    card raises (``resolve_device``), as does a world that
    ``model_parallel`` does not divide."""
    form_grid(model_parallel)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def tp_matched_paths(model: nn.Module) -> list:
    """Names of the model's parameters that a ``TP_RULES`` rule matches:
    the silent-replication guard. JAX's ``tp_matched_paths``."""
    return [name for name, p in model.named_parameters()
            if tp_split(name, TP_RULES) is not None
            and tp_split(name, TP_RULES)[0] < p.ndim]


def is_model_shard(p: torch.Tensor) -> bool:
    """Whether ``replicate`` split this parameter over the model group (in
    JAX, its ``NamedSharding``)."""
    return getattr(p, "model_split", None) is not None


def _broadcast_all(tensors) -> None:
    """Broadcast tensors from rank 0 in place, one flat buffer per dtype
    and device."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = broadcast_(_flatten_dense_tensors(ts))
        for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(v)


def _check_heads(model: nn.Module, M: int) -> None:
    """Every attention whose ``qkv`` a rule splits must have a head count
    that M divides (GSPMD would pad, the port raises); ``shard_tensor``
    checks the channel counts."""
    for prefix, mod in model.named_modules():
        heads = getattr(mod, "num_heads", None)
        if heads is not None and hasattr(mod, "qkv") and \
                tp_split(f"{prefix}.qkv.weight") is not None and heads % M:
            raise ValueError(f"{type(mod).__name__} {prefix}: heads = "
                             f"{heads} does not split over {M} model ranks")


def _split_state(model: nn.Module, state, m: int, M: int) -> None:
    """Keep model rank m's part of every tensor a rule names: the
    parameter (in place, the same ``Parameter``, marked ``model_split``),
    its EMA and its Adam moments. The modules read their split off their
    weights' shapes (parallel/tensor.py ``split_ranks``)."""
    _check_heads(model, M)
    opt = state.optimizer
    slot = {id(p): i for i, p in enumerate(opt.params)}
    for name, p in model.named_parameters():
        split = tp_split(name)
        if split is None:
            continue
        if is_model_shard(p):
            raise RuntimeError(f"{name} is already split over the model "
                               f"group")
        p.data = shard_tensor(p.data, *split, m, M)
        p.model_split = split
        if name in state.ema:
            state.ema[name] = shard_tensor(state.ema[name], *split, m, M)
        i = slot.get(id(p))
        if i is not None:
            opt.mu[i] = shard_tensor(opt.mu[i], *split, m, M)
            opt.nu[i] = shard_tensor(opt.nu[i], *split, m, M)


@torch.no_grad()
def replicate(model: nn.Module, state, require_tp_match: bool = False
              ) -> None:
    """Make every rank's model and train state rank 0's: the parameters,
    the buffers (BatchNorm running statistics), the EMA, the optimizer's
    moments and counts, the step and the DropPath generator's state; then,
    on a grid with a model axis, keep this rank's part of every tensor
    ``TP_RULES`` and the mixers' channel rules split. Run it after the
    init, the warm start and a resume; with one process it does nothing.

    JAX's ``replicate``, whose ``device_put`` onto ``NamedSharding``s
    GSPMD then computes on. ``require_tp_match`` raises if the grid has a
    model axis but no
    parameter matches a rule (a backbone without one, such as PointMLP or
    SparseUNet, or a module rename): everything would silently replicate
    and "TP" do nothing."""
    g = grid()
    if require_tp_match and g.model_count > 1 and \
            not tp_matched_paths(model):
        raise ValueError(
            "replicate(): the grid has a model axis but no parameter "
            f"path matches TP_RULES {[p for p, *_ in TP_RULES]} — tensor "
            "parallelism would silently degrade to pure replication. "
            "Update TP_RULES for the current module names.")
    if process_count() == 1:
        return
    opt = state.optimizer
    _broadcast_all(list(model.parameters()) + list(model.buffers())
                   + list(state.ema.values()) + opt.mu + opt.nu)
    counts = broadcast_(torch.tensor([opt.count, state.step],
                                     dtype=torch.int64))
    opt.count, state.step = int(counts[0]), int(counts[1])
    gen = broadcast_(state.generator.get_state())
    state.generator.set_state(gen)
    if g.model_count > 1:
        _split_state(model, state, g.model_index, g.model_count)


def gathered_state_dict(model: nn.Module) -> dict:
    """The whole ``state_dict`` of a model split over the model group, on
    every rank (the split parameters gathered over the group, on the
    host)."""
    sd = dict(model.state_dict())
    g = grid()
    if g.model_count == 1:
        return sd
    splits = {n: p.model_split for n, p in model.named_parameters()
              if is_model_shard(p)}
    for name, split in splits.items():
        part = sd[name].detach().cpu().contiguous()
        parts = [torch.empty_like(part) for _ in range(g.model_count)]
        dist.all_gather(parts, part, group=g.model_group)
        sd[name] = gather_tensor(parts, *split)
    return sd
