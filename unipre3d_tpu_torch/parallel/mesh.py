"""The rank's device and the replicated state: counterpart of
unipre3d_tpu/parallel/mesh.py.

The JAX package lays a 1-D ``data`` mesh over every device: the batch is
sharded over it and the state replicated, so XLA reduces the gradients and
the BatchNorm statistics over all devices. The port runs one process per
rank on one device each (parallel/distributed.py): ``make_mesh`` becomes
the rank's device, and ``replicate`` a broadcast from rank 0 of everything
the step updates, so every rank starts each step from the same state.

The JAX package's 2-D ``(data, model)`` mesh, Megatron tensor parallelism
over the transformer-family kernels (``TP_RULES``, ``tp_matched_paths``,
``replicate(require_tp_match=)``), is not ported: those names raise,
naming ROADMAP.md item 21.
"""

from __future__ import annotations

import torch
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from unipre3d_tpu_torch import resolve_device
from unipre3d_tpu_torch.parallel.distributed import (broadcast_, local_rank,
                                                     process_count)

_TP = ("tensor parallelism (the JAX package's (data, model) mesh, TP_RULES, "
       "tp_matched_paths, require_tp_match) is not ported: ROADMAP.md item 21")


def make_mesh(device=None, model_parallel: int = 1) -> torch.device:
    """The device of this rank: what ``device`` names, except that
    ``None`` or a bare ``"cuda"`` is the card ``LOCAL_RANK % device_count``
    (ranks of one host share a card when there are fewer cards than ranks).
    A missing card raises (``resolve_device``). ``model_parallel > 1``
    raises (item 21)."""
    if model_parallel > 1:
        raise NotImplementedError(_TP)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def tp_matched_paths(tree):
    raise NotImplementedError(_TP)


def __getattr__(name):
    if name == "TP_RULES":
        raise NotImplementedError(_TP)
    raise AttributeError(name)


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


@torch.no_grad()
def replicate(model: nn.Module, state, require_tp_match: bool = False
              ) -> None:
    """Make every rank's model and train state rank 0's: the parameters,
    the buffers (BatchNorm running statistics), the EMA, the optimizer's
    moments and counts, the step and the DropPath generator's state. Run it
    after the init, the warm start and a resume; with one process it does
    nothing."""
    if require_tp_match:
        raise NotImplementedError(_TP)
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
