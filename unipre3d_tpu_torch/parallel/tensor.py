"""Megatron's operators over the model group: the collectives of tensor
parallelism.

The JAX package has no counterpart: on its ``(data, model)`` mesh GSPMD
reads the parameters' shardings (parallel/mesh.py ``TP_RULES``) and
inserts these collectives itself. The port has no GSPMD, so the modules
that hold a split (models/layers.py ``Attention`` and ``Mlp``,
models/ptv3.py ``SerializedAttention``, models/mamba_mixer.py
``MambaMixer``) call them where GSPMD would put them:

* ``copy_to_model``: identity forward, all-reduce backward. It goes before
  a column-parallel product: each rank's shard gives only its part of the
  gradient of the replicated input.
* ``reduce_from_model``: all-reduce forward, identity backward. It goes
  after a row-parallel product whose sum feeds replicated code.
* ``sum_model``: all-reduce both ways. Mamba's ``x_proj`` reads every
  channel of ``d_inner`` (row-parallel), and its summed dt, B and C feed
  the rank's own channels again, so their gradient is a sum over ranks
  too; the identity backward of ``reduce_from_model`` would leave the
  ``x_proj``, conv and ``in_proj`` gradients partial.

The sums are taken in float32 (a bfloat16 partial is widened first and
the sum rounded back once). With one model rank each is the identity and
calls no collective. ``split_ranks`` tells a module how many ranks its
weights are split over. ``MODEL_COMM`` counts every all-reduce over the
model group (these and the trainer's gradient-norm sum) and, when its
``timed`` is set, times each one with CUDA events on the card (the host
clock on the CPU).
"""

from __future__ import annotations

import time

import torch

from unipre3d_tpu_torch.parallel.distributed import (model_all_reduce_,
                                                     model_count)


class CommStats:
    """Count (and, when ``timed``, time) of the model-group all-reduces
    since the last ``reset``. No JAX counterpart (GSPMD's collectives are
    inside the compiled step)."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self._clocks = []

    def ms(self) -> float:
        """The timed all-reduces' total milliseconds (synchronizes the
        card's events)."""
        total = 0.0
        for a, b in self._clocks:
            if isinstance(a, float):
                total += (b - a) * 1e3
            else:
                b.synchronize()
                total += a.elapsed_time(b)
        return total

    def _start(self, t: torch.Tensor):
        if not self.timed:
            return None
        if t.is_cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _stop(self, start) -> None:
        if start is None:
            return
        if isinstance(start, float):
            self._clocks.append((start, time.perf_counter()))
        else:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._clocks.append((start, ev))


MODEL_COMM = CommStats()


def model_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group in place, counted in
    ``MODEL_COMM``; returns ``t``."""
    start = MODEL_COMM._start(t)
    model_all_reduce_(t)
    MODEL_COMM.count += 1
    MODEL_COMM._stop(start)
    return t


def _model_sum(x: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``x`` summed over the model group in float32, in
    ``x``'s dtype."""
    return model_sum_(x.detach().float().clone()).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(g)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _model_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _SumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _model_sum(x)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(g)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, sum over the model group backward (GSPMD inserts
    it in JAX)."""
    return _CopyToModel.apply(x) if model_count() > 1 else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Sum over the model group forward, identity backward (GSPMD inserts
    it in JAX)."""
    return _ReduceFromModel.apply(x) if model_count() > 1 else x


def sum_model(x: torch.Tensor) -> torch.Tensor:
    """Sum over the model group forward and backward (GSPMD inserts it in
    JAX)."""
    return _SumModel.apply(x) if model_count() > 1 else x


def split_ranks(dense: torch.nn.Linear, dim: int) -> int:
    """The model ranks that ``replicate`` split ``dense``'s weight over
    along ``dim`` (1: whole): its constructed size over its part's. A
    split weight must run in a grid of as many model ranks: any other grid
    would skip or misplace its sums (GSPMD checks shardings against the
    mesh in JAX)."""
    full = dense.out_features if dim == 0 else dense.in_features
    M = full // dense.weight.shape[dim]
    if M > 1 and M != model_count():
        raise RuntimeError(f"a module split over {M} model ranks runs in "
                           f"a grid of {model_count()}")
    return M
