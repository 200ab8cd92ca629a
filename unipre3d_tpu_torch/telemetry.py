"""Spans and counters of the port, on ``torch.profiler``'s clock.

Everything here is inert unless a ``torch.profiler`` runs on the calling
thread (``port_bench/run.py --trace 1``, the fine-tune engine's
``RuntimeProfiler``, or a user's own profiler): an untraced program pays
one check per call.

* ``span(name)``: a ``record_function(name)`` range while a profiler
  runs. Its times are the profiler's own, so a range shares the device
  trace's clock, and a device operation belongs to the range its launch
  falls in.
* ``count(name, value)``: appends ``(time.time_ns(), value)`` to
  ``SAMPLES[name]`` while a profiler runs. ``time.time_ns()`` is the epoch
  clock that the profiler's events carry, so a reader matches the samples
  to a traced window by time alone. ``value`` is one the host holds
  already, never one that would wait for the device.
* ``mark(x, region)``: while a profiler runs, an identity of ``x`` whose
  backward opens the range ``backward/<region>`` on the thread that runs
  the backward, closing the range the previous mark opened; the last is
  closed when that backward ends. Autograd runs a graph's nodes in the
  reverse order of their creation, so a mark put on a region's output,
  after the region's last operation and before the next region's first,
  runs after the next region's backward and before its own region's: the
  ranges tile the backward in sequence and never overlap. Untraced, ``x``
  itself is returned and the graph is the one it would be without marks.

Span names: ``step/*`` (the train step's phases), ``predictor/*``,
``backward/*``, ``optimizer/*``, ``sync/*`` (where the host waits for the
device), ``cache/*`` (the feature cache), ``geometry/build``, ``data/*``,
``point_ops/fps``, ``graph/capture`` and ``graph/replay`` (the object
encoder's CUDA graphs, models/backbone_graph.py; a replayed encoder opens
none of the ranges inside it). Counter: ``h2d_bytes`` (the bytes
``batch_to`` moves). Only the thread that drives the step opens ranges;
the loader's reading thread opens none, as its ranges would overlap that
thread's in time.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from contextlib import nullcontext
from typing import Deque, Dict, Tuple

import torch
from torch.autograd.profiler import record_function

MAX_SAMPLES = 1 << 16   # kept a counter; the oldest go first
SAMPLES: Dict[str, Deque[Tuple[int, float]]] = defaultdict(
    lambda: deque(maxlen=MAX_SAMPLES))

_enabled = torch._C._autograd._profiler_enabled
_OFF = nullcontext()
_open = threading.local()   # the backward range open on this thread


def span(name: str):
    """A context manager: the profiler range ``name`` while a profiler
    runs, nothing otherwise."""
    return record_function(name) if _enabled() else _OFF


def count(name: str, value: float) -> None:
    """Keep ``(time.time_ns(), value)`` under ``name`` while a profiler
    runs."""
    if _enabled():
        SAMPLES[name].append((time.time_ns(), value))


def _enter_backward(name: str) -> None:
    rf = getattr(_open, "rf", None)
    if rf is not None:
        rf.__exit__(None, None, None)
    else:
        torch.autograd.Variable._execution_engine.queue_callback(
            _close_backward)
    _open.rf = record_function(name)
    _open.rf.__enter__()


def _close_backward() -> None:
    rf = getattr(_open, "rf", None)
    if rf is not None:
        rf.__exit__(None, None, None)
        _open.rf = None


class _Mark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if _enabled():
            _enter_backward(ctx.name)
        return grad, None


def mark(x: torch.Tensor, region: str) -> torch.Tensor:
    """``x``, or while a profiler runs and ``x`` takes part in autograd,
    an identity of it whose backward opens ``backward/<region>``."""
    if not (_enabled() and x.requires_grad and torch.is_grad_enabled()):
        return x
    return _Mark.apply(x, f"backward/{region}")
