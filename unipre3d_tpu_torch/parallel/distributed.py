"""Multi-process runtime of the port: one process per rank, one device per
process, explicit collectives.

Counterpart of unipre3d_tpu/parallel/distributed.py. The JAX package runs
one SPMD program over a global, data-sharded batch, so its loss is the
global batch's mean, its BatchNorm statistics are global, its gradients are
reduced over every device before the clip, the NaN skip and AdamW, and
every host holds the same replicated state. The port gets the same result
from one process per rank and explicit collectives: a run on N ranks, on
the same global batches, equals the one-process run up to the order of
summation.

* ``maybe_initialize()`` forms the process group from the launch contract
  (``UNIPRE3D_*`` variables, or torchrun's) and never falls back to one
  process when a launch was requested.
* ``process_index()`` / ``process_count()`` stand where the JAX code calls
  ``jax.process_index()`` / ``jax.process_count()``.
* ``all_reduce_mean()`` is the weighted mean of a host scalar over ranks.
* ``synced()`` is the scope in which the model's batch reductions reach
  across ranks (``sum_across_ranks``: BatchNorm statistics, Mamba3D's
  feature spread) and DropPath draws the global batch's mask
  (``global_rows``); the train step and the CLI's validation enter it.
  Outside it, and with one process, no collective is called.
* ``form_grid(M)`` folds the W ranks into JAX's 2-D ``(data, model)``
  mesh (``make_mesh(model_parallel=M)``, ``devs.reshape(W // M, M)``):
  rank ``d * M + m`` is data rank d of D = W // M and model rank m of M,
  so a model group is M consecutive ranks. ``grid()`` is this rank's place
  in it. Every data-parallel reduction above spans the rank's data group,
  not the world: the ranks of a model group hold the same batch, so over
  the world ``_SumAcrossRanks``' backward would add each cotangent M
  times, ``global_rows`` would draw W·n rows, and the gradient mean would
  average different shards together. ``model_all_reduce_`` sums over the
  model group (parallel/tensor.py). With M = 1 (the default) the data
  group is the world and nothing else changes.

``shard_host_batch`` has no counterpart: a process keeps its local batch
(the loader's shard) on its own device, and the collectives above do what
the global array does in JAX.

Backends: NCCL when every rank of the host has a card of its own, gloo on
the CPU and where ranks share one card (NCCL refuses two ranks on one
device). Gloo takes the card's tensors itself (its CUDA path copies them
through the host on a stream of its own, ordered by events on the
caller's stream), so the step's tensors go to the collective as they are;
under NCCL a host tensor (a scalar mean, the generator's state) goes
through the card (``_on_backend``).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

#: variables that name a coordinator (``host:port``), as JAX's
_COORD_ENV = ("UNIPRE3D_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
              "COORDINATOR_ADDRESS")

_SYNCED = contextvars.ContextVar("unipre3d_synced", default=False)


def _launch():
    """(init method, world size, rank) of the requested launch, or None
    when the environment names none. Under torchrun the ``env://`` method
    joins the store its agent already serves at ``MASTER_PORT``."""
    env = os.environ
    coord = next((env[k] for k in _COORD_ENV if env.get(k)), None)
    if coord:
        missing = [k for k in ("UNIPRE3D_NUM_PROCESSES",
                               "UNIPRE3D_PROCESS_ID") if not env.get(k)]
        if missing:
            raise RuntimeError(f"coordinator {coord!r} is set but "
                               f"{', '.join(missing)} is not")
        return (f"tcp://{coord}", int(env["UNIPRE3D_NUM_PROCESSES"]),
                int(env["UNIPRE3D_PROCESS_ID"]))
    if env.get("RANK") and env.get("WORLD_SIZE"):      # torchrun
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def local_rank() -> int:
    """This process's index among the ranks of its host: torchrun's
    ``LOCAL_RANK``, else the global rank (a ``UNIPRE3D_*`` launch on one
    host)."""
    env = os.environ.get("LOCAL_RANK")
    return int(env) if env else process_index()


def _backend(device, world: int) -> str:
    """NCCL when the ranks run on CUDA cards and every rank of the host
    has one of its own, else gloo."""
    if device is not None and torch.device(device).type != "cuda":
        return "gloo"
    if not torch.cuda.is_available():
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def maybe_initialize(force: Optional[bool] = None, device=None) -> bool:
    """Form the process group when a multi-process launch is requested;
    True iff a world of more than one process is (already) formed.

    Launch contract (the JAX package's, plus torchrun's): run the same
    command in every process with either ``UNIPRE3D_COORDINATOR=host:port``
    (or ``JAX_COORDINATOR_ADDRESS`` / ``COORDINATOR_ADDRESS``),
    ``UNIPRE3D_NUM_PROCESSES=N`` and ``UNIPRE3D_PROCESS_ID=i``, or under
    ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``LOCAL_RANK``). ``UNIPRE3D_DIST=1`` or ``force=True``
    asks for a launch; one that names no world raises, as does one that
    cannot form its world. ``device`` is the ranks' device (``--device``):
    a CPU device takes gloo."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    launch = _launch()
    want = force if force is not None else (
        os.environ.get("UNIPRE3D_DIST", "") == "1" or launch is not None)
    if not want:
        return False
    if launch is None:
        raise RuntimeError(
            "a multi-process launch was requested but the environment names "
            "no world: set UNIPRE3D_COORDINATOR, UNIPRE3D_NUM_PROCESSES and "
            "UNIPRE3D_PROCESS_ID, or launch with torchrun")
    init_method, world, rank = launch
    backend = _backend(device, world)
    if backend == "nccl":
        lr = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(lr % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return world > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _on_backend(t: torch.Tensor) -> torch.Tensor:
    """The tensor the backend's collective takes for ``t``: a copy on this
    rank's card of a host tensor under NCCL, else ``t`` itself
    (contiguous)."""
    if dist.get_backend() == "nccl" and not t.is_cuda:
        return t.cuda()
    return t if t.is_contiguous() else t.contiguous()


@dataclass(frozen=True)
class Grid:
    """This rank's place in the ``(data, model)`` grid: rank =
    ``data_index * model_count + model_index``. ``data_group`` and
    ``model_group`` are its two process groups (None: the world, and no
    model group, when ``model_count`` is 1)."""
    data_index: int
    data_count: int
    model_index: int = 0
    model_count: int = 1
    data_group: object = None
    model_group: object = None


_GRID: Optional[Grid] = None
# the grids formed in this process group, by M: their groups live as long
# as the process group does, so each is formed once
_GRIDS: dict = {}


def form_grid(model_parallel: int = 1) -> Grid:
    """Fold the world into D x M = W ranks with M = ``model_parallel``, as
    JAX's ``make_mesh`` folds its devices (``M <= 1``: the 1-D data mesh).
    Every rank creates every data group, then every model group, in the
    same order (``dist.new_group`` is collective), once per M and process
    group. A world that M does not divide raises, as JAX's assert does;
    one process is a world of 1."""
    global _GRID
    M = int(model_parallel)
    if M <= 1:
        _GRID = None
        return grid()
    W, r = process_count(), process_index()
    if W % M:
        raise ValueError(f"a world of {W} process(es) does not fold into a "
                         f"(data, model) grid with model_parallel={M}")
    world = dist.group.WORLD
    world_of, cached = _GRIDS.get(M, (None, None))
    if world_of is not world:
        D = W // M
        data = [dist.new_group([d * M + m for d in range(D)])
                for m in range(M)]
        model = [dist.new_group([d * M + m for m in range(M)])
                 for d in range(D)]
        d, m = divmod(r, M)
        cached = Grid(d, D, m, M, data[m], model[d])
        _GRIDS[M] = (world, cached)
    _GRID = cached
    return _GRID


def grid() -> Grid:
    """This rank's grid: the one ``form_grid`` made, else the 1-D data
    mesh over the world (JAX reads these off its ``Mesh``)."""
    return _GRID or Grid(process_index(), process_count())


def data_count() -> int:
    """D: the ranks of this rank's data group (JAX's
    ``mesh.shape["data"]``)."""
    return grid().data_count


def model_count() -> int:
    """M: the ranks of this rank's model group (JAX's
    ``mesh.shape["model"]``)."""
    return grid().model_count


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    buf = _on_backend(t)
    dist.all_reduce(buf, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks of this rank's data group (the world when
    there is no model axis), in place; returns ``t``."""
    return _all_reduce_(t, grid().data_group)


def model_all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks of this rank's model group, in place;
    returns ``t``. No counterpart in JAX: GSPMD inserts these."""
    return _all_reduce_(t, grid().model_group)


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` with rank ``src``'s, in place; returns ``t``."""
    buf = _on_backend(t)
    dist.broadcast(buf, src)
    if buf is not t:
        t.copy_(buf)
    return t


def all_reduce_mean(value: float, weight: float = 1.0) -> float:
    """Weighted mean of a host scalar over the data group's processes (the
    reference's ``dist.all_reduce(psnr); psnr /= world_size``, weighted):
    exact for uneven shards, and a process with weight 0 takes part
    without moving the mean (0.0 when every weight is 0). One process:
    ``value``."""
    if data_count() == 1:
        return float(value)
    vw = all_reduce_sum_(torch.tensor([value * weight, weight],
                                      dtype=torch.float64))
    total = float(vw[1])
    return float(vw[0]) / total if total > 0 else 0.0


@contextlib.contextmanager
def synced():
    """The scope in which the model's batch statistics and DropPath's mask
    are those of the global batch (every rank runs the same forward)."""
    token = _SYNCED.set(True)
    try:
        yield
    finally:
        _SYNCED.reset(token)


def sync_world() -> int:
    """The number of ranks a batch reduction spans here: the data group's
    size inside ``synced()``, else 1."""
    return data_count() if _SYNCED.get() else 1


class _SumAcrossRanks(torch.autograd.Function):
    """All-reduce (sum) over the data group whose backward all-reduces the
    cotangent: every data rank's copy of the sum feeds its own loss, so the
    gradient of a rank's addend is the sum of all data ranks'
    cotangents."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone())


def sum_across_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of ``synced()`` (differentiable); ``x``
    itself outside it or with one process."""
    return _SumAcrossRanks.apply(x) if sync_world() > 1 else x


def global_rows(draw, n: int) -> torch.Tensor:
    """Draw a per-sample quantity for the global batch and keep this
    rank's rows: ``draw(rows)`` makes ``rows`` samples; inside
    ``synced()`` with D data ranks of ``n`` local samples it makes D·n,
    from the generator every rank shares, and data rank d takes rows
    [d·n, (d+1)·n), as JAX's draw over the data-sharded global batch
    does (the ranks of a model group take the same rows)."""
    w = sync_world()
    if w == 1:
        return draw(n)
    r = grid().data_index
    return draw(w * n)[r * n:(r + 1) * n]
