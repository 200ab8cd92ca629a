"""The object backbone's forward and backward, replayed as two CUDA graphs.

An object training step runs the same encoder on the same shapes every
time: 1,024 points a cloud, FPS and ball query, the group embedding, the
blocks and the image fusion. Launched op by op, the host takes several
times the device's time to issue it. ``EncoderGraphs`` records the
encoder's call (``encoder(pts, generator=, **kwargs)``, with the modules
it reads) once as a forward graph and a backward graph, as
``torch.cuda.make_graphed_callables`` does, and replays them on every
later call with the same signature: one launch each way.

* The first call with a signature runs eagerly: it is the warm-up that
  builds handles, workspaces and kernels. The second captures both graphs
  and replays the forward; the later ones replay. The capture executes
  nothing: no DropPath mask is drawn and no BatchNorm statistic moves
  until the replay, which moves them once, as an eager call does.
* The tensors the call takes (points, image features, cameras) are copied
  into static inputs before each replay; they carry no gradient. The
  parameters are the inputs of an ``autograd.Function`` whose backward
  copies the incoming gradient into a static buffer, replays the backward
  graph and hands back the static gradients. Everything outside the
  encoder (the Gaussian head, the renderer, the loss, the optimizer) stays
  eager, and so do hooks put on modules outside it.
* The step's DropPath generator is registered with the forward graph:
  a replay draws from the generator's offset at that point and moves it
  on by as much as an eager call, so the masks are the eager ones.
* ``why_eager`` decides from what the call shows: grad disabled, eval
  mode, several data or model ranks (``synced()`` BatchNorm and the
  Megatron splits reduce across ranks), an input that carries a gradient,
  a hook on a module of the region or a global module hook
  (``torch.nn.modules.module.register_module_forward_hook`` and its
  kin), parameters that ``torch.func.functional_call`` put in place of
  the module's own, or a device other than CUDA each keep the call eager.
* A signature is the inputs' shapes, dtypes and devices, the generator,
  and the identity and address of every parameter and buffer of the
  region. One record is kept, with the one signature waiting for its
  capture: a new signature warms up and then replaces the record. A
  record keeps the parameters, buffers and generator it was captured with
  alive, so an address or identity is never reused while it stands.
* A replay whose backward has not run yet holds the static activations
  and outputs: a second call before that backward (a step that runs the
  model twice) runs eagerly, and a backward after a later replay raises.
* The hand-written kernels' launch counts (``kernels.CudaKernel``) hold
  what ran: the capture's launches are taken back off, and each replay
  adds its graph's.

The replayed outputs and gradients live in the graph's memory pool: a
call's outputs hold until the next replay, which is the next training
step.
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from unipre3d_tpu_torch import kernels
from unipre3d_tpu_torch.parallel import distributed as dist_lib
from unipre3d_tpu_torch.telemetry import span


def region_state(modules: Sequence[nn.Module]):
    """(parameters, buffers, whether any module carries a hook) of the
    region, each tensor once."""
    params: Dict[int, torch.Tensor] = {}
    buffers: Dict[int, torch.Tensor] = {}
    hooked = False
    for root in modules:
        for m in root.modules():
            hooked = hooked or bool(
                m._forward_hooks or m._forward_pre_hooks
                or m._backward_hooks or m._backward_pre_hooks)
            for t in m._parameters.values():
                if t is not None:
                    params.setdefault(id(t), t)
            for t in m._buffers.values():
                if t is not None:
                    buffers.setdefault(id(t), t)
    return list(params.values()), list(buffers.values()), hooked


def why_eager(encoder: nn.Module, modules: Sequence[nn.Module],
              tensors: Dict[str, torch.Tensor], region) -> Optional[str]:
    """Why the call stays eager, or None where it may replay a graph;
    ``region`` is ``region_state(modules)``."""
    if not torch.is_grad_enabled():
        return "grad disabled"
    if not all(m.training for m in modules):
        return "eval mode"
    if dist_lib.data_count() > 1 or dist_lib.model_count() > 1:
        return "several ranks"
    if any(t.requires_grad for t in tensors.values()):
        return "an input carries a gradient"
    params, _, hooked = region
    if hooked:
        return "a module of the region carries a hook"
    module = torch.nn.modules.module
    if any(getattr(module, name, None) for name in (
            "_global_forward_hooks", "_global_forward_pre_hooks",
            "_global_backward_hooks", "_global_backward_pre_hooks")):
        return "a global module hook"
    if not all(isinstance(p, nn.Parameter) for p in params):
        return "parameters substituted (functional_call)"
    if any(t.device.type != "cuda" for t in tensors.values()):
        return "not on a CUDA device"
    return None


class _Recorded:
    """One signature's graphs, static tensors and the state they read."""

    def __init__(self, fwd, bwd, inputs, outputs, grad_outputs, trainable,
                 grads, state, generator, fwd_launches, bwd_launches):
        self.fwd, self.bwd = fwd, bwd
        self.inputs = inputs                # name -> static input
        self.outputs = outputs              # static outputs
        self.grad_outputs = grad_outputs    # static, None where no grad
        self.trainable = trainable          # the parameters with a grad
        self.grads = grads                  # static, one each, or None
        self.state = state                  # every parameter and buffer
        self.generator = generator
        # CudaKernel -> its launches in each graph
        self.fwd_launches, self.bwd_launches = fwd_launches, bwd_launches
        self.replays = 0                    # forward replays so far
        self.pending = None                 # weakref to the ctx of a replay
        #                                     whose backward has not run

    def in_flight(self) -> bool:
        """A replay's autograd graph stands, its backward not run."""
        return self.pending is not None and self.pending() is not None


class _Replay(torch.autograd.Function):
    """The recorded forward graph forward, its backward graph backward."""

    @staticmethod
    def forward(ctx, rec: _Recorded, *params):
        ctx.rec = rec
        ctx.set_materialize_grads(False)
        with span("graph/replay"):
            rec.fwd.replay()
        _count(rec.fwd_launches)
        rec.replays += 1
        ctx.replay = rec.replays
        rec.pending = weakref.ref(ctx)
        outs = tuple(o.detach() for o in rec.outputs)
        ctx.mark_non_differentiable(*(o for o, g in zip(
            outs, rec.grad_outputs) if g is None))
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        rec = ctx.rec
        if ctx.replay != rec.replays:
            raise RuntimeError("the encoder graph's activations were "
                               "overwritten by a later replay before this "
                               "backward")
        rec.pending = None
        for static, g in zip(rec.grad_outputs, grads):
            if static is None:
                continue
            if g is None:
                static.zero_()
            else:
                static.copy_(g)
        rec.bwd.replay()
        _count(rec.bwd_launches)
        return (None,) + tuple(None if g is None else g.detach()
                               for g in rec.grads)


def _count(launches: Dict) -> None:
    for k, n in launches.items():
        k.launches += n


class EncoderGraphs:
    """Replays an object encoder's call as CUDA graphs where
    ``why_eager`` finds nothing against it; one record, of the newest
    signature captured."""

    def __init__(self):
        self._key = self._rec = None     # the record and its signature
        self._warm = None                # the signature warmed up last

    def __len__(self) -> int:
        return int(self._rec is not None)

    def __call__(self, encoder: nn.Module, extra: Sequence[nn.Module],
                 pts: torch.Tensor, generator=None, **kwargs):
        """``encoder(pts, generator=generator, **kwargs)``, the encoder
        reading the parameters of ``extra`` too (the fusion's modules).
        The tensors among ``kwargs`` are inputs; the other values are the
        same at every call."""
        modules = (encoder, *extra)
        tensors = {"pts": pts, **{k: v for k, v in kwargs.items()
                                  if isinstance(v, torch.Tensor)}}
        region = region_state(modules)
        if why_eager(encoder, modules, tensors, region) is not None:
            return encoder(pts, generator=generator, **kwargs)
        params, buffers, _ = region
        key = (tuple((k, tuple(t.shape), t.dtype, t.device)
                     for k, t in tensors.items()),
               tuple(k for k, v in kwargs.items() if v is None),
               id(generator), tuple(map(id, params)),
               tuple(p.requires_grad for p in params),
               tuple(t.data_ptr() for t in params + buffers))
        if key != self._key:
            if key != self._warm:
                self._warm = key
                return encoder(pts, generator=generator, **kwargs)
            self._key = self._rec = self._warm = None
            with span("graph/capture"):
                self._rec = capture(encoder, modules, tensors, kwargs,
                                    params, buffers, generator)
            self._key = key
        rec = self._rec
        if rec.in_flight():
            return encoder(pts, generator=generator, **kwargs)
        for k, t in tensors.items():
            rec.inputs[k].copy_(t)
        return _Replay.apply(rec, *rec.trainable)


@contextmanager
def _leaves_in_place(modules: Sequence[nn.Module],
                     leaves: Dict[int, torch.Tensor]):
    """While open, each parameter of ``modules`` that ``leaves`` maps (by
    id) is replaced by its leaf, as ``torch.func.functional_call`` does."""
    swapped = []
    try:
        for root in modules:
            for m in root.modules():
                for name, p in m._parameters.items():
                    if p is not None and id(p) in leaves:
                        swapped.append((m, name, p))
                        m._parameters[name] = leaves[id(p)]
        yield
    finally:
        for m, name, p in swapped:
            m._parameters[name] = p


@contextmanager
def _launches_taken_back(into: Dict):
    """While open, the CudaKernel launches made are written to ``into``
    and taken back off the kernels' counts: a capture launches nothing."""
    before = [k.launches for k in kernels.ALL]
    try:
        yield
    finally:
        for k, n in zip(kernels.ALL, before):
            if k.launches != n:
                into[k] = k.launches - n
                k.launches = n


@contextmanager
def _capturing(graph: torch.cuda.CUDAGraph, stream: torch.cuda.Stream,
               pool=None):
    """``torch.cuda.graph(graph, pool, stream)`` without its
    ``empty_cache``, which handed back the blocks the eager steps keep
    cached (0.66 s of ``object_fresh``'s set-up on an H100, and they were
    allocated again after it)."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            yield
        finally:
            graph.capture_end()


def capture(encoder: nn.Module, modules: Sequence[nn.Module],
            tensors: Dict[str, torch.Tensor], kwargs: Dict,
            params: List[torch.Tensor], buffers: List[torch.Tensor],
            generator) -> _Recorded:
    """Record the call's forward and backward graphs on static copies of
    ``tensors``; nothing runs on the live state. The graphs differentiate
    with respect to leaves that share the parameters' storage: the
    captured autograd graph, which lives as long as the record, then holds
    none of the parameters' own gradient accumulators, which stay on the
    stream of the eager steps."""
    inputs = {k: t.clone() for k, t in tensors.items()}
    call_kw = {k: inputs.get(k, v) for k, v in kwargs.items()}
    trainable = [p for p in params if p.requires_grad]
    leaves = {id(p): p.detach().requires_grad_() for p in trainable}
    fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    fwd_launches, bwd_launches = {}, {}
    if generator is not None:
        fwd.register_generator_state(generator)
    with torch.cuda.device(inputs["pts"].device):
        stream = torch.cuda.Stream()
        with _leaves_in_place(modules, leaves), _capturing(fwd, stream), \
                _launches_taken_back(fwd_launches):
            outputs = encoder(inputs["pts"], generator=generator, **call_kw)
        outputs = tuple(outputs)
        grad_outputs = [torch.empty_like(o) if o.requires_grad else None
                        for o in outputs]
        with _capturing(bwd, stream, fwd.pool()), \
                _launches_taken_back(bwd_launches):
            # a scalar whose gradient at each output is that output's
            # static buffer (1 x g, exact): handed the buffers as
            # grad_outputs, torch.autograd.grad would import sympy, seconds
            # of set-up once a process
            root = torch.stack([(o * g).sum().float() for o, g in zip(
                outputs, grad_outputs) if g is not None]).sum()
            grads = torch.autograd.grad(
                root, [leaves[id(p)] for p in trainable],
                retain_graph=True, allow_unused=True)
    return _Recorded(fwd, bwd, inputs, outputs, grad_outputs, trainable,
                     grads, params + buffers, generator, fwd_launches,
                     bwd_launches)
