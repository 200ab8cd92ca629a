"""Optimizer and learning-rate schedule factories of the fine-tuning engine.

Port of unipre3d_tpu/training/optim_factory.py. The JAX factory builds
optax chains; ``torch.optim`` is not optax (``optax.rmsprop`` adds ``eps``
inside the square root, ``optax.adagrad`` starts its accumulator at 0.1,
``torch.optim.NAdam`` has a momentum-decay schedule that ``optax.nadam``
lacks, lamb, lars, novograd, lion and optax's adafactor are not in
``torch.optim``), so each update rule is written here from optax's
definition, transformation by transformation, chained in optax's order:

* a :class:`GradientTransformation` is ``init(params) -> state`` and
  ``update(updates, state, params) -> (updates, state)`` over dicts of
  named tensors; the state is a flat dict of tensors and integer counts
  (``<i>/<field>/<param name>``, ``<i>/count``), saved and restored whole
  by the fine-tune checkpoint (training/checkpoint.py);
* :func:`apply_updates` adds the updates to the parameters in place;
* the schedule is read at the transformation's count before its increment,
  as ``optax.scale_by_schedule`` reads it; bias corrections ``1 - b^t`` are
  formed in float32, as optax forms them (``1 - 0.999`` in float32 is
  1.3e-5 away from 1e-3). float32 ``pow`` rounds differently in XLA and in
  torch at some counts, so RAdam's rectification term (a function of
  ``b2^t``) can differ in the last bits; it is not used below the
  threshold's ~5 steps.

The JAX factory's quirks are kept: ``"sgd"`` and ``"sgdp"`` ignore
``weight_decay``, ``"adafactor"`` ignores every keyword, and the decay
mask goes only to adamw and lamb. ``weight_decay_mask`` matches its
``no_weight_decay`` tokens against substrings of the port's own parameter
names (``named_parameters()``), JAX's against its tree paths.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def _polynomial(init: float, end: float, power: float, steps: int
                ) -> Schedule:
    def sched(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac ** power + end
    return sched


def make_schedule(name: str, base_lr: float, *, total_steps: int = 100_000,
                  warmup_steps: int = 0, decay_rate: float = 0.1,
                  step_size: int = 30_000, milestones: Sequence[int] = (),
                  min_lr: float = 0.0, power: float = 0.9) -> Schedule:
    """LR schedule by name (cosine | step | multistep | poly | linear |
    constant | tanh): a function of the update count. With
    ``warmup_steps`` a linear warm-up from 0 runs first and the schedule
    restarts its count after it (``optax.join_schedules``)."""
    name = name.lower()
    span = max(total_steps - warmup_steps, 1)
    if name == "cosine":
        alpha = min_lr / base_lr if base_lr else 0.0

        def sched(count):
            c = min(count, span)
            return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(
                math.pi * c / span)) + alpha)
    elif name == "step":
        def sched(count):
            if step_size <= 0 or decay_rate == 0 or count <= 0:
                return base_lr
            return base_lr * decay_rate ** math.floor(count / step_size)
    elif name == "multistep":
        bounds = sorted({int(m) for m in milestones})

        def sched(count):
            return base_lr * decay_rate ** sum(count >= m for m in bounds)
    elif name == "poly":
        sched = _polynomial(base_lr, min_lr, power, span)
    elif name == "linear":
        sched = _polynomial(base_lr, min_lr, 1, span)
    elif name == "constant":
        def sched(count):
            return base_lr
    elif name == "tanh":
        def sched(count):
            t = min(max(count / span, 0.0), 1.0)
            return min_lr + (base_lr - min_lr) * 0.5 * (
                1.0 - math.tanh(3.0 * (2.0 * t - 1.0)) / math.tanh(3.0))
    else:
        raise ValueError(f"unknown schedule: {name}")
    if warmup_steps > 0:
        warm, after = _polynomial(0.0, base_lr, 1, warmup_steps), sched

        def sched(count):
            return warm(count) if count < warmup_steps else \
                after(count - warmup_steps)
    return sched


# ---------------------------------------------------------------------------
# transformations (optax's, written out)
# ---------------------------------------------------------------------------

class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _bias(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32."""
    return float(_f32(1.0) - _f32(decay) ** _f32(float(count)))


def _zeros(params, fields):
    return {f"{f}/{n}": torch.zeros_like(p) for f in fields
            for n, p in params.items()}


def _moment(state, field, updates, decay, order):
    return {n: (1 - decay) * g ** order + decay * state[f"{field}/{n}"]
            for n, g in updates.items()}


def _named(field, tree):
    return {f"{field}/{n}": t for n, t in tree.items()}


def _norm(x):
    return torch.linalg.vector_norm(x)


def _stateless(fn) -> GradientTransformation:
    return GradientTransformation(lambda params: {},
                                  lambda u, s, p=None: (fn(u, p), s))


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return {f"{i}/{k}": v for i, tx in enumerate(txs)
                for k, v in tx.init(params).items()}

    def update(updates, state, params=None):
        new = {}
        for i, tx in enumerate(txs):
            pre = f"{i}/"
            sub = {k[len(pre):]: v for k, v in state.items()
                   if k.startswith(pre)}
            updates, sub = tx.update(updates, sub, params)
            new.update({pre + k: v for k, v in sub.items()})
        return updates, new
    return GradientTransformation(init, update)


def masked(inner: GradientTransformation, mask: Dict[str, bool]
           ) -> GradientTransformation:
    """``inner`` on the parameters where ``mask`` is True; the others'
    updates pass unchanged."""
    def pick(tree):
        return {n: v for n, v in tree.items() if mask[n]}

    def update(updates, state, params=None):
        out, state = inner.update(pick(updates), state,
                                  None if params is None else pick(params))
        return {n: out.get(n, g) for n, g in updates.items()}, state
    return GradientTransformation(lambda params: inner.init(pick(params)),
                                  update)


def scale(factor: float) -> GradientTransformation:
    return _stateless(lambda u, p: {n: factor * g for n, g in u.items()})


def scale_by_learning_rate(lr, flip_sign: bool = True
                           ) -> GradientTransformation:
    m = -1 if flip_sign else 1
    if not callable(lr):
        return scale(m * lr)

    def update(updates, state, params=None):
        step = m * lr(state["count"])
        return ({n: step * g for n, g in updates.items()},
                {"count": state["count"] + 1})
    return GradientTransformation(lambda params: {"count": 0}, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def fn(updates, params):
        g_norm = torch.sqrt(sum((g * g).sum() for g in updates.values()))
        keep = g_norm < max_norm
        return {n: torch.where(keep, g, g / g_norm * max_norm)
                for n, g in updates.items()}
    return _stateless(fn)


def add_decayed_weights(weight_decay: float,
                        mask: Optional[Dict[str, bool]] = None
                        ) -> GradientTransformation:
    tx = _stateless(lambda u, p: {n: g + weight_decay * p[n]
                                  for n, g in u.items()})
    return tx if mask is None else masked(tx, mask)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    def update(updates, state, params=None):
        new = {n: g + decay * state[f"trace/{n}"] for n, g in updates.items()}
        out = {n: g + decay * new[n] for n, g in updates.items()} \
            if nesterov else new
        return out, _named("trace", new)
    return GradientTransformation(lambda params: _zeros(params, ["trace"]),
                                  update)


def _adam_hats(updates, mu, nu, b1, b2, k, nesterov):
    if nesterov:
        b_next, b_now = _bias(b1, k + 1), _bias(b1, k)
        mu_hat = {n: b1 * (mu[n] / b_next) + (1 - b1) * (g / b_now)
                  for n, g in updates.items()}
    else:
        mu_hat = {n: m / _bias(b1, k) for n, m in mu.items()}
    return mu_hat, {n: v / _bias(b2, k) for n, v in nu.items()}


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                  nesterov: bool = False) -> GradientTransformation:
    def init(params):
        return dict(_zeros(params, ["mu", "nu"]), count=0)

    def update(updates, state, params=None):
        mu = _moment(state, "mu", updates, b1, 1)
        nu = _moment(state, "nu", updates, b2, 2)
        k = state["count"] + 1
        mu_hat, nu_hat = _adam_hats(updates, mu, nu, b1, b2, k, nesterov)
        out = {n: mu_hat[n] / (torch.sqrt(nu_hat[n] + eps_root) + eps)
               for n in updates}
        return out, dict(_named("mu", mu), **_named("nu", nu), count=k)
    return GradientTransformation(init, update)


def scale_by_radam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                   threshold=5.0) -> GradientTransformation:
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def init(params):
        return dict(_zeros(params, ["mu", "nu"]), count=0)

    def update(updates, state, params=None):
        mu = _moment(state, "mu", updates, b1, 1)
        nu = _moment(state, "nu", updates, b2, 2)
        k = state["count"] + 1
        b2t = _f32(b2) ** _f32(float(k))
        ro = float(_f32(ro_inf) - 2 * _f32(float(k)) * b2t / (1 - b2t))
        mu_hat, nu_hat = _adam_hats(updates, mu, nu, b1, b2, k, False)
        if ro >= threshold:
            r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                          / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            out = {n: r * mu_hat[n] / (torch.sqrt(nu_hat[n] + eps_root) + eps)
                   for n in updates}
        else:
            out = mu_hat
        return out, dict(_named("mu", mu), **_named("nu", nu), count=k)
    return GradientTransformation(init, update)


def scale_by_trust_ratio(trust_coefficient: float = 1.0, eps: float = 0.0
                         ) -> GradientTransformation:
    def fn(updates, params):
        out = {}
        for n, u in updates.items():
            pn, un = _norm(params[n]), _norm(u)
            ratio = trust_coefficient * pn / (un + eps)
            out[n] = u * torch.where((pn == 0) | (un == 0),
                                     torch.ones_like(ratio), ratio)
        return out
    return _stateless(fn)


def scale_by_rss(initial_accumulator_value=0.1, eps=1e-7
                 ) -> GradientTransformation:
    def init(params):
        return {f"sum_of_squares/{n}": torch.full_like(
            p, initial_accumulator_value) for n, p in params.items()}

    def update(updates, state, params=None):
        ss = {n: g * g + state[f"sum_of_squares/{n}"]
              for n, g in updates.items()}
        out = {n: torch.where(ss[n] > 0, torch.rsqrt(ss[n] + eps),
                              torch.zeros_like(g)) * g
               for n, g in updates.items()}
        return out, _named("sum_of_squares", ss)
    return GradientTransformation(init, update)


def scale_by_adadelta(rho=0.9, eps=1e-6) -> GradientTransformation:
    def update(updates, state, params=None):
        e_g = _moment(state, "e_g", updates, rho, 2)
        out = {n: (torch.sqrt(state[f"e_x/{n}"] + eps)
                   / torch.sqrt(e_g[n] + eps)) * g
               for n, g in updates.items()}
        e_x = _moment(state, "e_x", out, rho, 2)
        return out, dict(_named("e_g", e_g), **_named("e_x", e_x))
    return GradientTransformation(lambda p: _zeros(p, ["e_g", "e_x"]),
                                  update)


def scale_by_rms(decay=0.9, eps=1e-8) -> GradientTransformation:
    def update(updates, state, params=None):
        nu = _moment(state, "nu", updates, decay, 2)
        return ({n: torch.rsqrt(nu[n] + eps) * g for n, g in updates.items()},
                _named("nu", nu))
    return GradientTransformation(lambda p: _zeros(p, ["nu"]), update)


def scale_by_novograd(b1=0.9, b2=0.25, eps=1e-8, eps_root=0.0,
                      weight_decay=0.0) -> GradientTransformation:
    def init(params):
        return dict(_zeros(params, ["mu"]), count=0,
                    **{f"nu/{n}": torch.zeros((), dtype=p.dtype,
                                              device=p.device)
                       for n, p in params.items()})

    def update(updates, state, params):
        k = state["count"] + 1
        sq = {n: _norm(g) ** 2 for n, g in updates.items()}
        nu = sq if k == 1 else {n: (1 - b2) * sq[n] + b2 * state[f"nu/{n}"]
                                for n in updates}
        add = {n: g / (torch.sqrt(nu[n] + eps_root) + eps)
               + weight_decay * params[n] for n, g in updates.items()}
        mu = add if k == 1 else {n: b1 * state[f"mu/{n}"] + add[n]
                                 for n in updates}
        return mu, dict(_named("mu", mu), **_named("nu", nu), count=k)
    return GradientTransformation(init, update)


def scale_by_lion(b1=0.9, b2=0.99) -> GradientTransformation:
    def init(params):
        return dict(_zeros(params, ["mu"]), count=0)

    def update(updates, state, params=None):
        out = {n: torch.sign((1.0 - b1) * g + b1 * state[f"mu/{n}"])
               for n, g in updates.items()}
        mu = _moment(state, "mu", updates, b2, 1)
        return out, dict(_named("mu", mu), count=state["count"] + 1)
    return GradientTransformation(init, update)


def _factored_dims(shape, min_dim_size_to_factor):
    if len(shape) < 2:
        return None
    dims = np.argsort(shape)
    if shape[dims[-2]] < min_dim_size_to_factor:
        return None
    return int(dims[-2]), int(dims[-1])


def scale_by_factored_rms(decay_rate=0.8, min_dim_size_to_factor=128,
                          epsilon=1e-30) -> GradientTransformation:
    """Adafactor's factored second-moment estimate: a row and a column
    mean for each tensor whose second-largest dimension reaches
    ``min_dim_size_to_factor``, a full one for the others."""
    def init(params):
        state = {"count": 0}
        for n, p in params.items():
            dims = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            if dims is None:
                state[f"v/{n}"] = torch.zeros_like(p)
            else:
                shape = list(p.shape)
                state[f"v_row/{n}"] = p.new_zeros(
                    shape[:dims[1]] + shape[dims[1] + 1:])
                state[f"v_col/{n}"] = p.new_zeros(
                    shape[:dims[0]] + shape[dims[0] + 1:])
        return state

    def update(updates, state, params):
        k = state["count"]
        d = float(1.0 - _f32(float(k + 1)) ** -decay_rate)
        out, new = {}, {"count": k + 1}
        for n, g in updates.items():
            dims = _factored_dims(tuple(g.shape), min_dim_size_to_factor)
            g2 = g * g + epsilon
            if dims is None:
                v = d * state[f"v/{n}"] + (1.0 - d) * g2
                new[f"v/{n}"] = v
                out[n] = g * v ** -0.5
                continue
            d1, d0 = dims
            row = d * state[f"v_row/{n}"] + (1.0 - d) * g2.mean(d0)
            col = d * state[f"v_col/{n}"] + (1.0 - d) * g2.mean(d1)
            new[f"v_row/{n}"], new[f"v_col/{n}"] = row, col
            rd1 = d1 - 1 if d1 > d0 else d1
            row_factor = (row / row.mean(rd1, keepdim=True)) ** -0.5
            out[n] = g * row_factor.unsqueeze(d0) * \
                (col ** -0.5).unsqueeze(d1)
        return out, new
    return GradientTransformation(init, update)


def clip_by_block_rms(threshold: float) -> GradientTransformation:
    return _stateless(lambda u, p: {
        n: g / torch.clamp_min(torch.sqrt((g * g).mean()) / threshold, 1.0)
        for n, g in u.items()})


def scale_by_param_block_rms(min_scale: float = 1e-3
                             ) -> GradientTransformation:
    def rms(p):
        r = torch.sqrt((p * p).mean())
        return torch.where(r <= min_scale, torch.full_like(r, min_scale), r)
    return _stateless(lambda u, p: {n: g * rms(p[n]) for n, g in u.items()})


def apply_updates(params: Params, updates: Params) -> None:
    """``params += updates`` in place."""
    with torch.no_grad():
        for n, p in params.items():
            p.add_(updates[n])


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------

def _sgd(lr, momentum, nesterov=False):
    lr_tx = scale_by_learning_rate(lr)
    return lr_tx if momentum is None else \
        chain(trace(momentum, nesterov), lr_tx)


def _rmsprop(lr, decay, eps, momentum):
    txs = [scale_by_rms(decay, eps), scale_by_learning_rate(lr)]
    if momentum is not None:
        txs.append(trace(momentum))
    return chain(*txs)


def _adafactor(lr):
    return chain(scale_by_factored_rms(), clip_by_block_rms(1.0),
                 scale_by_learning_rate(lr, flip_sign=False),
                 scale_by_param_block_rms(), scale(-1))


_OPTIMIZERS: dict = {
    "adamw": lambda lr, **kw: chain(
        scale_by_adam(kw.get("b1", 0.9), kw.get("b2", 0.999),
                      kw.get("eps", 1e-8)),
        add_decayed_weights(kw.get("weight_decay", 0.01), kw.get("mask")),
        scale_by_learning_rate(lr)),
    "adam": lambda lr, **kw: chain(
        scale_by_adam(kw.get("b1", 0.9), kw.get("b2", 0.999),
                      kw.get("eps", 1e-8)),
        scale_by_learning_rate(lr)),
    "sgd": lambda lr, **kw: _sgd(lr, kw.get("momentum", 0.9),
                                 kw.get("nesterov", True)),
    "lamb": lambda lr, **kw: chain(
        scale_by_adam(eps=1e-6),
        add_decayed_weights(kw.get("weight_decay", 0.0), kw.get("mask")),
        scale_by_trust_ratio(), scale_by_learning_rate(lr)),
    "lars": lambda lr, **kw: chain(
        add_decayed_weights(kw.get("weight_decay", 0.0)),
        scale_by_trust_ratio(trust_coefficient=0.001),
        scale_by_learning_rate(lr), trace(kw.get("momentum", 0.9))),
    "adafactor": lambda lr, **kw: _adafactor(lr),
    "adagrad": lambda lr, **kw: chain(
        scale_by_rss(0.1, kw.get("eps", 1e-10)), scale_by_learning_rate(lr)),
    "adadelta": lambda lr, **kw: chain(
        add_decayed_weights(0.0),
        scale_by_adadelta(kw.get("rho", 0.9), kw.get("eps", 1e-6)),
        scale_by_learning_rate(lr)),
    "rmsprop": lambda lr, **kw: _rmsprop(
        lr, kw.get("decay", 0.9), kw.get("eps", 1e-8),
        kw.get("momentum", 0.9)),
    "nadam": lambda lr, **kw: chain(
        scale_by_adam(kw.get("b1", 0.9), kw.get("b2", 0.999), nesterov=True),
        scale_by_learning_rate(lr)),
    "radam": lambda lr, **kw: chain(
        scale_by_radam(kw.get("b1", 0.9), kw.get("b2", 0.999)),
        scale_by_learning_rate(lr)),
    "novograd": lambda lr, **kw: chain(
        scale_by_novograd(kw.get("b1", 0.9), kw.get("b2", 0.25), eps=1e-6,
                          weight_decay=kw.get("weight_decay", 0.0)),
        scale_by_learning_rate(lr)),
    "lion": lambda lr, **kw: chain(
        scale_by_lion(),
        add_decayed_weights(kw.get("weight_decay", 0.0)),
        scale_by_learning_rate(lr)),
    "sgdp": lambda lr, **kw: _sgd(lr, kw.get("momentum", 0.9)),
}


def weight_decay_mask(params: Params, no_weight_decay: Sequence[str] = ()
                      ) -> Dict[str, bool]:
    """True where decay applies: more than one dimension and no token of
    ``no_weight_decay`` in the parameter's name."""
    return {n: not any(tok in n for tok in no_weight_decay) and p.ndim > 1
            for n, p in params.items()}


def build_optimizer(name: str, lr, *, grad_clip: Optional[float] = None,
                    params: Optional[Params] = None,
                    no_weight_decay: Sequence[str] = (),
                    **kwargs) -> GradientTransformation:
    """Optimizer by name (``_OPTIMIZERS``); ``lr`` a float or a schedule.
    With ``params`` (named tensors) adamw and lamb take the decay mask;
    ``grad_clip`` chains ``clip_by_global_norm`` first."""
    name = name.lower()
    if name not in _OPTIMIZERS:
        raise ValueError(
            f"unknown optimizer {name}; have {sorted(_OPTIMIZERS)}")
    if params is not None and "mask" not in kwargs and \
            name in ("adamw", "lamb"):
        kwargs["mask"] = weight_decay_mask(params, no_weight_decay)
    tx = _OPTIMIZERS[name](lr, **kwargs)
    if grad_clip:
        tx = chain(clip_by_global_norm(float(grad_clip)), tx)
    return tx
