"""PyTorch port vs the JAX package: the segmentation losses and the
optimizer and schedule factories of the fine-tuning engine.

Same numpy inputs through both, float32 on the CPU. Tolerances:

* losses (N = 257, C = 20, ignored labels, equal errors for Lovász):
  value 1e-6 relative, gradient 1e-6 relative to its largest entry (float32
  reductions summed in other orders);
* optimizers: parameters after 5 updates of a tree of a 2-D, a 1-D and a
  3-D tensor, 1e-6 relative (measured <= 4e-7: float32 rounding of the
  same update rules, the bias corrections formed in float32 as optax forms
  them);
* schedules: 1e-5 relative (optax evaluates them in float32, the port in
  float64: measured up to 3e-6 where tanh nears its floor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unipre3d_tpu.models import sparseunet as jsp
from unipre3d_tpu.training import optim_factory as jopt
from unipre3d_tpu.utils import losses_seg as jloss
from unipre3d_tpu_torch.models.sparseunet import SpUNet
from unipre3d_tpu_torch.training import optim_factory as topt
from unipre3d_tpu_torch.utils import losses_seg as tloss
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, C = 257, 20


def seg_inputs(ties: bool):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(N, C)).astype(np.float32)
    labels = rng.integers(0, C, N)
    labels[rng.random(N) < 0.1] = -1
    if ties:
        # groups of equal rows and labels: equal errors in every class
        logits[::3] = logits[0]
        labels[::3] = labels[0] if labels[0] >= 0 else 4
        logits[1::5] = np.round(logits[1::5])
    return logits, labels


LOSSES = {
    "cross_entropy": {},
    "cross_entropy_smooth_weighted": dict(
        label_smoothing=0.1,
        weight=np.linspace(0.5, 2.0, C).astype(np.float32)),
    "smooth_cross_entropy": {},
    "focal_loss": dict(gamma=2.0, alpha=0.25),
    "dice_loss": {},
    "lovasz_softmax": {},
}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", sorted(LOSSES))
def test_seg_loss_value_and_gradient_match_jax(case, ties):
    name = case.replace("_smooth_weighted", "")
    kw = LOSSES[case]
    logits, labels = seg_inputs(ties)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jf = lambda x: getattr(jloss, name)(x, jnp.asarray(labels), **jkw)
    jv, jg = jax.jit(jax.value_and_grad(jf))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tv = getattr(tloss, name)(x, torch.from_numpy(labels), **tkw)
    tv.backward()
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-6)
    jg = np.asarray(jg)
    assert np.abs(x.grad.numpy() - jg).max() <= 1e-6 * np.abs(jg).max()


def test_lovasz_sorts_equal_errors_stably():
    """Many equal errors: a sort that permutes them moves the Jaccard
    gradient's steps between the tied points; the stable one matches JAX
    entry by entry."""
    logits = np.zeros((64, 3), np.float32)
    labels = np.tile(np.arange(3), 22)[:64]
    labels[5] = -1
    jg = np.asarray(jax.jit(jax.grad(lambda x: jloss.lovasz_softmax(
        x, jnp.asarray(labels))))(jnp.asarray(logits)))
    x = torch.tensor(logits, requires_grad=True)
    tloss.lovasz_softmax(x, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0, atol=1e-7)
    assert len(np.unique(np.round(jg[:, 0], 6))) > 2   # the steps differ


def tree():
    rng = np.random.default_rng(7)
    return {"enc.w": rng.normal(size=(6, 5)).astype(np.float32),
            "enc.b": rng.normal(size=(5,)).astype(np.float32),
            "conv.k": rng.normal(size=(3, 4, 5)).astype(np.float32)}


def run_both(name, steps=5, grad_clip=None, **kw):
    params = tree()
    rng = np.random.default_rng(11)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    sched = dict(total_steps=20, warmup_steps=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jtx = jopt.build_optimizer(name, jopt.make_schedule("cosine", 1e-2,
                                                        **sched),
                               grad_clip=grad_clip, params=jp,
                               no_weight_decay=(".b",), **kw)
    js = jtx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ttx = topt.build_optimizer(name, topt.make_schedule("cosine", 1e-2,
                                                        **sched),
                               grad_clip=grad_clip, params=tp,
                               no_weight_decay=(".b",), **kw)
    ts = ttx.init(tp)
    for g in grads:
        u, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        u, ts = ttx.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
        topt.apply_updates(tp, u)
    return params, {k: np.asarray(v) for k, v in jp.items()}, \
        {k: v.numpy() for k, v in tp.items()}


@pytest.mark.parametrize("name", sorted(jopt._OPTIMIZERS))
def test_optimizer_matches_optax_over_five_updates(name):
    assert sorted(topt._OPTIMIZERS) == sorted(jopt._OPTIMIZERS)
    kw = {} if name == "adafactor" else {"weight_decay": 0.05}
    clip = 1.0 if name == "adamw" else None
    p0, jp, tp = run_both(name, grad_clip=clip, **kw)
    for k in p0:
        assert np.abs(jp[k] - p0[k]).max() > 1e-5, (name, k)   # moved
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=1e-7,
                                   err_msg=f"{name} {k}")


def test_adamw_and_lamb_take_the_decay_mask():
    """The mask (no decay on 1-D tensors and on names with a token) goes
    to adamw and lamb: a large weight decay moves the masked tensors only
    through the gradient."""
    for name in ("adamw", "lamb"):
        _, jp, tp = run_both(name, weight_decay=5.0)
        _, jp0, _ = run_both(name, weight_decay=0.0)
        np.testing.assert_array_equal(jp["enc.b"], jp0["enc.b"])
        for k in tp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["sgd", "sgdp"])
def test_sgd_ignores_weight_decay_as_jax_does(name):
    _, _, plain = run_both(name)
    _, jp, decayed = run_both(name, weight_decay=0.5)
    for k in plain:
        np.testing.assert_array_equal(decayed[k], plain[k])
        np.testing.assert_allclose(decayed[k], jp[k], rtol=1e-6, atol=1e-7)


def test_adafactor_factors_large_tensors_as_optax():
    """A tensor whose second-largest dimension reaches 128 takes the
    factored row and column estimate."""
    rng = np.random.default_rng(2)
    p = {"w": rng.normal(size=(3, 128, 160)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jtx, ttx = jopt.build_optimizer("adafactor", 1e-2), \
        topt.build_optimizer("adafactor", 1e-2)
    js, ts = jtx.init(jp), ttx.init(tp)
    assert ts["0/v_row/w"].shape == (3, 128) and \
        ts["0/v_col/w"].shape == (3, 160)
    for _ in range(3):
        g = rng.normal(size=p["w"].shape).astype(np.float32)
        u, js = jtx.update({"w": jnp.asarray(g)}, js, jp)
        jp = optax.apply_updates(jp, u)
        u, ts = ttx.update({"w": torch.tensor(g)}, ts, tp)
        topt.apply_updates(tp, u)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)


SCHED = dict(total_steps=100, warmup_steps=5, milestones=[30, 60],
             step_size=25, min_lr=1e-4)


@pytest.mark.parametrize("name", ["cosine", "step", "multistep", "poly",
                                  "linear", "constant", "tanh"])
def test_schedule_matches_optax(name):
    w = SCHED["warmup_steps"]
    j = jopt.make_schedule(name, 1e-2, **SCHED)
    t = topt.make_schedule(name, 1e-2, **SCHED)
    # 0, the warm-up's edges, each milestone and step boundary (counted
    # after the warm-up) +-1, and the total
    steps = {0, w - 1, w, w + 1, 100, 130}
    for m in (25, 30, 50, 60):
        steps |= {w + m - 1, w + m, w + m + 1}
    for s in sorted(steps):
        assert t(s) == pytest.approx(float(j(s)), rel=1e-5, abs=1e-12), s
    j0 = jopt.make_schedule(name, 1e-2, **dict(SCHED, warmup_steps=0))
    t0 = topt.make_schedule(name, 1e-2, **dict(SCHED, warmup_steps=0))
    for s in (0, 1, 24, 25, 29, 30, 31, 99, 100):
        assert t0(s) == pytest.approx(float(j0(s)), rel=1e-5, abs=1e-12), s


def test_weight_decay_mask_matches_jax_through_the_name_map():
    """On a narrow SpUNet, JAX's mask (its tree paths) mapped to the
    port's names equals the port's mask of its own ``named_parameters``."""
    kw = dict(num_classes=5, channels=(8, 8, 8, 8, 8, 8, 8, 8),
              layers=(1, 1, 1, 1, 1, 1, 1, 1))
    jmodel = jsp.SpUNet(**kw)
    M = 64
    data = {"coord": jnp.zeros((1, M, 3)), "grid_coord": jnp.zeros(
        (1, M, 3), jnp.int32), "feat": jnp.zeros((1, M, 6)),
        "mask": jnp.ones((1, M), bool), "min_coord": jnp.zeros((1, 3))}
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), data, method=jmodel.forward_point_fusion))
    jparams = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    tokens = ("bn", "conv_input", "final")
    jmask = jopt.weight_decay_mask(jparams, tokens)
    mapped = {k: bool(v) for k, v in jax_to_state_dict(
        jax.tree_util.tree_map(lambda b: np.float32(b), jmask)).items()}
    tmodel = SpUNet(**kw)
    tmask = topt.weight_decay_mask(dict(tmodel.named_parameters()), tokens)
    assert tmask == mapped
    assert any(tmask.values()) and not all(tmask.values())
