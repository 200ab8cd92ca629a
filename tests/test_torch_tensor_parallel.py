"""PyTorch port vs the JAX package: tensor parallelism on a (data, model)
grid.

The JAX package splits the parameters its ``TP_RULES`` match over the
``model`` axis of a 2-D mesh and lets GSPMD insert the collectives; the
port splits them explicitly (Megatron's column and row splits,
unipre3d_tpu_torch/parallel/) and calls the collectives itself. Held here:

* ``tp_matched_paths`` names the same parameters as JAX's on each of the
  six backbones (JAX's trees from ``jax.eval_shape`` of its
  ``create_train_state``, shared with tests/test_torch_export.py; names
  mapped by weights.py's rule): the transformer's five leaves a block,
  PTv3's three, the mixers' two; none for PointMLP and SparseUNet;
* ``shard_state_dict`` / ``gather_state_dict`` round-trip bit for bit, and
  the qkv split is head-aligned;
* one spawned gloo world of 4 CPU processes (built once a run through
  ``shared_across_workers``) runs the grid's collectives, the guards
  (``make_mesh(model_parallel=3)``, ``replicate(require_tp_match=True)``
  on PointMLP, SparseUNet and a renamed module, 6 heads over 4 model
  ranks, a module split over 2 ranks run in the grid of 4), the grid's
  groups formed once per M, and three train steps at 2 x 2, each against the port's one
  process on the same global batch and weights: the depth-2 transformer
  object step (also against JAX's data-parallel step,
  tests/test_torch_distributed.py's reference), a depth-2 Mamba3D step
  (DropPath on, and the scan's operands on a rank checked by the kernels'
  ``in_place`` predicate in a bfloat16 step) and a narrow PTv3 scene step
  (DropPath and the order shuffle on).

Tolerances (tests/test_parallel.py's, as tests/test_torch_distributed.py):
loss 1e-5 and gradient norm 1e-4 relative (the split products and their
sums over ranks reach the same values in another order), the norm against
JAX's data-parallel step 1e-3 (``TOL_JAX_GRAD_NORM``); the parameters
after the step by the mean-divergence rule, < 0.02 lr (Adam's first step
moves every entry by lr x sign(g), which flips on entries at rounding
noise).
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from unipre3d_tpu.parallel.mesh import tp_matched_paths as jtp_matched_paths
from unipre3d_tpu_torch.data import SyntheticSceneDataset, collate
from unipre3d_tpu_torch import dryrun_multichip as dr
from unipre3d_tpu_torch.models import gaussian_predictor as tgp
from unipre3d_tpu_torch.models import mamba3d as tm3
from unipre3d_tpu_torch.models.gaussian_predictor import build_predictor
from unipre3d_tpu_torch.parallel import TP_RULES, tp_matched_paths
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.weights import (gather_state_dict, shard_state_dict,
                                        shard_tensor)
from test_torch_distributed import (LR, OBJECT, _jax_object_step,
                                    mean_divergence, read_npz, spawn)
from test_torch_export import CASES as EXPORT_CASES
from test_torch_export import jax_shapes
from test_torch_scene_step import shared_across_workers
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32 = ["tpu.compute_dtype=float32", "tpu.vae_cache_entries=0"]
OBJECT_TP = OBJECT + F32
MAMBA = ["data.training_resolution=32", "opt.batch_size=4",
         "data.dataset_root=synthetic", "opt.ema.update_after_step=1",
         OBJECT[5]] + F32
MAMBA_CUT = dict(depth=2)     # block 1 at DropPath 0.1
PTV3 = ["data.training_width=32", "data.training_height=32",
        "data.input_images=2", "data.max_points=1024", "opt.batch_size=2",
        "data.pts_dataset_root=synthetic", "opt.ema.update_after_step=1",
        "tpu.raster_impl_train=pallas_binned",
        "tpu.raster_tile_capacity=1024", OBJECT[5],
        "model.backbone_overrides={enc_channels: [32, 32, 32, 32, 32], "
        "enc_num_head: [2, 2, 2, 2, 2], enc_depths: [1, 1, 1, 1, 1], "
        "dec_channels: [32, 32, 32, 32], dec_num_head: [2, 2, 2, 2], "
        "dec_depths: [1, 1, 1, 1], pixel_capacity: 512}"] + F32
BACKBONES = tuple(EXPORT_CASES)
# The grid's gradient norm against JAX's data-parallel step: JAX's own
# tolerance for DP x TP against DP (tests/test_parallel.py:
# test_dp_tp_matches_dp). The port's one-process step is itself 1.16e-4
# from JAX's here, and the port's norm moves by as much with the rows a
# rank holds (one process and 4 ranks of 2 rows 3.57852, 2 ranks of 4 rows
# 3.57808: the group encoder's max-pool near-ties round otherwise), so the
# port against the port holds 1e-4 and against JAX this.
TOL_JAX_GRAD_NORM = 1e-3

# The program of every rank of the world: the port only.
TP_WORKER = r"""
import functools, json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
a = json.loads(sys.argv[1])
from torch import nn
from unipre3d_tpu_torch import dryrun_multichip as dr, parallel
from unipre3d_tpu_torch.models import gaussian_predictor as tgp
from unipre3d_tpu_torch.models import layers as tlayers
from unipre3d_tpu_torch.models import mamba3d as tm3, mamba_mixer
from unipre3d_tpu_torch.ops import scan as tscan
from unipre3d_tpu_torch.parallel import distributed as tdist, tensor as ttp
from unipre3d_tpu_torch import weights as tweights
from unipre3d_tpu_torch.training import trainer
from unipre3d_tpu_torch.training.config import load_config

assert parallel.maybe_initialize(device="cpu"), "no world formed"
r, w = parallel.process_index(), parallel.process_count()
assert w == 4
out = {}


def raises(fn, exc, words):
    try:
        fn()
    except exc as e:
        return all(x in str(e) for x in words)
    return False


def unflatten(z):
    res = {}
    for k in z.files:
        head, _, tail = k.partition("/")
        if tail:
            res.setdefault(head, {})[tail] = z[k]
        else:
            res[k] = z[k]
    return res


# --- the grid and its collectives -------------------------------------------
out["mp3_raises"] = raises(lambda: parallel.make_mesh("cpu", 3), ValueError,
                           ["world of 4", "model_parallel=3"])
parallel.make_mesh("cpu", model_parallel=2)
g = parallel.grid()
out["grid"] = [g.data_index, g.data_count, g.model_index, g.model_count]
t = torch.tensor([float(r + 1)])
out["data_sum"] = float(tdist.all_reduce_sum_(t.clone())[0])
out["model_sum"] = float(tdist.model_all_reduce_(t.clone())[0])
out["mean"] = parallel.all_reduce_mean(float(r))
x = torch.full((2,), float(r + 1), requires_grad=True)
ttp.MODEL_COMM.reset()
ys = [ttp.copy_to_model(x), ttp.reduce_from_model(x), ttp.sum_model(x)]
out["fwd"] = [float(y[0]) for y in ys]
grads = [torch.autograd.grad((y * (r + 1)).sum(), x)[0][0] for y in ys]
out["bwd"] = [float(v) for v in grads]
out["count"] = ttp.MODEL_COMM.count
with parallel.synced():
    s = tdist.sum_across_ranks(x)
    out["synced_sum"] = float(s[0])
    out["synced_grad"] = float(torch.autograd.grad(
        (s * (r + 1)).sum(), x)[0][0])
    out["rows"] = tdist.global_rows(
        lambda n: torch.arange(n, dtype=torch.float32), 2).tolist()

# the trainer's model-group reduction: the replicated gradients averaged
# (rank-dependent here), the split parts' squares summed, the NaN verdict
# agreed
p_rep, p_split = nn.Parameter(torch.zeros(3)), nn.Parameter(torch.zeros(2))
p_split.model_split = (0, 1)
g_rep = torch.full((3,), float(g.model_index + 1))
g_split = torch.full((2,), float(r + 1))
gr, norm, fin = trainer.global_norm([g_rep, g_split], [p_rep, p_split])
out["gn_rep"] = gr[0].tolist()
out["gn_norm"] = float(norm)
out["gn_finite"] = bool(fin)
bad = g_split.clone()
bad[0] = float("nan") if g.model_index == 1 else 1.0
out["gn_nan"] = bool(trainer.global_norm([g_rep, bad], [p_rep, p_split])[2])

# --- the guards ---------------------------------------------------------------
def guard(config, over):
    cfg = load_config(config, overrides=over)
    model, state = trainer.create_train_state(cfg, device="cpu")
    return raises(lambda: parallel.replicate(model, state,
                                             require_tp_match=True),
                  ValueError, ["TP_RULES"])


out["guard_pointmlp"] = guard("pointmlp_pretraining", a["pointmlp"])
out["guard_sparseunet"] = guard("sparseunet_pretraining", a["sparseunet"])
renamed = nn.Module()
renamed.renamed_module = nn.Linear(4, 4)
opt = trainer.AdamW(list(renamed.parameters()), 1e-4, 10, 0.9)
st = trainer.TrainState(0, opt, {}, torch.Generator())
out["guard_renamed"] = raises(lambda: parallel.replicate(
    renamed, st, require_tp_match=True), ValueError, ["TP_RULES"])
parallel.make_mesh("cpu", model_parallel=4)
cfg = load_config("transformer_pretraining", overrides=a["object"])
model, state = trainer.create_train_state(cfg, device="cpu")
out["heads_raise"] = raises(lambda: parallel.replicate(model, state),
                            ValueError, ["heads = 6", "4 model ranks"])
del model, state
# a module split over 2 model ranks, run in the grid of 4
mlp = tlayers.Mlp(8, 16, 8)
for name, dim in (("fc1.weight", 0), ("fc1.bias", 0), ("fc2.weight", 1)):
    p = mlp.get_parameter(name)
    p.data = tweights.shard_tensor(p.data, dim, 1, 0, 2)
out["split_grid_raise"] = raises(lambda: mlp(torch.zeros(1, 8)),
                                 RuntimeError, ["split over 2 model ranks",
                                                "grid of 4"])

# --- the steps at 2 x 2 -------------------------------------------------------
def load(name):
    return unflatten(np.load(os.path.join(a["dir"], name)))


def keep(tag, res):
    for k in ("losses", "grad_norms", "psnrs", "model_allreduces"):
        out[f"{tag}|{k}"] = np.asarray(res[k], np.float64)
    out[f"{tag}|sha1"] = np.frombuffer(
        bytes.fromhex(res["replicated_sha1"]), np.uint8)
    for k, v in res["params"].items():
        out[f"{tag}|p|{k}"] = v


init = {k: torch.from_numpy(v) for k, v in
        np.load(os.path.join(a["dir"], "init.npz")).items()}
keep("object", dr.run_steps(
    load_config("transformer_pretraining", overrides=a["object"]), 2,
    device="cpu", batches=[load("object_batch.npz")], state_dict=init,
    keep_params=True))
tgp.Mamba3DEncoder = functools.partial(tm3.Mamba3DEncoder, **a["mamba_cut"])
keep("mamba3d", dr.run_steps(
    load_config("mamba3d_pretraining", overrides=a["mamba3d"]), 2,
    device="cpu", batches=[load("mamba3d_batch.npz")], keep_params=True))
# the bfloat16 step: every [B, L, W] operand of a rank's scan calls is one
# the kernels read as it is, its channels this rank's d_inner / 2
seen = []
real = mamba_mixer.selective_scan


def hook(u, delta, A, B, C, D=None, z=None, delta_bias=None,
         delta_softplus=False):
    seen.append([tscan.in_place(v) for v in (u, delta, B, C, z)]
                + [u.shape[-1], z.stride(1), str(z.dtype)])
    return real(u, delta, A, B, C, D, z, delta_bias, delta_softplus)


mamba_mixer.selective_scan = hook
dr.run_steps(load_config("mamba3d_pretraining", overrides=a["mamba3d"][:-2]
                         + ["tpu.vae_cache_entries=0"]),
             2, device="cpu", batches=[load("mamba3d_batch.npz")])
mamba_mixer.selective_scan = real
out["scan_ops"] = json.dumps(seen)
keep("ptv3", dr.run_steps(
    load_config("ptv3_pretraining", overrides=a["ptv3"]), 2, device="cpu",
    batches=[load("ptv3_batch.npz")], keep_params=True))
# every make_mesh(model_parallel=2) since the first found its groups
out["grid_reused"] = parallel.grid() is g
np.savez(os.path.join(a["dir"], f"rank{r}.npz"), **{
    k: np.asarray(v) for k, v in out.items()})
print(f"worker {r} OK", flush=True)
"""


def _flat(batch):
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def _tp_world(tmp_path_factory):
    """The world of 4 at 2 x 2 and the one-process runs of the same steps:
    {"rank<i>": each rank's results, "one": the one-process runs', "jax":
    JAX's data-parallel object step}."""
    from __graft_entry__ import _synthetic_batch
    from unipre3d_tpu.training.config import load_config as jload_config
    ref = shared_across_workers(tmp_path_factory, "dist_object_step",
                                _jax_object_step)
    d = tmp_path_factory.mktemp("tp_world")
    np.savez(d / "init.npz", **{k: v.numpy() for k, v in ref["init"].items()})
    batches = {
        "object": {k: v.numpy() for k, v in ref["batch"].items()},
        "mamba3d": _synthetic_batch(jload_config("mamba3d_pretraining",
                                                 overrides=MAMBA), 4),
    }
    ptv3_cfg = load_config("ptv3_pretraining", overrides=PTV3)
    ds = SyntheticSceneDataset(ptv3_cfg, num_scenes=2, seed=0, device="cpu")
    batches["ptv3"] = collate([ds[0], ds[1]])
    for k, b in batches.items():
        np.savez(d / f"{k}_batch.npz", **_flat(b))
    spawn({"dir": str(d), "object": OBJECT_TP, "mamba3d": MAMBA,
           "mamba_cut": MAMBA_CUT, "ptv3": PTV3,
           "pointmlp": EXPORT_CASES["pointmlp"],
           "sparseunet": EXPORT_CASES["sparseunet"]},
          world=4, timeout=600, program=TP_WORKER)
    out = {f"rank{r}": {k: torch.from_numpy(np.asarray(v))
                        for k, v in o.items() if k != "scan_ops"}
           for r, o in enumerate(read_npz(d, world=4))}
    with np.load(d / "rank0.npz") as z:
        scan_ops = str(z["scan_ops"])
    out["rank0"]["scan_ops"] = torch.frombuffer(
        bytearray(scan_ops.encode()), dtype=torch.uint8)
    # the same steps in this one process
    one = {}
    base = tgp.Mamba3DEncoder
    for tag, config, over, sd in (
            ("object", "transformer_pretraining", OBJECT_TP, ref["init"]),
            ("mamba3d", "mamba3d_pretraining", MAMBA, None),
            ("ptv3", "ptv3_pretraining", PTV3, None)):
        if tag == "mamba3d":
            tgp.Mamba3DEncoder = functools.partial(tm3.Mamba3DEncoder,
                                                   **MAMBA_CUT)
        try:
            res = dr.run_steps(load_config(config, overrides=over), 1,
                               device="cpu", batches=[batches[tag]],
                               state_dict=sd, keep_params=True)
        finally:
            tgp.Mamba3DEncoder = base
        one[f"{tag}|losses"] = torch.tensor(res["losses"], dtype=torch.float64)
        one[f"{tag}|grad_norms"] = torch.tensor(res["grad_norms"],
                                                dtype=torch.float64)
        one.update({f"{tag}|p|{k}": torch.from_numpy(v)
                    for k, v in res["params"].items()})
    out["one"] = one
    out["jax"] = {**{f"m|{k}": v for k, v in ref["jm"].items()},
                  **{f"p|{k}": v for k, v in ref["jp"].items()}}
    return out


_WORLD = {}


def tp_world_results(tmp_path_factory):
    """``_tp_world``, computed once a run (tests/test_torch_distributed.py
    reads it too): once across pytest-xdist's workers, once in a
    process."""
    if "world" not in _WORLD:
        _WORLD["world"] = shared_across_workers(
            tmp_path_factory, "tp_world", lambda: _tp_world(tmp_path_factory))
    return _WORLD["world"]


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    return tp_world_results(tmp_path_factory)


def _case(res, tag):
    m = {k: float(res[f"{tag}|{k}"][0]) for k in ("losses", "grad_norms")}
    p = {k[len(tag) + 3:]: v.numpy() for k, v in res.items()
         if k.startswith(f"{tag}|p|")}
    return m, p


def _assert_close(m, p, ref_m, ref_p, tol_gn=1e-4):
    assert m["losses"] == pytest.approx(ref_m["losses"], rel=1e-5)
    assert m["grad_norms"] == pytest.approx(ref_m["grad_norms"], rel=tol_gn)
    assert set(p) == set(ref_p) and len(p) > 10
    assert mean_divergence(p, ref_p) < 0.02 * LR


# --- the rules, and the split of a state dict -------------------------------


@pytest.fixture(scope="module")
def jax_param_shapes(tmp_path_factory):
    return shared_across_workers(tmp_path_factory, "jax_export_shapes",
                                 jax_shapes)


def _port_name(path: str) -> str:
    """A JAX parameter path -> the port's name (weights.py's rule outside
    the VAE, which no rule reaches)."""
    *mods, leaf = path.split("/")
    return ".".join(mods + [{"kernel": "weight", "scale": "weight"}.get(
        leaf, leaf)])


@pytest.mark.parametrize("backbone", BACKBONES)
def test_tp_matched_paths_equal_jax(jax_param_shapes, backbone):
    tree = {}
    for key, shape in jax_param_shapes[f"p:{backbone}"].items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jax.ShapeDtypeStruct(tuple(shape.tolist()), np.float32)
    want = {_port_name(h) for h in jtp_matched_paths(tree)}
    model = build_predictor(load_config(f"{backbone}_pretraining",
                                        overrides=EXPORT_CASES[backbone]))
    got = tp_matched_paths(model)
    assert len(got) == len(set(got))
    assert set(got) == want
    n_leaves = {"transformer": 5 * 2, "mamba3d": 2 * 16, "pcm": 2 * 9,
                "ptv3": 3 * 22, "pointmlp": 0, "sparseunet": 0}[backbone]
    assert len(got) == n_leaves
    names = dict(model.named_parameters())
    for n in got:      # every rule names a leaf it can split
        assert n in names


@pytest.mark.parametrize("M", [2, 3, 6])
def test_shard_and_gather_state_dict_round_trip_bit_for_bit(M):
    cfg = load_config("transformer_pretraining",
                      overrides=OBJECT[:5] + ["model.backbone_overrides="
                                              "{depth: 2}"])
    model = build_predictor(cfg)
    base = tgp.Mamba3DEncoder
    tgp.Mamba3DEncoder = functools.partial(tm3.Mamba3DEncoder, depth=1)
    try:
        mixer_model = build_predictor(load_config(
            "mamba3d_pretraining", overrides=MAMBA[:5]))
    finally:
        tgp.Mamba3DEncoder = base
    for m_ in (model, mixer_model):
        g = torch.Generator().manual_seed(M)
        sd = {k: torch.randn(v.shape, generator=g)
              for k, v in m_.state_dict().items()}
        shards = [shard_state_dict(sd, m, M) for m in range(M)]
        back = gather_state_dict(shards)
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
        assert any(shards[0][k].shape != v.shape for k, v in sd.items())
    # head-aligned: rank m's qkv rows are heads [m H/M, (m+1) H/M) of each
    # of q, k and v ([3][H][hd] rows, 6 heads of 64)
    w = dict(model.named_parameters())[
        "point_network.encoder.block0.attn.qkv.weight"].detach()
    q = w.reshape(3, 6, 64, -1)
    for m in range(M):
        part = shard_tensor(w, 0, 3, m, M).reshape(3, 6 // M, 64, -1)
        assert torch.equal(part, q[:, m * 6 // M:(m + 1) * 6 // M])
    # in_proj: rank m's rows are its channels of x, then of z
    w = dict(mixer_model.named_parameters())[
        "point_network.encoder.block0.mixer.in_proj.weight"].detach()
    xz = w.reshape(2, M, 768 // M, -1)
    for m in range(M):
        assert torch.equal(shard_tensor(w, 0, 2, m, M),
                           xz[:, m].reshape(-1, w.shape[1]))


def test_save_checkpoint_raises_on_a_split_model(tmp_path):
    from unipre3d_tpu_torch.training import checkpoint, trainer
    model = torch.nn.Linear(4, 4)
    opt = trainer.AdamW(list(model.parameters()), 1e-4, 10, 0.9)
    state = trainer.TrainState(0, opt, {}, torch.Generator())
    checkpoint.save_checkpoint(str(tmp_path / "whole.ckpt"), model, state)
    model.weight.model_split = (0, 1)
    with pytest.raises(ValueError, match="gathered_state_dict"):
        checkpoint.save_checkpoint(str(tmp_path / "part.ckpt"), model, state)


def test_an_indivisible_split_raises():
    with pytest.raises(ValueError, match="does not split over 4"):
        shard_tensor(torch.zeros(6 * 3, 5), 0, 3, 0, 4)
    assert [p for p, *_ in TP_RULES][0] == r"attn\.qkv\.weight$"


# --- the world ---------------------------------------------------------------


def test_grid_and_collectives_at_2_by_2(tp_world):
    for r in range(4):
        o = tp_world[f"rank{r}"]
        d, m = divmod(r, 2)
        assert o["grid"].tolist() == [d, 2, m, 2]
        # data group {m, m + 2}, model group {2d, 2d + 1}
        assert float(o["data_sum"]) == (m + 1) + (m + 3)
        assert float(o["model_sum"]) == (2 * d + 1) + (2 * d + 2)
        assert float(o["mean"]) == pytest.approx((m + m + 2) / 2)
        mod = (2 * d + 1) + (2 * d + 2)      # a model group's sum of r + 1
        # copy_to_model: identity forward, sum backward; reduce_from_model
        # the other way round; sum_model both
        assert o["fwd"].tolist() == [r + 1, mod, mod]
        assert o["bwd"].tolist() == [mod, r + 1, mod]
        assert int(o["count"]) == 4
        # the data group's differentiable sum and rows
        assert float(o["synced_sum"]) == (m + 1) + (m + 3)
        assert float(o["synced_grad"]) == (m + 1) + (m + 3)
        assert o["rows"].tolist() == [2.0 * d, 2.0 * d + 1]
        # the trainer's reduction over the model group {2d, 2d + 1}
        assert o["gn_rep"].tolist() == [1.5, 1.5, 1.5]
        sq = 3 * 1.5 ** 2 + 2 * ((2 * d + 1) ** 2 + (2 * d + 2) ** 2)
        assert float(o["gn_norm"]) == pytest.approx(sq ** 0.5, rel=1e-6)
        assert bool(o["gn_finite"]) and not bool(o["gn_nan"])


def test_grid_groups_are_formed_once_per_model_count(tp_world):
    """make_mesh(model_parallel=2) after a grid of 4 and between the runs
    finds the groups it formed first (form_grid keeps them by M)."""
    for r in range(4):
        assert bool(tp_world[f"rank{r}"]["grid_reused"])


def test_a_split_module_raises_in_another_grid(tp_world):
    """An Mlp split over 2 model ranks raises in the grid of 4: its sums
    would span the wrong ranks (split_ranks reads M off the weight)."""
    for r in range(4):
        assert bool(tp_world[f"rank{r}"]["split_grid_raise"])


def test_guards_raise(tp_world):
    """replicate(require_tp_match=True) raises naming TP_RULES where no
    rule matches (PointMLP, SparseUNet, a renamed module); 6 heads do not
    split over 4 model ranks (no padding, unlike GSPMD)."""
    for r in range(4):
        o = tp_world[f"rank{r}"]
        for k in ("guard_pointmlp", "guard_sparseunet", "guard_renamed",
                  "heads_raise", "mp3_raises"):
            assert bool(o[k]), k


def test_transformer_step_2_by_2_matches_one_process_and_jax(tp_world):
    one_m, one_p = _case(tp_world["one"], "object")
    jax_m = {"losses": float(tp_world["jax"]["m|loss"]),
             "grad_norms": float(tp_world["jax"]["m|grad_norm"])}
    jax_p = {k[2:]: v.numpy() for k, v in tp_world["jax"].items()
             if k.startswith("p|")}
    ranks = [_case(tp_world[f"rank{r}"], "object") for r in range(4)]
    for r, (m, p) in enumerate(ranks):
        assert m == ranks[0][0]
        # the replicated parameters after the step: the same on every rank
        assert torch.equal(tp_world[f"rank{r}"]["object|sha1"],
                           tp_world["rank0"]["object|sha1"])
        _assert_close(m, p, one_m, one_p)
        _assert_close(m, p, jax_m, {k: jax_p[k] for k in p},
                      tol_gn=TOL_JAX_GRAD_NORM)
    # 2 blocks x (2 forward + 2 backward) + the gradient norm's
    assert tp_world["rank0"]["object|model_allreduces"].tolist() == [9]


def test_mamba3d_step_2_by_2_matches_one_process(tp_world):
    import json
    one_m, one_p = _case(tp_world["one"], "mamba3d")
    for r in range(4):
        _assert_close(*_case(tp_world[f"rank{r}"], "mamba3d"), one_m, one_p)
    # 2 blocks x (x_proj's sum x 2 directions + out_proj, forward and
    # backward, with in_proj's backward) + the gradient norm's
    assert tp_world["rank0"]["mamba3d|model_allreduces"].tolist() == [13]
    ops = json.loads(bytes(tp_world["rank0"]["scan_ops"].numpy()).decode())
    assert len(ops) == 4      # 2 blocks, 2 directions
    for i, flags in enumerate(ops):
        assert flags[:5] == [True] * 5        # u, delta, B, C, z in place
        assert flags[5] == 384                # d_inner 768 over 2 ranks
        assert flags[7] == "torch.bfloat16"
        if i % 2 == 0:    # the forward direction's z: a view of in_proj's
            assert flags[6] == 2 * 384


def test_ptv3_step_2_by_2_matches_one_process(tp_world):
    one_m, one_p = _case(tp_world["one"], "ptv3")
    for r in range(4):
        _assert_close(*_case(tp_world[f"rank{r}"], "ptv3"), one_m, one_p)
    # 9 blocks x (proj's sum forward, qkv's input backward) + the norm's
    assert tp_world["rank0"]["ptv3|model_allreduces"].tolist() == [19]
