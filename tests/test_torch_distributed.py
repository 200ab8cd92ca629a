"""PyTorch port vs the JAX package: distribution over processes.

The port runs one process per rank with explicit collectives
(unipre3d_tpu_torch/parallel/); the JAX package one SPMD program over a
data-sharded global batch. A run on N ranks must equal JAX's data-parallel
step and the port's own one-process run on the same global batch. The
multi-process cases start real OS processes (``subprocess``, as
tests/test_distributed.py does): the workers import torch and the port only,
form a gloo group on 127.0.0.1 at a free port from ``bind(0)`` (several test
processes run at once), and write their results to files the test reads.

Tolerances and reasons (tests/test_parallel.py's):
* loss and PSNR 1e-5 relative, grad norm 1e-4: the ranks' sums reach the
  same values in another order;
* parameters after the step by the mean-divergence rule (< 0.02 lr): Adam
  with eps 1e-15 moves every entry by lr * sign(g) on its first step, so a
  gradient entry at rounding noise may flip sign between two summation
  orders, while a missing or wrong reduction moves a large share of the
  entries by ~lr;
* BatchNorm running statistics 1e-4 relative to each tensor's largest
  (a batch mean of a conv output near zero is a difference of nearly
  cancelling sums; tests/test_torch_scene_step.py).

Settings: the JAX-parity cases take ``drop_path_rate: 0.0``, as every
JAX-parity test of the port does (the two packages draw DropPath's masks
from different generators); DropPath on, and PCM's elementwise SegHead
Dropout, are held two ranks against one process of the port. The CLI case runs at ``opt.base_lr=1e-8``: its val
PSNR is read after two Adam steps, whose sign flips (above) move the val
PSNR by ~1e-3 relative at the default rate; at 1e-8 the two runs' states
agree to rounding and the val PSNR is held at 1e-5.
"""

import json
import math
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch
from unipre3d_tpu.data.loader import Loader as JLoader
from unipre3d_tpu.parallel import make_mesh as jmake_mesh
from unipre3d_tpu.parallel import replicate as jreplicate
from unipre3d_tpu.parallel import shard_batch
from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu.training.config import load_config as jload_config
from unipre3d_tpu_torch import eval as teval
from unipre3d_tpu_torch import parallel
from unipre3d_tpu_torch import train_network
from unipre3d_tpu_torch.data import Loader, SyntheticSceneDataset, collate
from unipre3d_tpu_torch.data import dataset_factory
from unipre3d_tpu_torch.data.draws import batch_rng
from unipre3d_tpu_torch.parallel import distributed as tdist
from unipre3d_tpu_torch.parallel import mesh as tmesh
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.weights import jax_to_state_dict
from test_torch_scene_step import shared_across_workers
from test_torch_utils import (  # noqa: F401
    one_torch_thread, run_dir, trimmed_heap)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
OBJECT = ["data.training_resolution=32", "opt.batch_size=8",
          "data.dataset_root=synthetic", "tpu.raster_tile_capacity=128",
          "opt.ema.update_after_step=1",
          "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
          "layers_per_block: 1}",
          "model.backbone_overrides={depth: 2, drop_path_rate: 0.0}"]
OBJECT_DP = OBJECT[:-1] + [
    "model.backbone_overrides={depth: 2, drop_path_rate: 0.3}"]
SCENE = ["data.training_width=32", "data.training_height=32",
         "data.input_images=2", "data.max_points=1024", "opt.batch_size=2",
         "data.pts_dataset_root=synthetic", "opt.ema.update_after_step=1",
         "tpu.raster_impl_train=pallas_binned",
         "tpu.raster_tile_capacity=1024",
         "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
         "layers_per_block: 1}",
         "model.backbone_overrides={channels: [16, 16, 24, 24, 24, 16, 16, "
         "16], layers: [1, 1, 1, 1, 1, 1, 1, 1], pixel_capacity: 512}"]
CLI = ["--config-name", "transformer_pretraining", "--device", "cpu",
       "opt.iterations=2", "opt.batch_size=4", "opt.base_lr=1e-8",
       "logging.loss_log=1", "tpu.compute_dtype=float32",
       "tpu.vae_cache_entries=0"] + OBJECT[2:3] + OBJECT[0:1] + OBJECT[-2:]
TEST_EXAMPLES = 5            # an odd test split: uneven eval shards
# PCM at full width with one Mamba block a stage (depth cut only); its
# SegHead's elementwise Dropout (0.5) and DropPath (0.1) at their defaults
PCM = ["data.training_resolution=32", "opt.batch_size=4",
       "data.dataset_root=synthetic", "opt.ema.update_after_step=1",
       OBJECT[-2]]
PCM_CUT = dict(mamba_blocks=[1, 1, 1, 1],
               mamba_layers_orders=["xyz", "zyx", "hilbert", "z-trans"])

# One program for every worker; ``mode`` picks the case. It imports torch
# and the port only.
WORKER = r"""
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
a = json.loads(sys.argv[1])
from unipre3d_tpu_torch import parallel
from unipre3d_tpu_torch.parallel import distributed as tdist

assert parallel.maybe_initialize(device="cpu"), "no world formed"
r, w = parallel.process_index(), parallel.process_count()
assert w == 2 and torch.distributed.get_backend() == "gloo"


def unflatten(z):
    out = {}
    for k in z.files:
        head, _, tail = k.partition("/")
        if tail:
            out.setdefault(head, {})[tail] = z[k]
        else:
            out[k] = z[k]
    return out


def rows(batch, lo, hi):
    return {k: rows(v, lo, hi) if isinstance(v, dict) else v[lo:hi]
            for k, v in batch.items()}


def runtime():
    out = {"mean": parallel.all_reduce_mean(float(r * 10))}
    out["weighted"] = parallel.all_reduce_mean(1.0 if r else 4.0,
                                              weight=3.0 if r else 1.0)
    out["weight0"] = parallel.all_reduce_mean(
        123.0 if r == 0 else -7.0, weight=1.0 if r == 0 else 0.0)
    out["all0"] = parallel.all_reduce_mean(5.0, weight=0.0)
    # the differentiable sum and its gradient, only inside synced()
    x = torch.full((3,), float(r + 1), requires_grad=True)
    out["outside"] = float(tdist.sum_across_ranks(x).sum())
    with parallel.synced():
        y = tdist.sum_across_ranks(x)
        (y * (r + 1)).sum().backward()
        mask = tdist.global_rows(
            lambda n: torch.arange(n, dtype=torch.float32), 2)
    out["inside"] = float(y.sum())
    out["grad"] = float(x.grad[0])
    out["rows"] = mask.tolist()
    t = torch.full((2,), float(r))
    tdist.broadcast_(t)
    out["bcast"] = t.tolist()
    return out


def step(config, over, batch, sd, keep_stats=False):
    from unipre3d_tpu_torch.data import batch_to
    from unipre3d_tpu_torch.training import trainer
    from unipre3d_tpu_torch.training.config import load_config
    cfg = load_config(config, overrides=over)
    model, state = trainer.create_train_state(cfg, device="cpu",
                                              state_dict=sd)
    parallel.replicate(model, state)
    n = batch["gt_images"].shape[0] // w
    m = trainer.make_train_step(cfg, model)(
        state, batch_to(rows(batch, r * n, (r + 1) * n), "cpu"))
    res = {f"m|{k}": np.float64(m[k]) for k in ("loss", "psnr",
                                                "grad_norm")}
    for name, p in trainer.split_frozen(model)[0]:
        res[f"p|{name}"] = p.detach().numpy()
    if keep_stats:
        for name, b in model.named_buffers():
            if "running" in name:
                res[f"b|{name}"] = b.numpy()
    return res


def steps():
    batch = unflatten(np.load(a["batch"]))
    sd = None                       # None: every rank's seed-0 init
    if a.get("init"):
        sd = {k: torch.from_numpy(v) for k, v in np.load(a["init"]).items()}
    if a.get("pcm_cut"):
        import functools
        from unipre3d_tpu_torch.models import pcm as tpcm
        tpcm.PointMambaEncoder = functools.partial(tpcm.PointMambaEncoder,
                                                   **a["pcm_cut"])
    res = {}
    for tag, over in a["cases"].items():
        res.update({f"{tag}|{k}": v for k, v in
                    step(a["config"], over, batch, sd, a["stats"]).items()})
    return res


def cli():
    from unipre3d_tpu_torch import eval as teval, train_network
    from unipre3d_tpu_torch.data import dataset_factory
    base = dataset_factory.SyntheticDataset
    dataset_factory.SyntheticDataset = lambda cfg, split, **kw: base(
        cfg, split, num_objects=a["test_examples"] if split == "test"
        else 8, **kw)
    res = train_network.main(a["argv"] + ["--output-dir", a["dirs"][r]])
    torch.distributed.barrier()          # rank 0 has written its run
    scores = teval.main([a["dirs"][0], "--device", "cpu"])
    return {"losses": res["losses"], "grad_norms": res["grad_norms"],
            "val": res["val"][-1]["psnr_novel"], "scores": scores,
            "reduce_ms": res["reduce_ms"]}


out = {"runtime": runtime, "steps": steps, "cli": cli}[a["mode"]]()
if a["mode"] == "steps":
    np.savez(os.path.join(a["out"], f"rank{r}.npz"), **out)
else:
    with open(os.path.join(a["out"], f"rank{r}.json"), "w") as f:
        json.dump(out, f)
print(f"worker {r} OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(args: dict, world: int = 2, timeout: float = 300,
          program: str = WORKER) -> None:
    """Run ``program`` (WORKER) in ``world`` processes of one gloo group;
    each must exit 0 within ``timeout`` seconds."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        env.update({
            "UNIPRE3D_COORDINATOR": f"127.0.0.1:{port}",
            "UNIPRE3D_NUM_PROCESSES": str(world),
            "UNIPRE3D_PROCESS_ID": str(rank), "OMP_NUM_THREADS": "1",
            "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", program, json.dumps(args)], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError("worker timed out:\n" + "\n".join(
            p.communicate()[0][-3000:] for p in procs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} rc={p.returncode}:\n{out}"


def read_json(path, world=2):
    return [json.load(open(os.path.join(path, f"rank{r}.json")))
            for r in range(world)]


def read_npz(path, world=2):
    outs = []
    for r in range(world):
        with np.load(os.path.join(path, f"rank{r}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def flatten(batch):
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def mean_divergence(a: dict, b: dict) -> float:
    num = sum(float(np.abs(a[k] - b[k]).sum()) for k in a)
    return num / sum(a[k].size for k in a)


# --- runtime -----------------------------------------------------------------


def test_two_processes_form_a_world_and_reduce(tmp_path):
    spawn({"mode": "runtime", "out": str(tmp_path)}, timeout=120)
    for r, out in enumerate(read_json(tmp_path)):
        assert out["mean"] == pytest.approx(5.0)
        # (4 * 1 + 1 * 3) / 4: exact for uneven weights
        assert out["weighted"] == pytest.approx(7.0 / 4.0)
        assert out["weight0"] == pytest.approx(123.0)
        assert out["all0"] == 0.0
        assert out["outside"] == 3.0 * (r + 1)          # no collective
        assert out["inside"] == 9.0                      # (1 + 2) x 3
        assert out["grad"] == 3.0                        # 1 + 2
        assert out["rows"] == [2.0 * r, 2.0 * r + 1]     # of arange(4)
        assert out["bcast"] == [0.0, 0.0]


def test_single_process_fallbacks_and_raises(monkeypatch):
    for k in ("UNIPRE3D_DIST", "UNIPRE3D_COORDINATOR",
              "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
              "UNIPRE3D_NUM_PROCESSES", "UNIPRE3D_PROCESS_ID", "RANK",
              "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.maybe_initialize() is False
    assert (parallel.process_index(), parallel.process_count()) == (0, 1)
    assert parallel.all_reduce_mean(3.5, weight=0.0) == 3.5
    x = torch.ones(2)
    with parallel.synced():
        assert tdist.sync_world() == 1
        assert tdist.sum_across_ranks(x) is x
    assert tmesh.make_mesh("cpu") == torch.device("cpu")
    # a requested launch that names no world raises: never one process
    monkeypatch.setenv("UNIPRE3D_DIST", "1")
    with pytest.raises(RuntimeError, match="names no world"):
        tdist.maybe_initialize()
    monkeypatch.delenv("UNIPRE3D_DIST")
    monkeypatch.setenv("UNIPRE3D_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(RuntimeError, match="UNIPRE3D_NUM_PROCESSES"):
        tdist.maybe_initialize()
    assert not torch.distributed.is_initialized()


def test_model_parallel_3_raises_in_a_world_of_4(tmp_path_factory):
    """A world that model_parallel does not divide raises (JAX's assert),
    on every rank of the world of 4 that tests/test_torch_tensor_parallel.py
    spawns once a run; one process is a world of 1, which 2 does not
    divide either."""
    from test_torch_tensor_parallel import tp_world_results
    world = tp_world_results(tmp_path_factory)
    assert all(bool(world[f"rank{r}"]["mp3_raises"]) for r in range(4))
    with pytest.raises(ValueError, match="world of 1"):
        tmesh.make_mesh("cpu", model_parallel=2)
    assert tmesh.make_mesh("cpu", model_parallel=1) == torch.device("cpu")


# --- loader shards -----------------------------------------------------------


class _Draws:
    """37 examples whose reads take the loader's draws."""
    takes_draws = True

    def __len__(self):
        return 37

    def get(self, i, draws):
        return {"x": np.asarray([i]), "d": np.asarray([draws.np_rng.rand()])}


@pytest.mark.parametrize("pad", [True, False])
def test_loader_shard_indices_equal_jax(pad):
    for sid in range(4):
        j = JLoader(_Draws(), 2, shuffle=True, seed=3, shard_id=sid,
                    num_shards=4, pad_shards=pad, num_workers=1)
        t = Loader(_Draws(), 2, seed=3, shard_id=sid, num_shards=4,
                   pad_shards=pad, num_workers=1)
        for epoch in (0, 5):
            np.testing.assert_array_equal(t._order(epoch),
                                          j._epoch_indices(epoch))
        assert t.batches_per_epoch() == len(t._order(0)) // 2
    assert Loader(_Draws(), 2, shard_id=0, num_shards=4).batches_per_epoch() \
        == JLoader(_Draws(), 2, shard_id=0, num_shards=4).batches_per_epoch()


def test_loader_shards_union_is_the_one_process_batch_draws_included():
    """Rank r's batch b holds positions 8b + r + 4j of the padded epoch
    order: the four ranks' batch b, interleaved, is the one-process batch b
    of the global size 8, each example with the same draws."""
    one = Loader(_Draws(), 8, seed=3, num_workers=1)
    shards = [Loader(_Draws(), 2, seed=3, shard_id=r, num_shards=4,
                     num_workers=1) for r in range(4)]
    # 37 examples pad to 40 over 4 shards: the shards' fifth batch holds
    # positions 32-39, which the one process's last (dropped) batch lacks
    assert (one.batches_per_epoch(), shards[0].batches_per_epoch()) == (4, 5)
    for b, (full, *parts) in enumerate(zip(one.epoch(1),
                                           *[s.epoch(1) for s in shards])):
        for k in ("x", "d"):
            inter = np.stack([p[k] for p in parts], 1).reshape(-1, 1)
            np.testing.assert_array_equal(inter, full[k], err_msg=(b, k))
    assert (batch_rng(3, 1, 0, 1).random() != batch_rng(3, 1, 0).random())


# --- the object step ---------------------------------------------------------


def _jax_object_step():
    jcfg = jload_config("transformer_pretraining", overrides=OBJECT)
    batch = _synthetic_batch(jcfg, 8)
    jmodel, tx, jstate = jtrainer.create_train_state(
        jcfg, jax.random.PRNGKey(0), batch)
    init = jax_to_state_dict(np_tree(jstate.params),
                             np_tree(jstate.batch_stats))
    mesh = jmake_mesh(2)
    new, jm = jax.jit(jtrainer.make_train_step(jcfg, jmodel, tx))(
        jreplicate(jstate, mesh),
        shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    return dict(
        init=init, batch={k: torch.from_numpy(v) for k, v in batch.items()},
        jm={k: torch.tensor(float(v)) for k, v in jm.items()},
        jp=jax_to_state_dict(np_tree(new.params)))


@pytest.fixture(scope="module")
def object_steps(tmp_path_factory):
    ref = shared_across_workers(tmp_path_factory, "dist_object_step",
                                _jax_object_step)
    d = tmp_path_factory.mktemp("object_steps")
    np.savez(d / "init.npz", **{k: v.numpy() for k, v in ref["init"].items()})
    np.savez(d / "batch.npz", **{k: v.numpy()
                                 for k, v in ref["batch"].items()})
    spawn({"mode": "steps", "out": str(d), "init": str(d / "init.npz"),
           "batch": str(d / "batch.npz"), "config": "transformer_pretraining",
           "cases": {"dp0": OBJECT, "dp1": OBJECT_DP}, "stats": False})
    return ref, read_npz(d)


def _port_step(config, over, batch, sd):
    """One process of the port on the whole batch (its own rows order)."""
    from unipre3d_tpu_torch.data import batch_to
    from unipre3d_tpu_torch.training import trainer
    cfg = load_config(config, overrides=over)
    model, state = trainer.create_train_state(cfg, device="cpu",
                                              state_dict=sd)
    m = trainer.make_train_step(cfg, model)(state, batch_to(batch, "cpu"))
    return m, {n: p.detach().numpy()
               for n, p in trainer.split_frozen(model)[0]}


def _assert_step(m, params, ref_m, ref_p):
    assert m["loss"] == pytest.approx(ref_m["loss"], rel=1e-5)
    assert m["psnr"] == pytest.approx(ref_m["psnr"], rel=1e-5)
    assert m["grad_norm"] == pytest.approx(ref_m["grad_norm"], rel=1e-4)
    assert set(params) == set(ref_p)
    assert mean_divergence(params, ref_p) < 0.02 * LR


def _rank_result(out, tag):
    m = {k: float(out[f"{tag}|m|{k}"]) for k in ("loss", "psnr",
                                                 "grad_norm")}
    p = {k[len(tag) + 3:]: v for k, v in out.items()
         if k.startswith(f"{tag}|p|")}
    return m, p


def test_object_step_two_ranks_match_jax_data_parallel(object_steps):
    ref, outs = object_steps
    jm = {k: float(v) for k, v in ref["jm"].items()}
    jp = {k: v.numpy() for k, v in ref["jp"].items()}
    (m0, p0), (m1, p1) = (_rank_result(o, "dp0") for o in outs)
    _assert_step(m0, p0, jm, {k: jp[k] for k in p0})
    # every rank took the same update
    assert m0 == m1
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


def test_object_step_with_droppath_two_ranks_match_one_process(object_steps):
    """The global per-sample mask: rank r keeps rows [4r, 4r + 4) of the
    mask of 8 drawn from the shared generator, as the one process does for
    the batch of both ranks' rows."""
    ref, outs = object_steps
    batch = {k: v.numpy() for k, v in ref["batch"].items()}
    m, p = _port_step("transformer_pretraining", OBJECT_DP, batch,
                      ref["init"])
    m_off, _ = _port_step("transformer_pretraining", OBJECT, batch,
                          ref["init"])
    assert abs(m["loss"] - m_off["loss"]) > 1e-4 * m_off["loss"]  # DropPath ran
    for o in outs:
        _assert_step(*_rank_result(o, "dp1"), m, p)


def test_pcm_step_with_dropout_two_ranks_match_one_process(
        tmp_path, monkeypatch):
    """PCM's SegHead Dropout is elementwise, not per sample: rank r keeps
    rows [2r, 2r + 2) of the [4, N, C] mask drawn from the shared
    generator, so two ranks of 2 equal one process on the 4 rows. A mask
    drawn from the local shape repeats rank 0's rows on rank 1 and fails."""
    import functools
    from unipre3d_tpu_torch.models import pcm as tpcm
    batch = _synthetic_batch(jload_config("pcm_pretraining", overrides=PCM),
                             4, n_points=256, n_views=3)
    np.savez(tmp_path / "batch.npz", **batch)
    spawn({"mode": "steps", "out": str(tmp_path),
           "batch": str(tmp_path / "batch.npz"), "config": "pcm_pretraining",
           "cases": {"pcm": PCM}, "stats": False, "pcm_cut": PCM_CUT})
    outs = read_npz(tmp_path)
    monkeypatch.setattr(tpcm, "PointMambaEncoder", functools.partial(
        tpcm.PointMambaEncoder, **PCM_CUT))
    m, p = _port_step("pcm_pretraining", PCM, batch, None)
    monkeypatch.setattr(tpcm, "SegHead", functools.partial(tpcm.SegHead,
                                                           dropout=0.0))
    m_off, _ = _port_step("pcm_pretraining", PCM, batch, None)
    assert abs(m["loss"] - m_off["loss"]) > 1e-4 * m_off["loss"]  # it ran
    for o in outs:
        _assert_step(*_rank_result(o, "pcm"), m, p)


# --- the scene step ----------------------------------------------------------


def _scene_batch():
    cfg = load_config("sparseunet_pretraining", overrides=SCENE)
    ds = SyntheticSceneDataset(cfg, num_scenes=2, seed=0, device="cpu")
    batch = collate([ds[0], ds[1]])
    batch["gt_images"] = np.random.default_rng(1).uniform(
        0, 1, batch["gt_images"].shape).astype(np.float32)
    # the second scene keeps 60% of its points: the shards hold different
    # numbers of valid voxels, which MaskedBatchNorm's global count sees
    mask = batch["point_cloud"]["mask"]
    keep = np.flatnonzero(mask[1])[: int(0.6 * mask[1].sum())]
    mask[1] = False
    mask[1, keep] = True
    return batch


def _jax_scene_step():
    batch = _scene_batch()
    jcfg = jload_config("sparseunet_pretraining", overrides=SCENE)
    jmodel, tx, jstate = jtrainer.create_train_state(
        jcfg, jax.random.PRNGKey(0), batch)
    init = jax_to_state_dict(np_tree(jstate.params),
                             np_tree(jstate.batch_stats))
    mesh = jmake_mesh(2)
    new, jm = jax.jit(jtrainer.make_train_step(jcfg, jmodel, tx))(
        jreplicate(jstate, mesh),
        shard_batch(jax.tree_util.tree_map(jnp.asarray, batch), mesh))
    return dict(
        init=init,
        batch={k: torch.from_numpy(v) for k, v in flatten(batch).items()},
        jm={k: torch.tensor(float(v)) for k, v in jm.items()},
        jp=jax_to_state_dict(np_tree(new.params)),
        jstats=jax_to_state_dict({}, np_tree(new.batch_stats)))


def test_scene_step_two_ranks_uneven_rows_match_jax(tmp_path_factory):
    ref = shared_across_workers(tmp_path_factory, "dist_scene_step",
                                _jax_scene_step)
    d = tmp_path_factory.mktemp("scene_steps")
    np.savez(d / "init.npz", **{k: v.numpy() for k, v in ref["init"].items()})
    batch = {k: v.numpy() for k, v in ref["batch"].items()}
    counts = batch["point_cloud/mask"].sum(1)
    assert counts[1] < 0.7 * counts[0]
    np.savez(d / "batch.npz", **batch)
    spawn({"mode": "steps", "out": str(d), "init": str(d / "init.npz"),
           "batch": str(d / "batch.npz"), "config": "sparseunet_pretraining",
           "cases": {"s": SCENE}, "stats": True})
    outs = read_npz(d)
    jm = {k: float(v) for k, v in ref["jm"].items()}
    jp = {k: v.numpy() for k, v in ref["jp"].items()}
    m, p = _rank_result(outs[0], "s")
    _assert_step(m, p, jm, {k: jp[k] for k in p})
    stats = {k[4:]: v for k, v in outs[0].items() if k.startswith("s|b|")}
    assert set(stats) == set(ref["jstats"]) and len(stats) > 20
    for k, v in ref["jstats"].items():
        v = v.numpy()
        assert np.abs(stats[k] - v).max() <= 1e-4 * max(np.abs(v).max(),
                                                        1e-12), k
        np.testing.assert_array_equal(stats[k], outs[1][f"s|b|{k}"], k)


# --- the CLIs ----------------------------------------------------------------


def test_cli_two_ranks_write_on_rank0_and_match_one_process(
        run_dir, monkeypatch):
    """``train_network.main`` in 2 processes (rank 1 given a directory of
    its own, which must stay empty), then ``eval.main`` over both ranks on
    rank 0's run with 5 test examples (shards of 3 and 2), against the same
    CLIs in one process."""
    os.makedirs(run_dir)
    dirs = [str(run_dir / "rank0"), str(run_dir / "rank1")]
    spawn({"mode": "cli", "out": str(run_dir), "argv": CLI, "dirs": dirs,
           "test_examples": TEST_EXAMPLES})
    outs = read_json(run_dir)
    files = set(os.listdir(dirs[0]))
    assert {"metrics.jsonl", "model_latest.ckpt", "model_best.ckpt",
            ".hydra", "scores.txt", "scores_rank1.txt",
            "test_scores.json"} <= files
    assert os.listdir(dirs[1]) == []
    lines = [open(os.path.join(dirs[0], f)).read().splitlines()
             for f in ("scores.txt", "scores_rank1.txt")]
    assert [len(x) for x in lines] == [3, 2]
    with open(os.path.join(dirs[0], "test_scores.json")) as f:
        two_scores = json.load(f)
    assert outs[0]["scores"] == outs[1]["scores"] == two_scores
    assert len(outs[0]["reduce_ms"]) == 2

    base = dataset_factory.SyntheticDataset
    monkeypatch.setattr(dataset_factory, "SyntheticDataset",
                        lambda cfg, split, **kw: base(
                            cfg, split, num_objects=TEST_EXAMPLES
                            if split == "test" else 8, **kw))
    one = train_network.main(CLI + ["--output-dir", str(run_dir / "one")])
    for o in outs:
        for a, b in zip(o["losses"], one["losses"]):
            assert a == pytest.approx(b, rel=1e-5)
        for a, b in zip(o["grad_norms"], one["grad_norms"]):
            assert a == pytest.approx(b, rel=1e-4)
        assert o["val"] == pytest.approx(one["val"][-1]["psnr_novel"],
                                         rel=1e-5)
    scores = teval.main([dirs[0], "--device", "cpu"])
    for k, v in scores.items():
        if v is None:
            assert two_scores[k] is None, k
        else:
            assert two_scores[k] == pytest.approx(v, rel=1e-5), k
    assert all(math.isfinite(v) for v in scores.values() if v is not None)
