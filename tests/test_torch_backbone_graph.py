"""The object backbone replayed as CUDA graphs (models/backbone_graph.py).

On the CPU:

* the engagement rule keeps the encoder eager on the CPU, in eval mode,
  under ``no_grad``, under ``functional_call`` (the EMA's), at more than
  one data or model rank, with a hook on a module of the region or a
  global module hook, and with an input that carries a gradient, each for
  its own reason; the eager call gives what the encoder called directly
  gives, and nothing is recorded;
* a scene-level forward never reaches the graphs;
* the schedule: the first call with a signature runs eagerly, the second
  captures, the later ones replay without capturing; a new signature
  warms up and then replaces the one record;
* a second call before the replay's backward runs eagerly, a dropped
  replay frees the graphs for the next call, and a backward after a
  later replay raises (the real ``autograd.Function`` over stub graphs);
* the kernels' launch counts: a capture's are taken back off, and each
  replay adds its graph's;
* the fusion's sync-free inverse equals ``torch.linalg.inv`` on the
  fusion's camera matrices.

On the card (``cuda`` marker, skipped without one; no JAX, so it runs
where only PyTorch is installed):

    python -m pytest --noconftest tests/test_torch_backbone_graph.py

four default-run (bf16) training steps of each object backbone, the
transformer at full depth and PointMLP, Mamba3D and PCM cut in depth,
through the graphs and fully eager, from one state and seed, with a
deterministic stand-in for the splat (whose backward sums with float
atomics): the losses, parameters, Adam moments, EMA, BatchNorm running
statistics and the DropPath generator's offset agree within 1e-6 of each
tensor's largest entry (bit for bit where the eager steps repeat
themselves bit for bit; the test prints a second eager run's gaps), and
the hand-written kernels' launch counts (Mamba3D's and PCM's selective
scan) are the eager steps'.
"""

import functools

import pytest
import torch

from unipre3d_tpu_torch import kernels
from unipre3d_tpu_torch.data import SyntheticSceneDataset, batch_to, collate
from unipre3d_tpu_torch.data.synthetic import random_batch
from unipre3d_tpu_torch.models import backbone_graph as bg
from unipre3d_tpu_torch.models import fusion
from unipre3d_tpu_torch.parallel import distributed as dist_lib
from unipre3d_tpu_torch.training import trainer
from unipre3d_tpu_torch.training.config import load_config

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL_VAE = ("model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
             "layers_per_block: 1}")
TINY = ["data.training_resolution=32", "opt.batch_size=2",
        "data.dataset_root=synthetic", SMALL_VAE,
        "model.backbone_overrides={depth: 2}"]
SCENE = ["data.training_width=32", "data.training_height=32",
         "data.input_images=2", "data.max_points=1024", "opt.batch_size=1",
         "data.pts_dataset_root=synthetic", SMALL_VAE]


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reasons(monkeypatch):
    """Every ``why_eager`` verdict, in call order."""
    seen = []
    rule = bg.why_eager

    def record(*args):
        seen.append(rule(*args))
        return seen[-1]

    monkeypatch.setattr(bg, "why_eager", record)
    return seen


def tiny_object():
    cfg = load_config("transformer_pretraining", overrides=TINY)
    model, state = trainer.create_train_state(cfg, device="cpu", seed=0)
    batch = batch_to(random_batch(cfg, batch=2, n_points=256, n_views=5,
                                  seed=0), "cpu")
    return cfg, model, state, batch


def direct_call(model, batch, generator=None):
    """The encoder called directly (the eager path by construction)."""
    feats = model.raw_normalized_features(
        batch["gt_images"][:, 0], None).to(model.dtype)
    return model.point_network.encoder(
        batch["point_cloud"], image_features=feats,
        c2w=batch["view_to_world_transforms"][:, :1],
        fusion_mlp=model.fusion_mlps, intrinsic=model.intrinsic,
        image_proj=model.image_conv.proj_rows, generator=generator)


CASES = {
    "cpu": "not on a CUDA device",
    "eval": "eval mode",
    "no_grad": "grad disabled",
    "functional_call": "parameters substituted (functional_call)",
    "data_ranks": "several ranks",
    "model_ranks": "several ranks",
    "hook": "a module of the region carries a hook",
    "global_hook": "a global module hook",
    "input_grad": "an input carries a gradient",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engagement_rule_keeps_the_call_eager(case, reasons, monkeypatch):
    _, model, state, batch = tiny_object()
    model.train()
    if case == "eval":
        model.eval()
    elif case == "data_ranks":
        monkeypatch.setattr(dist_lib, "data_count", lambda: 2)
    elif case == "model_ranks":
        monkeypatch.setattr(dist_lib, "model_count", lambda: 2)
    elif case == "hook":
        model.point_network.encoder.block0.register_forward_hook(
            lambda *_: None)
    elif case == "input_grad":
        batch["point_cloud"].requires_grad_(True)
    params = state.ema if case == "functional_call" else None
    # the direct call below draws the same DropPath masks again
    gen_state = state.generator.get_state()
    handle = (torch.nn.modules.module.register_module_forward_hook(
        lambda *_: None) if case == "global_hook" else None)
    try:
        with torch.set_grad_enabled(case != "no_grad"):
            out = trainer.predict(model, batch, 1, state.generator,
                                  params=params)
    finally:
        if handle is not None:
            handle.remove()
    assert reasons == [CASES[case]]
    assert len(model.encoder_graphs) == 0
    if params is None:
        state.generator.set_state(gen_state)
        with torch.set_grad_enabled(case != "no_grad"):
            tokens, center = direct_call(model, batch, state.generator)
            head = model.point_network.final(tokens)
        want = model.activate(head, center)
        for k in out:
            torch.testing.assert_close(out[k], want[k], rtol=0, atol=0)


def test_a_cpu_train_step_asks_once_and_stays_eager(reasons):
    # the default train step on the CPU: one verdict, the device's
    cfg, model, state, batch = tiny_object()
    metrics = trainer.make_train_step(cfg, model)(state, batch)
    assert reasons == ["not on a CUDA device"]
    assert metrics["nan_skipped"] == 0.0


def test_a_scene_forward_never_reaches_the_graphs(monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("scene level reached the encoder graphs")

    monkeypatch.setattr(bg.EncoderGraphs, "__call__", refuse)
    cfg = load_config("sparseunet_pretraining", overrides=SCENE)
    ds = SyntheticSceneDataset(cfg, num_scenes=1, seed=0, device="cpu")
    batch = batch_to(collate([ds[0]]), "cpu")
    model, state = trainer.create_train_state(cfg, device="cpu", seed=0)
    metrics = trainer.make_train_step(cfg, model)(state, batch)
    assert metrics["nan_skipped"] == 0.0


def test_schedule_warms_then_captures_then_replays(monkeypatch):
    """The runner's bookkeeping, with the capture and the replay stubbed
    (neither runs on the CPU)."""
    captured, replayed = [], []

    class Rec:
        def __init__(self, tensors):
            self.inputs = {k: torch.empty_like(t) for k, t in
                           tensors.items()}
            self.trainable = []

        def in_flight(self):
            return False

    def capture(encoder, modules, tensors, kwargs, params, buffers,
                generator):
        captured.append(tuple(tensors["pts"].shape))
        return Rec(tensors)

    def replay(rec, *params):
        replayed.append(rec)
        return "replayed"

    monkeypatch.setattr(bg, "why_eager", lambda *_: None)
    monkeypatch.setattr(bg, "capture", capture)
    monkeypatch.setattr(bg._Replay, "apply", replay)
    encoder = torch.nn.Linear(3, 3)
    encoder.forward = lambda pts, generator=None: "eager"
    graphs = bg.EncoderGraphs()
    a, b = torch.full((1, 3), 1.0), torch.full((2, 3), 2.0)
    assert graphs(encoder, (), a) == "eager"
    assert len(graphs) == 0
    assert graphs(encoder, (), a) == "replayed"
    assert graphs(encoder, (), a) == "replayed"
    assert captured == [(1, 3)] and len(replayed) == 2
    assert replayed[0] is replayed[1]
    # the static input holds the call's points
    torch.testing.assert_close(replayed[0].inputs["pts"], a)
    # a new signature warms up while the record replays, then replaces it
    assert graphs(encoder, (), b) == "eager"
    assert graphs(encoder, (), a) == "replayed"
    assert graphs(encoder, (), b) == "replayed"
    assert captured == [(1, 3), (2, 3)] and len(graphs) == 1
    torch.testing.assert_close(replayed[-1].inputs["pts"], b)
    # the first signature was dropped: it warms up again
    assert graphs(encoder, (), a) == "eager"
    assert len(captured) == 2


class StubGraph:
    """Stands in for a ``torch.cuda.CUDAGraph``: a replay runs ``run``."""

    def __init__(self, run):
        self.run = run

    def replay(self):
        self.run()


def stub_record(counter):
    """A ``_Recorded`` over stub graphs on the CPU: the forward writes
    2 x the static points to the output, the backward 3 x the static
    gradient to the parameter's; one launch of ``counter`` each way."""
    pts, out = torch.zeros(4), torch.zeros(4)
    g_out, g_param = torch.zeros(4), torch.zeros(4)
    param = torch.nn.Parameter(torch.zeros(4))
    fwd = StubGraph(lambda: out.copy_(2 * pts))
    bwd = StubGraph(lambda: g_param.copy_(3 * g_out))
    return bg._Recorded(fwd, bwd, {"pts": pts}, (out,), (g_out,), [param],
                        (g_param,), [param], None, {counter: 1},
                        {counter: 1})


def test_a_call_before_the_backward_runs_eagerly(monkeypatch):
    counter = type("Kernel", (), {"launches": 0})()
    rec = stub_record(counter)
    monkeypatch.setattr(bg, "why_eager", lambda *_: None)
    monkeypatch.setattr(bg, "capture", lambda *_: rec)
    encoder = torch.nn.Linear(3, 3)
    encoder.forward = lambda pts, generator=None: "eager"
    graphs = bg.EncoderGraphs()
    pts = torch.arange(4.0)
    assert graphs(encoder, (), pts) == "eager"              # warm-up
    (first,) = graphs(encoder, (), pts)                       # capture
    assert torch.equal(first, 2 * pts) and rec.in_flight()
    # the model run twice in one step: the second call may not overwrite
    # the static output the first one's backward reads
    assert graphs(encoder, (), pts + 1) == "eager"
    first.sum().backward(retain_graph=True)
    assert torch.equal(rec.trainable[0].grad, torch.full((4,), 3.0))
    assert not rec.in_flight()
    (second,) = graphs(encoder, (), pts + 1)
    assert torch.equal(second, 2 * (pts + 1))
    # the first replay's graph again, after a later replay: refused
    with pytest.raises(RuntimeError, match="overwritten"):
        first.sum().backward()
    # a replay dropped without its backward frees the graphs
    del second
    (third,) = graphs(encoder, (), pts)
    assert torch.equal(third, 2 * pts)
    assert counter.launches == 3 + 1      # three forward replays, a backward


def test_a_capture_takes_its_launches_back(monkeypatch):
    monkeypatch.setattr(kernels, "ALL", [])
    k = kernels.CudaKernel("selective_scan", "selective_scan_fwd", 1, 1)
    other = kernels.CudaKernel("selective_scan", "selective_scan_bwd", 1, 1)
    k.launches = 5
    recorded = {}
    with bg._launches_taken_back(recorded):
        k.launches += 2
    assert k.launches == 5 and recorded == {k: 2}
    assert other not in recorded


def test_sync_free_inverse_equals_inv():
    cfg = load_config("transformer_pretraining", overrides=TINY)
    batch = random_batch(cfg, batch=4, n_points=16, n_views=8, seed=3)
    c2w = torch.from_numpy(batch["view_to_world_transforms"][:, 0])
    center = torch.rand(4, 16, 3) - 0.5
    pix, z = fusion.project_points_to_image(center, c2w, torch.eye(3, 4))
    want = torch.linalg.inv(c2w.transpose(-1, -2))
    got = torch.linalg.inv_ex(c2w.transpose(-1, -2)).inverse
    assert torch.equal(got, want)
    hom = torch.cat([center, torch.ones(4, 16, 1)], -1)
    cam = torch.einsum("bij,bnj->bni", want, hom)
    torch.testing.assert_close(z, cam[..., 2], rtol=0, atol=0)


# ---------------------------------------------------------------- card ---

CUT = {
    "pointmlp": ("pointmlp", "PointMLPEncoder",
                 dict(pre_blocks=(1, 1, 1, 1), pos_blocks=(1, 1, 1, 1),
                      de_blocks=(1, 1, 1, 1))),
    "mamba3d": ("gaussian_predictor", "Mamba3DEncoder", dict(depth=2)),
    "pcm": ("pcm", "PointMambaEncoder",
            dict(mamba_blocks=(1, 1, 1, 1),
                 mamba_layers_orders=("xyz", "zyx", "hilbert", "z-trans"))),
}
STEPS, BATCH = 4, 4
# Backbones whose eager step does not repeat itself bit for bit: the
# backward of their neighbour gathers (index_points over kNN indices) sums
# with float atomics, and four eager steps of each, twice, part by up to
# the whole size of a parameter's update. Both arms run them under
# torch's deterministic algorithms (sorted sums).
DETERMINISTIC = ("pointmlp", "mamba3d", "pcm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def stand_in_render(gaussians, batch, cfg, bg_color, stats=None,
                    start_view=None):
    """A deterministic stand-in for the supervision renders: every view
    of a sample one colour, a sigmoid of a fixed projection of the mean
    of its gaussians' fields. The splat's backward sums with float atomics
    in a run-dependent order, so two eager runs of the real step part by
    up to the whole size of a parameter's update within four steps."""
    n_in = int(cfg.data.input_images) if start_view is None else start_view
    rows = torch.cat([gaussians[k].flatten(2).float()
                      for k in sorted(gaussians)], -1)       # [B, N, C]
    w = torch.randn(rows.shape[-1], 3, device=rows.device,
                    generator=torch.Generator(rows.device).manual_seed(7))
    colour = torch.sigmoid((rows @ w).mean(1))               # [B, 3]
    gt = batch["gt_images"][:, n_in:]
    return colour[:, None, :, None, None].expand_as(gt)


def card_steps(backbone, graphed, monkeypatch):
    """STEPS default-run steps from seed 0, the renders stood in for ->
    what the comparison reads."""
    import importlib
    if backbone in CUT:
        mod, name, kw = CUT[backbone]
        mod = importlib.import_module(f"unipre3d_tpu_torch.models.{mod}")
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         **kw))
    monkeypatch.setattr(trainer, "render_supervision_views", stand_in_render)
    over = ["tpu.vae_cache_entries=0", "data.dataset_root=synthetic",
            f"opt.batch_size={BATCH}", SMALL_VAE]
    cfg = load_config(f"{backbone}_pretraining", overrides=over)
    model, state = trainer.create_train_state(
        cfg, device="cuda", seed=0, dtype=trainer.compute_dtype_of(cfg))
    replays = []
    if graphed:
        replay = bg._Replay.apply
        monkeypatch.setattr(bg._Replay, "apply", lambda *a: (
            replays.append(1), replay(*a))[1])
    else:
        monkeypatch.setattr(bg, "why_eager", lambda *_: "the eager arm")
    step = trainer.make_train_step(cfg, model)
    n_in = int(cfg.data.input_images)
    losses = []
    before = [k.launches for k in kernels.ALL]
    torch.use_deterministic_algorithms(backbone in DETERMINISTIC,
                                       warn_only=True)
    try:
        for i in range(STEPS):
            batch = batch_to(random_batch(cfg, batch=BATCH, n_points=1024,
                                          n_views=n_in + 4, seed=i), "cuda")
            losses.append(step(state, batch)["loss"])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    monkeypatch.undo()
    names = [n for n, _ in trainer.split_frozen(model)[0]]
    opt = state.optimizer
    return {
        "graphs": len(model.encoder_graphs), "replays": len(replays),
        "losses": {"loss": torch.tensor(losses, dtype=torch.float64)},
        "params": dict(zip(names, (p.detach().clone()
                                   for p in opt.params))),
        "mu": dict(zip(names, opt.mu)), "nu": dict(zip(names, opt.nu)),
        "ema": state.ema,
        "bn": {n: b.clone() for n, b in model.named_buffers()
               if n.rsplit(".", 1)[-1].startswith("running_")},
        "offset": state.generator.get_offset(),
        "launches": {k.fn_name: k.launches - n for k, n in
                     zip(kernels.ALL, before) if k.launches != n},
    }


def worst_gap(a, b):
    """The largest relative gap of two name -> tensor dicts (each tensor's
    largest difference over its largest magnitude)."""
    return max(float((a[k].float() - b[k].float()).abs().max())
               / max(float(a[k].float().abs().max()), 1e-30) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("backbone",
                         ["transformer", "pointmlp", "mamba3d", "pcm"])
def test_graph_steps_match_eager_steps(cuda, backbone, monkeypatch):
    eager = card_steps(backbone, False, monkeypatch)
    again = card_steps(backbone, False, monkeypatch)
    graphed = card_steps(backbone, True, monkeypatch)
    assert eager["graphs"] == 0 and graphed["graphs"] == 1
    assert graphed["replays"] == STEPS - 1
    assert graphed["offset"] == eager["offset"]
    assert graphed["launches"] == eager["launches"], (graphed["launches"],
                                                      eager["launches"])
    keys = ("losses", "params", "mu", "nu", "ema", "bn")
    gaps = {k: worst_gap(eager[k], graphed[k]) for k in keys}
    control = {k: worst_gap(eager[k], again[k]) for k in keys}
    print(f"{backbone}: largest relative gaps, graph vs eager {gaps}, "
          f"eager vs eager {control}")
    assert all(g <= 1e-6 for g in gaps.values()), (gaps, control)
