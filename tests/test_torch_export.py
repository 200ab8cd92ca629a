"""PyTorch port vs the JAX package: export under the reference's torch
names, its import, the warm start and the export CLI.

For each of the six backbones the JAX parameter tree comes from the JAX
package's ``create_train_state`` at a small width (its shapes through
``jax.eval_shape``, once a run, so nothing compiles; its values random
from a seed, so every tensor differs from every other), goes through
``weights.jax_to_state_dict`` into the port's model, and comes back out of
the model's ``state_dict``. Held bit for bit (these are copies and
transposes, no arithmetic):

* ``weights.state_dict_to_jax`` inverts ``jax_to_state_dict``: the same
  tree, leaf for leaf;
* the port's export equals JAX's, key for key, dtype and bits: the whole
  transformer predictor, the scene predictor of SparseUNet and PTv3, the
  encoder of PointMLP, Mamba3D and PCM under ``point_network.encoder``, and
  the generic ``export_state_dict`` of every backbone, whose VAE keys keep
  flax's names;
* the port's import inverts its export, and equals JAX's import of the
  same state dict;
* the warm start (``train_network.warm_start``) leaves the model's
  parameters, BatchNorm statistics and EMA where JAX's
  ``import_transformer_backbone`` puts its trees, from a whole checkpoint
  and from one that lacks some keys (strict=False);
* the export CLI on a two-step CPU run: EMA weights by default, the raw
  parameters with ``--no-ema``, the generic export with ``--full``.

Small widths: tiny VAE, transformer depth 2, SparseUNet 8 channels a stage
and PTv3 16 (the scene exporters take the published depths, so depth stays);
PointMLP, Mamba3D and PCM at full width (their predictors read no
overrides). Also the CLI's raises for ``data.mix_prob > 0`` and for
``opt.pretrained_ckpt`` on a missing file or another backbone.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch
from unipre3d_tpu import export as jexport
from unipre3d_tpu.export import object_backbones as jobject
from unipre3d_tpu.training import trainer as jtrainer
from unipre3d_tpu.training.config import load_config as jload_config
from unipre3d_tpu_torch import export as texport
from unipre3d_tpu_torch import export_checkpoint, train_network
from unipre3d_tpu_torch.data import SyntheticSceneDataset, collate
from unipre3d_tpu_torch.training import checkpoint as ckpt_lib
from unipre3d_tpu_torch.training import trainer
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.weights import jax_to_state_dict, state_dict_to_jax
from test_torch_scene_step import shared_across_workers
from test_torch_utils import one_torch_thread, trimmed_heap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY_VAE = ("model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
            "layers_per_block: 1}")
OBJECT = ["data.training_resolution=32", "opt.batch_size=1",
          "data.dataset_root=synthetic", TINY_VAE]
SCENE = ["data.training_width=32", "data.training_height=32",
         "data.input_images=2", "data.max_points=1024", "opt.batch_size=1",
         "data.pts_dataset_root=synthetic", TINY_VAE]
CASES = {
    "transformer": OBJECT + ["model.backbone_overrides={depth: 2}"],
    "pointmlp": OBJECT,
    "mamba3d": OBJECT,
    "pcm": OBJECT,
    "sparseunet": SCENE + ["model.backbone_overrides={channels: "
                           "[8, 8, 8, 8, 8, 8, 8, 8]}"],
    "ptv3": SCENE + ["model.backbone_overrides={enc_channels: "
                     "[32, 16, 16, 16, 16], enc_num_head: [2, 1, 1, 1, 1], "
                     "dec_channels: [16, 16, 16, 16], "
                     "dec_num_head: [1, 1, 1, 1]}"],
}
BACKBONES = tuple(CASES)
PREFIX = "point_network.encoder"
RUN = ["--config-name", "transformer_pretraining", "--device", "cpu",
       "data.dataset_root=synthetic", "data.training_resolution=32",
       "opt.batch_size=2", "opt.ema.update_after_step=0",
       "opt.ema.update_every=1", "opt.ema.beta=0.5", "logging.val_log=100",
       TINY_VAE, "model.backbone_overrides={depth: 2}"]


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def unflat(d):
    tree = {}
    for key, v in d.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return tree


def jax_shapes():
    """{group: {key: shape}}: the shapes of each backbone's params
    (``p:<b>``) and batch_stats (``s:<b>``), ``/``-joined keys, every leaf
    float32."""
    out = {}
    for b, over in CASES.items():
        jcfg = jload_config(f"{b}_pretraining", overrides=over)
        if b in ("sparseunet", "ptv3"):
            tcfg = load_config(f"{b}_pretraining", overrides=over)
            batch = collate([SyntheticSceneDataset(tcfg, num_scenes=1, seed=0,
                                                   device="cpu")[0]])
        else:
            batch = _synthetic_batch(jcfg, 1)
        shapes = jax.eval_shape(
            lambda k: (lambda s: (s.params, s.batch_stats))(
                jtrainer.create_train_state(jcfg, k, batch)[2]),
            jax.random.PRNGKey(0))
        for tag, tree in zip("ps", shapes):
            leaves = dict(flat(tree))
            assert all(v.dtype == np.float32 for v in leaves.values())
            out[f"{tag}:{b}"] = {k: torch.tensor(v.shape, dtype=torch.int64)
                                 for k, v in leaves.items()}
    return out


def random_tree(shapes, seed):
    """Random float32 values of the given shapes, drawn in key order."""
    rng = np.random.default_rng(seed)
    return unflat({k: rng.normal(size=tuple(shapes[k].tolist())).astype(
        np.float32) for k in sorted(shapes)})


class Models(dict):
    """backbone -> (JAX params, JAX batch_stats, the port's model holding
    them), each model built when a test first asks for it (a worker builds
    only the ones its tests take)."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes = shapes

    def __missing__(self, b):
        i = BACKBONES.index(b)
        p = random_tree(self.shapes[f"p:{b}"], 2 * i)
        s = random_tree(self.shapes[f"s:{b}"], 2 * i + 1)
        model, _ = trainer.create_train_state(
            load_config(f"{b}_pretraining", overrides=CASES[b]),
            device="cpu", state_dict=jax_to_state_dict(p, s))
        self[b] = (p, s, model)
        return self[b]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return Models(shared_across_workers(tmp_path_factory, "jax_export_shapes",
                                        jax_shapes))


def jax_export(b, p, s):
    """The JAX package's export of a backbone's trees, dispatched as its
    export_checkpoint.py does."""
    if b == "transformer":
        return jexport.export_transformer_predictor(p, s)
    if b in ("sparseunet", "ptv3"):
        return jexport.export_scene_predictor(p, s, b)
    return jobject.EXPORTERS[b](p["point_network"]["encoder"],
                                s.get("point_network", {}).get("encoder", {}),
                                prefix=PREFIX)


def assert_same(got, want):
    """Two reference-named state dicts: same keys, dtypes, shapes and bits."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("backbone", BACKBONES)
def test_state_dict_to_jax_inverts_jax_to_state_dict(models, backbone):
    p, s, model = models[backbone]
    p2, s2 = state_dict_to_jax(model.state_dict())
    assert_same(dict(flat(p2)), dict(flat(p)))
    assert_same(dict(flat(s2)), dict(flat(s)))


@pytest.mark.parametrize("backbone", BACKBONES)
def test_export_matches_jax_bit_for_bit(models, backbone):
    p, s, model = models[backbone]
    want = jax_export(backbone, p, s)
    got = texport.export_predictor(model.state_dict(), backbone)
    assert_same(got, want)
    assert len(got) > 50
    if backbone in ("pointmlp", "mamba3d", "pcm"):
        assert all(k.startswith(PREFIX + ".") for k in got)
    else:
        assert "point_network.final.0.weight" in got
        assert "image_conv.1.weight" in got


@pytest.mark.parametrize("backbone", BACKBONES)
def test_generic_export_matches_jax_with_flax_vae_names(models, backbone):
    p, s, model = models[backbone]
    want = jexport.export_state_dict(p, s)
    got = texport.export_predictor(model.state_dict(), backbone, full=True)
    assert_same(got, want)
    vae = [k for k in got if k.startswith("image_network.")]
    assert len(vae) > 50
    assert any("down_0_resnet_0" in k for k in vae)
    assert any(".mid.attentions_0.to_out." in k for k in vae)
    assert not any("down_blocks" in k or "mid_block" in k for k in vae)


IMPORTS = {
    "transformer": (texport.import_transformer_backbone,
                    jexport.import_transformer_backbone),
    "sparseunet": (texport.import_sparseunet_backbone,
                   jexport.import_sparseunet_backbone),
    "ptv3": (texport.import_ptv3_backbone, jexport.import_ptv3_backbone),
    **{b: (texport.IMPORTERS[b], jobject.IMPORTERS[b])
       for b in ("pointmlp", "mamba3d", "pcm")},
}


@pytest.mark.parametrize("backbone", BACKBONES)
def test_import_inverts_export_and_equals_jax_import(models, backbone):
    """The export of the port's model imported into trees of ones (torch
    tensors, as a loaded checkpoint holds them) restores every encoder
    leaf; JAX's import of the same state dict gives the same trees."""
    p, s, model = models[backbone]
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          texport.export_predictor(model.state_dict(), backbone).items()}
    port_import, jax_import = IMPORTS[backbone]
    enc_p = p["point_network"]["encoder"]
    enc_s = s.get("point_network", {}).get("encoder", {})
    clones = []
    for fn in (port_import, jax_import):
        cp = unflat({k: np.ones_like(v) for k, v in flat(enc_p)})
        cs = unflat({k: np.ones_like(v) for k, v in flat(enc_s)})
        fn(sd, cp, cs, prefix=PREFIX)
        clones.append((dict(flat(cp)), dict(flat(cs))))
    (tp, ts), (jp, js) = clones
    assert_same(tp, dict(flat(enc_p)))
    assert_same(ts, dict(flat(enc_s)))
    assert_same(tp, jp)
    assert_same(ts, js)


@pytest.mark.parametrize("partial", [False, True])
def test_warm_start_equals_jax_import(models, tmp_path, partial):
    """A reference-named checkpoint of one transformer (the random trees)
    warm-starts a model of other weights: its backbone, BatchNorm
    statistics and EMA then equal JAX's import into its own trees. Keys the
    checkpoint lacks (the partial case drops block 1 and the first
    BatchNorm) keep the model's values."""
    p, s, _ = models["transformer"]
    sd = jexport.export_transformer_predictor(p, s)
    if partial:
        sd = {k: v for k, v in sd.items()
              if ".blocks.blocks.1." not in k and "first_conv.1." not in k}
    path = str(tmp_path / "backbone.pth")
    jexport.save_torch_checkpoint(path, sd, extra={"iteration": 3})
    cfg = load_config("transformer_pretraining",
                      overrides=CASES["transformer"])
    model, state = trainer.create_train_state(cfg, device="cpu", seed=7)
    q, qs = state_dict_to_jax(model.state_dict())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n = train_network.warm_start(model, state, path)
    assert n == sum(k.startswith(PREFIX + ".") for k in sd)
    loaded = torch.load(path, weights_only=False)["model_state_dict"]
    jexport.import_transformer_backbone(
        {k: v.numpy() for k, v in loaded.items()},
        q["point_network"]["encoder"], qs["point_network"]["encoder"],
        prefix=PREFIX)
    want = jax_to_state_dict(q, qs)
    got = model.state_dict()
    assert set(got) == set(want)
    changed = 0
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        changed += not torch.equal(got[k], before[k])
    assert changed == n
    if partial:
        assert torch.equal(
            got[PREFIX + ".block1.mlp.fc1.weight"],
            before[PREFIX + ".block1.mlp.fc1.weight"])
    for name, param in trainer.split_frozen(model)[0]:
        assert torch.equal(state.ema[name], param), name


def test_export_cli_ema_raw_and_full(tmp_path):
    """Two CPU steps with an EMA that decays every step (beta 0.5), then
    the export CLI: the default ``.pth`` is the export of the checkpoint's
    model with the EMA in place of its trainable parameters, ``--no-ema``
    the export of the model itself, ``--full`` the generic export."""
    run = str(tmp_path / "run")
    train_network.main(RUN + ["--output-dir", run, "opt.iterations=2"])
    cfg = load_config("transformer_pretraining", overrides=RUN[4:])
    model, state = trainer.create_train_state(cfg, device="cpu", seed=3)
    ckpt_lib.load_checkpoint(os.path.join(run, "model_latest.ckpt"), model,
                             state)
    raw = model.state_dict()
    ema = {**raw, **state.ema}
    files = {}
    for flag in ("", "--no-ema", "--full"):
        out = str(tmp_path / f"export{flag}.pth")
        assert export_checkpoint.main(
            [run, "--out", out] + ([flag] if flag else [])) == out
        files[flag] = torch.load(out, weights_only=False)
        assert files[flag]["iteration"] == 2
        assert files[flag]["backbone"] == "transformer"
    for flag, sd, full in (("", ema, False), ("--no-ema", raw, False),
                           ("--full", ema, True)):
        got = {k: v.numpy() for k, v in
               files[flag]["model_state_dict"].items()}
        assert_same(got, texport.export_predictor(sd, "transformer", full))
    key = PREFIX + ".blocks.blocks.0.attn.qkv.weight"
    assert not torch.equal(files[""]["model_state_dict"][key],
                           files["--no-ema"]["model_state_dict"][key])
    assert not os.path.exists(os.path.join(run, "model_torch_export.pth"))
    export_checkpoint.main([run])
    assert os.path.exists(os.path.join(run, "model_torch_export.pth"))
    shutil.rmtree(run)          # the suite's temporary files stay small


@pytest.mark.parametrize("case", ["mix_prob", "missing_ckpt",
                                  "other_backbone"])
def test_cli_raises(tmp_path, case):
    over, err = {
        "mix_prob": (["data.mix_prob=0.5"], "mix_prob > 0 is unsupported"),
        "missing_ckpt": ([f"opt.pretrained_ckpt={tmp_path / 'none.pth'}"],
                         "opt.pretrained_ckpt: no file"),
    }.get(case, (None, None))
    config = "transformer_pretraining"
    if case == "other_backbone":
        path = tmp_path / "b.pth"
        path.write_bytes(b"")
        over = [f"opt.pretrained_ckpt={path}"]
        err = "transformer backbone only"
        config = "pointmlp_pretraining"
    with pytest.raises((ValueError, FileNotFoundError), match=err):
        train_network.main(["--config-name", config, "--device", "cpu",
                            "--output-dir", str(tmp_path / "run")] + over)
