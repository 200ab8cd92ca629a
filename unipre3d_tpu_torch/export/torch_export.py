"""PyTorch checkpoint interop: the port's weights under the reference's
names.

Counterpart of unipre3d_tpu/export/torch_export.py, the same maps on the
same layout. The exporters read the port's weights as the nested numpy
(``params``, ``batch_stats``) trees that ``weights.state_dict_to_jax``
rebuilds from a model's ``state_dict`` (the exact inverse of
``weights.jax_to_state_dict``), so the port's export of a model equals the
JAX package's export of the same parameters bit for bit.

The reference's pretrained backbones are consumed by third-party *torch*
fine-tuning repos (reference docs/OBJECT_LEVEL_DOWNSTREAM_TASKS.md, weights
loaded via ``opt.pretrained_ckpt`` at model/point_predictor.py:44-53,
strict=False):

* :func:`export_transformer_predictor`: name-exact state dict of the
  standard-Transformer backbone (+ final head / image_conv / fusion_mlps)
  matching reference openpoints/models/backbone/transformer.py:247-327
  naming, ready for the downstream repos.
* :func:`import_transformer_backbone`: load a torch transformer checkpoint
  into the trees (the warm start, ``opt.pretrained_ckpt``).
* :func:`export_sparseunet_backbone` / :func:`export_ptv3_backbone` and
  their imports: Pointcept naming for the scene backbones;
  :func:`export_scene_predictor` the whole scene predictor.
* :func:`export_state_dict`: generic flattened export for any backbone
  (dotted flax names, torch tensor conventions).

Conversion rules: Dense kernel [in, out] <-> Linear weight [out, in];
Dense used as 1x1 Conv1d <-> weight [out, in, 1]; Conv HWIO <-> torch
OIHW; LayerNorm/GroupNorm/BatchNorm scale <-> weight; BatchNorm
batch_stats mean/var <-> running_mean/running_var.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _np(x):
    return np.asarray(x)


def _dense_w(kernel):
    return _np(kernel).T  # [in, out] -> [out, in]


def _conv1d_w(kernel):
    return _np(kernel).T[..., None]  # [in, out] -> [out, in, 1]


def _conv2d_w(kernel):
    return np.transpose(_np(kernel), (3, 2, 0, 1))  # HWIO -> OIHW


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, name))
        else:
            out[name] = _np(v)
    return out


def export_state_dict(params: Dict, batch_stats: Optional[Dict] = None,
                      prefix: str = "") -> Dict[str, np.ndarray]:
    """Generic export: flax leaf names with torch tensor conventions."""
    flat = _flatten(params, prefix)
    out = {}
    for name, arr in flat.items():
        if name.endswith(".kernel"):
            base = name[:-7]
            if arr.ndim == 2:
                out[base + ".weight"] = _dense_w(arr)
            elif arr.ndim == 4:
                out[base + ".weight"] = _conv2d_w(arr)
            else:
                out[base + ".weight"] = arr
        elif name.endswith(".scale"):
            out[name[:-6] + ".weight"] = arr
        else:
            out[name] = arr
    if batch_stats:
        for name, arr in _flatten(batch_stats, prefix).items():
            if name.endswith(".mean"):
                out[name[:-5] + ".running_mean"] = arr
            elif name.endswith(".var"):
                out[name[:-4] + ".running_var"] = arr
            else:
                out[name] = arr
    return out


# ---------------------------------------------------------------------------
# transformer: name-exact mapping to the reference module tree
# ---------------------------------------------------------------------------

def _bn(sd, torch_name, p, bs):
    sd[torch_name + ".weight"] = _np(p["scale"])
    sd[torch_name + ".bias"] = _np(p["bias"])
    sd[torch_name + ".running_mean"] = _np(bs["mean"])
    sd[torch_name + ".running_var"] = _np(bs["var"])


def export_transformer_backbone(enc_params: Dict, enc_stats: Dict,
                                prefix: str = "") -> Dict[str, np.ndarray]:
    """Our PointTransformerEncoder params -> reference
    openpoints transformer naming (:247-327)."""
    p = enc_params
    bs = enc_stats
    sd: Dict[str, np.ndarray] = {}
    pre = (prefix + ".") if prefix else ""

    # mini-PointNet Encoder (reference Encoder:210-243)
    e = p["encoder"]
    ebs = bs["encoder"]
    sd[pre + "encoder.first_conv.0.weight"] = _conv1d_w(e["conv1"]["kernel"])
    sd[pre + "encoder.first_conv.0.bias"] = _np(e["conv1"]["bias"])
    _bn(sd, pre + "encoder.first_conv.1", e["bn1"], ebs["bn1"])
    sd[pre + "encoder.first_conv.3.weight"] = _conv1d_w(e["conv2"]["kernel"])
    sd[pre + "encoder.first_conv.3.bias"] = _np(e["conv2"]["bias"])
    sd[pre + "encoder.second_conv.0.weight"] = _conv1d_w(e["conv3"]["kernel"])
    sd[pre + "encoder.second_conv.0.bias"] = _np(e["conv3"]["bias"])
    _bn(sd, pre + "encoder.second_conv.1", e["bn2"], ebs["bn2"])
    sd[pre + "encoder.second_conv.3.weight"] = _conv1d_w(e["conv4"]["kernel"])
    sd[pre + "encoder.second_conv.3.bias"] = _np(e["conv4"]["bias"])

    sd[pre + "reduce_dim.weight"] = _dense_w(p["reduce_dim"]["kernel"])
    sd[pre + "reduce_dim.bias"] = _np(p["reduce_dim"]["bias"])
    sd[pre + "cls_token"] = _np(p["cls_token"])
    sd[pre + "cls_pos"] = _np(p["cls_pos"])
    sd[pre + "pos_embed.0.weight"] = _dense_w(p["pos_embed_fc1"]["kernel"])
    sd[pre + "pos_embed.0.bias"] = _np(p["pos_embed_fc1"]["bias"])
    sd[pre + "pos_embed.2.weight"] = _dense_w(p["pos_embed_fc2"]["kernel"])
    sd[pre + "pos_embed.2.bias"] = _np(p["pos_embed_fc2"]["bias"])

    i = 0
    while f"block{i}" in p:
        b = p[f"block{i}"]
        t = f"{pre}blocks.blocks.{i}."
        for ln in ("norm1", "norm2"):
            sd[t + ln + ".weight"] = _np(b[ln]["scale"])
            sd[t + ln + ".bias"] = _np(b[ln]["bias"])
        sd[t + "attn.qkv.weight"] = _dense_w(b["attn"]["qkv"]["kernel"])
        if "bias" in b["attn"]["qkv"]:
            sd[t + "attn.qkv.bias"] = _np(b["attn"]["qkv"]["bias"])
        sd[t + "attn.proj.weight"] = _dense_w(b["attn"]["proj"]["kernel"])
        sd[t + "attn.proj.bias"] = _np(b["attn"]["proj"]["bias"])
        sd[t + "mlp.fc1.weight"] = _dense_w(b["mlp"]["fc1"]["kernel"])
        sd[t + "mlp.fc1.bias"] = _np(b["mlp"]["fc1"]["bias"])
        sd[t + "mlp.fc2.weight"] = _dense_w(b["mlp"]["fc2"]["kernel"])
        sd[t + "mlp.fc2.bias"] = _np(b["mlp"]["fc2"]["bias"])
        i += 1

    sd[pre + "norm.weight"] = _np(p["norm"]["scale"])
    sd[pre + "norm.bias"] = _np(p["norm"]["bias"])
    return sd


def export_transformer_predictor(params: Dict, batch_stats: Dict
                                 ) -> Dict[str, np.ndarray]:
    """Full GaussianSplatPredictor (transformer backbone) -> reference
    state-dict naming (point_network.encoder.*, point_network.final.*,
    image_conv.*, fusion_mlps.*). VAE weights are not exported (the
    reference loads them from diffusers, never from the ckpt)."""
    pn = params["point_network"]
    pn_bs = batch_stats.get("point_network", {})
    sd = export_transformer_backbone(
        pn["encoder"], pn_bs.get("encoder", {}),
        prefix="point_network.encoder")
    sd["point_network.final.0.weight"] = _dense_w(pn["final"]["fc1"]["kernel"])
    sd["point_network.final.0.bias"] = _np(pn["final"]["fc1"]["bias"])
    sd["point_network.final.2.weight"] = _dense_w(pn["final"]["fc2"]["kernel"])
    sd["point_network.final.2.bias"] = _np(pn["final"]["fc2"]["bias"])
    if "image_conv" in params:
        ic = params["image_conv"]["layers_0"]
        sd["image_conv.0.weight"] = _np(ic["scale"])
        sd["image_conv.0.bias"] = _np(ic["bias"])
        conv = params["image_conv"]["layers_1"]
        sd["image_conv.1.weight"] = _conv2d_w(conv["kernel"])
        sd["image_conv.1.bias"] = _np(conv["bias"])
    if "fusion_mlps" in params and "layers_0" in params["fusion_mlps"]:
        fm = params["fusion_mlps"]["layers_0"]
        sd["fusion_mlps.0.weight"] = _dense_w(fm["kernel"])
        sd["fusion_mlps.0.bias"] = _np(fm["bias"])
    return sd


def import_transformer_backbone(sd: Dict[str, np.ndarray],
                                enc_params: Dict, enc_stats: Dict,
                                prefix: str = "") -> None:
    """Inverse of :func:`export_transformer_backbone`: mutate our param /
    batch_stats dicts in place from a torch state dict (tensors or
    arrays). Missing keys are skipped (reference loads strict=False)."""
    def get(name):
        key = (prefix + "." + name) if prefix else name
        v = sd.get(key)
        if v is None:
            return None
        return np.asarray(getattr(v, "numpy", lambda: v)())

    def put_dense(node, torch_name):
        w = get(torch_name + ".weight")
        if w is None:
            return
        node["kernel"] = w.reshape(w.shape[0], -1).T.astype(np.float32)
        b = get(torch_name + ".bias")
        if b is not None:
            node["bias"] = b.astype(np.float32)

    def put_bn(pnode, snode, torch_name):
        w = get(torch_name + ".weight")
        if w is None:
            return
        pnode["scale"] = w.astype(np.float32)
        pnode["bias"] = get(torch_name + ".bias").astype(np.float32)
        snode["mean"] = get(torch_name + ".running_mean").astype(np.float32)
        snode["var"] = get(torch_name + ".running_var").astype(np.float32)

    e, ebs = enc_params["encoder"], enc_stats["encoder"]
    put_dense(e["conv1"], "encoder.first_conv.0")
    put_bn(e["bn1"], ebs["bn1"], "encoder.first_conv.1")
    put_dense(e["conv2"], "encoder.first_conv.3")
    put_dense(e["conv3"], "encoder.second_conv.0")
    put_bn(e["bn2"], ebs["bn2"], "encoder.second_conv.1")
    put_dense(e["conv4"], "encoder.second_conv.3")
    put_dense(enc_params["reduce_dim"], "reduce_dim")
    for name in ("cls_token", "cls_pos"):
        v = get(name)
        if v is not None:
            enc_params[name] = v.astype(np.float32)
    put_dense(enc_params["pos_embed_fc1"], "pos_embed.0")
    put_dense(enc_params["pos_embed_fc2"], "pos_embed.2")
    i = 0
    while f"block{i}" in enc_params:
        b = enc_params[f"block{i}"]
        t = f"blocks.blocks.{i}."
        for ln in ("norm1", "norm2"):
            w = get(t + ln + ".weight")
            if w is not None:
                b[ln]["scale"] = w.astype(np.float32)
                b[ln]["bias"] = get(t + ln + ".bias").astype(np.float32)
        put_dense(b["attn"]["qkv"], t + "attn.qkv")
        put_dense(b["attn"]["proj"], t + "attn.proj")
        put_dense(b["mlp"]["fc1"], t + "mlp.fc1")
        put_dense(b["mlp"]["fc2"], t + "mlp.fc2")
        i += 1
    w = get("norm.weight")
    if w is not None:
        enc_params["norm"]["scale"] = w.astype(np.float32)
        enc_params["norm"]["bias"] = get("norm.bias").astype(np.float32)


# ---------------------------------------------------------------------------
# scene backbones: name-exact Pointcept state-dict mapping
# ---------------------------------------------------------------------------
#
# spconv 2.x stores conv weights as [out, k0, k1, k2, in] with the
# spatial axes enumerated in grid-coordinate order; our SubMConv kernels
# are [K, Cin, Cout] with K = offsets in the same x-major raster
# (ops/sparse.py:kernel_offsets), so the map is a reshape + transpose.

def _spconv_w(kernel) -> np.ndarray:
    """[K, Cin, Cout] -> spconv2 [Cout, k, k, k, Cin]."""
    arr = _np(kernel)
    K, ci, co = arr.shape
    k = round(K ** (1.0 / 3.0))
    assert k ** 3 == K, K
    return np.transpose(arr.reshape(k, k, k, ci, co), (4, 0, 1, 2, 3))


def _spconv_w_inv(w) -> np.ndarray:
    """spconv2 [Cout, k, k, k, Cin] -> [K, Cin, Cout]."""
    arr = _np(w)
    co, k1, k2, k3, ci = arr.shape
    return np.ascontiguousarray(
        np.transpose(arr, (1, 2, 3, 4, 0)).reshape(k1 * k2 * k3, ci, co))


def _spconv1x1_w(kernel) -> np.ndarray:
    """Dense [Cin, Cout] -> spconv2 k=1 [Cout, 1, 1, 1, Cin]."""
    arr = _np(kernel)
    return arr.T[:, None, None, None, :]


def export_sparseunet_backbone(enc_params: Dict, enc_stats: Dict,
                               prefix: str = "",
                               layers=(2, 3, 4, 6, 2, 2, 2, 2)
                               ) -> Dict[str, np.ndarray]:
    """Our SpUNet params -> Pointcept SpUNet-v1m1 state-dict naming
    (reference pointcept/models/sparse_unet/spconv_unet_v1m1_base.py:
    conv_input/down/enc/up/dec/final, :153-276). These keys are what the
    scene fine-tune repos load, so the paper's headline SparseUNet
    checkpoints flow through unchanged."""
    p, bs = enc_params, enc_stats
    pre = (prefix + ".") if prefix else ""
    sd: Dict[str, np.ndarray] = {}
    n_stages = len(layers) // 2

    sd[pre + "conv_input.0.weight"] = _spconv_w(p["conv_input"]["kernel"])
    _bn(sd, pre + "conv_input.1", p["bn_input"], bs["bn_input"])

    def block(t, b, b_bs):
        sd[t + ".conv1.weight"] = _spconv_w(b["conv1"]["kernel"])
        _bn(sd, t + ".bn1", b["bn1"], b_bs["bn1"])
        sd[t + ".conv2.weight"] = _spconv_w(b["conv2"]["kernel"])
        _bn(sd, t + ".bn2", b["bn2"], b_bs["bn2"])
        if "proj" in b:
            sd[t + ".proj.0.weight"] = _spconv1x1_w(b["proj"]["kernel"])
            _bn(sd, t + ".proj.1", b["proj_bn"], b_bs["proj_bn"])

    for s in range(n_stages):
        sd[pre + f"down.{s}.0.weight"] = _spconv_w(p[f"down{s}"]["kernel"])
        _bn(sd, pre + f"down.{s}.1", p[f"down{s}"]["bn"],
            bs[f"down{s}"]["bn"])
        for i in range(layers[s]):
            block(pre + f"enc.{s}.block{i}", p[f"enc{s}_block{i}"],
                  bs[f"enc{s}_block{i}"])
        sd[pre + f"up.{s}.0.weight"] = _spconv_w(p[f"up{s}"]["kernel"])
        _bn(sd, pre + f"up.{s}.1", p[f"up{s}"]["bn"], bs[f"up{s}"]["bn"])
        for i in range(layers[len(layers) - s - 1]):
            block(pre + f"dec.{s}.block{i}", p[f"dec{s}_block{i}"],
                  bs[f"dec{s}_block{i}"])

    sd[pre + "final.weight"] = _spconv1x1_w(p["final"]["kernel"])
    sd[pre + "final.bias"] = _np(p["final"]["bias"])
    return sd


def import_sparseunet_backbone(sd: Dict[str, np.ndarray],
                               enc_params: Dict, enc_stats: Dict,
                               prefix: str = "",
                               layers=(2, 3, 4, 6, 2, 2, 2, 2)) -> None:
    """Inverse of :func:`export_sparseunet_backbone` (strict=False:
    missing keys are skipped, matching reference point_predictor.py:
    44-53)."""
    def get(name):
        key = (prefix + "." + name) if prefix else name
        v = sd.get(key)
        if v is None:
            return None
        return np.asarray(getattr(v, "numpy", lambda: v)())

    def put_bn(pnode, snode, torch_name):
        w = get(torch_name + ".weight")
        if w is None:
            return
        pnode["scale"] = w.astype(np.float32)
        pnode["bias"] = get(torch_name + ".bias").astype(np.float32)
        snode["mean"] = get(torch_name + ".running_mean").astype(np.float32)
        snode["var"] = get(torch_name + ".running_var").astype(np.float32)

    def put_conv(node, torch_name):
        w = get(torch_name + ".weight")
        if w is not None:
            node["kernel"] = _spconv_w_inv(w).astype(np.float32)

    def put_block(t, b, b_bs):
        put_conv(b["conv1"], t + ".conv1")
        put_bn(b["bn1"], b_bs["bn1"], t + ".bn1")
        put_conv(b["conv2"], t + ".conv2")
        put_bn(b["bn2"], b_bs["bn2"], t + ".bn2")
        if "proj" in b:
            w = get(t + ".proj.0.weight")
            if w is not None:
                b["proj"]["kernel"] = np.ascontiguousarray(
                    w[:, 0, 0, 0, :].T).astype(np.float32)
            put_bn(b["proj_bn"], b_bs["proj_bn"], t + ".proj.1")

    p, bs = enc_params, enc_stats
    n_stages = len(layers) // 2
    put_conv(p["conv_input"], "conv_input.0")
    put_bn(p["bn_input"], bs["bn_input"], "conv_input.1")
    for s in range(n_stages):
        put_conv(p[f"down{s}"], f"down.{s}.0")
        put_bn(p[f"down{s}"]["bn"], bs[f"down{s}"]["bn"], f"down.{s}.1")
        for i in range(layers[s]):
            put_block(f"enc.{s}.block{i}", p[f"enc{s}_block{i}"],
                      bs[f"enc{s}_block{i}"])
        put_conv(p[f"up{s}"], f"up.{s}.0")
        put_bn(p[f"up{s}"]["bn"], bs[f"up{s}"]["bn"], f"up.{s}.1")
        for i in range(layers[len(layers) - s - 1]):
            put_block(f"dec.{s}.block{i}", p[f"dec{s}_block{i}"],
                      bs[f"dec{s}_block{i}"])
    w = get("final.weight")
    if w is not None:
        p["final"]["kernel"] = np.ascontiguousarray(
            w[:, 0, 0, 0, :].T).astype(np.float32)
        p["final"]["bias"] = get("final.bias").astype(np.float32)


def export_ptv3_backbone(enc_params: Dict, enc_stats: Dict,
                         prefix: str = "",
                         enc_depths=(2, 2, 2, 6, 2),
                         dec_depths=(2, 2, 2, 2)) -> Dict[str, np.ndarray]:
    """Our PointTransformerV3 params -> Pointcept PT-v3m1 state-dict
    naming (reference point_transformer_v3m1_base.py:521-534 module
    tree: embedding.stem / enc{s}.down / enc{s}.block{i} /
    dec{s}.up / dec{s}.block{i})."""
    p, bs = enc_params, enc_stats
    pre = (prefix + ".") if prefix else ""
    sd: Dict[str, np.ndarray] = {}

    sd[pre + "embedding.stem.conv.weight"] = _spconv_w(
        p["embedding"]["kernel"])
    _bn(sd, pre + "embedding.stem.norm", p["embedding_bn"],
        bs["embedding_bn"])

    def ln(t, node):
        sd[t + ".weight"] = _np(node["scale"])
        sd[t + ".bias"] = _np(node["bias"])

    def block(t, b, b_bs):
        # cpe: SubMConv3d(bias) -> Linear -> LayerNorm (reference
        # Block:280-290, PointSequential positional names 0/1/2)
        sd[t + ".cpe.0.weight"] = _spconv_w(b["cpe_kernel"])
        sd[t + ".cpe.0.bias"] = _np(b["cpe_bias"])
        sd[t + ".cpe.1.weight"] = _dense_w(b["cpe_fc"]["kernel"])
        sd[t + ".cpe.1.bias"] = _np(b["cpe_fc"]["bias"])
        ln(t + ".cpe.2", b["cpe_norm"])
        ln(t + ".norm1.0", b["norm1"])
        sd[t + ".attn.qkv.weight"] = _dense_w(b["attn"]["qkv"]["kernel"])
        sd[t + ".attn.qkv.bias"] = _np(b["attn"]["qkv"]["bias"])
        sd[t + ".attn.proj.weight"] = _dense_w(b["attn"]["proj"]["kernel"])
        sd[t + ".attn.proj.bias"] = _np(b["attn"]["proj"]["bias"])
        ln(t + ".norm2.0", b["norm2"])
        sd[t + ".mlp.0.fc1.weight"] = _dense_w(b["mlp_fc1"]["kernel"])
        sd[t + ".mlp.0.fc1.bias"] = _np(b["mlp_fc1"]["bias"])
        sd[t + ".mlp.0.fc2.weight"] = _dense_w(b["mlp_fc2"]["kernel"])
        sd[t + ".mlp.0.fc2.bias"] = _np(b["mlp_fc2"]["bias"])

    for s in range(len(enc_depths)):
        if s > 0:
            sd[pre + f"enc.enc{s}.down.proj.weight"] = _dense_w(
                p[f"pool{s}_proj"]["kernel"])
            sd[pre + f"enc.enc{s}.down.proj.bias"] = _np(
                p[f"pool{s}_proj"]["bias"])
            _bn(sd, pre + f"enc.enc{s}.down.norm.0", p[f"pool{s}_bn"],
                bs[f"pool{s}_bn"])
        for i in range(enc_depths[s]):
            block(pre + f"enc.enc{s}.block{i}", p[f"enc{s}_block{i}"],
                  bs.get(f"enc{s}_block{i}", {}))

    for s in range(len(dec_depths)):
        t = pre + f"dec.dec{s}.up"
        sd[t + ".proj.0.weight"] = _dense_w(p[f"unpool{s}_proj"]["kernel"])
        sd[t + ".proj.0.bias"] = _np(p[f"unpool{s}_proj"]["bias"])
        _bn(sd, t + ".proj.1", p[f"unpool{s}_bn"], bs[f"unpool{s}_bn"])
        sd[t + ".proj_skip.0.weight"] = _dense_w(
            p[f"unpool{s}_proj_skip"]["kernel"])
        sd[t + ".proj_skip.0.bias"] = _np(
            p[f"unpool{s}_proj_skip"]["bias"])
        _bn(sd, t + ".proj_skip.1", p[f"unpool{s}_skip_bn"],
            bs[f"unpool{s}_skip_bn"])
        for i in range(dec_depths[s]):
            block(pre + f"dec.dec{s}.block{i}", p[f"dec{s}_block{i}"],
                  bs.get(f"dec{s}_block{i}", {}))
    return sd


def import_ptv3_backbone(sd: Dict[str, np.ndarray],
                         enc_params: Dict, enc_stats: Dict,
                         prefix: str = "",
                         enc_depths=(2, 2, 2, 6, 2),
                         dec_depths=(2, 2, 2, 2)) -> None:
    """Inverse of :func:`export_ptv3_backbone` (strict=False)."""
    def get(name):
        key = (prefix + "." + name) if prefix else name
        v = sd.get(key)
        if v is None:
            return None
        return np.asarray(getattr(v, "numpy", lambda: v)())

    def put_dense(node, torch_name):
        w = get(torch_name + ".weight")
        if w is None:
            return
        node["kernel"] = w.T.astype(np.float32)
        b = get(torch_name + ".bias")
        if b is not None:
            node["bias"] = b.astype(np.float32)

    def put_ln(node, torch_name):
        w = get(torch_name + ".weight")
        if w is not None:
            node["scale"] = w.astype(np.float32)
            node["bias"] = get(torch_name + ".bias").astype(np.float32)

    def put_bn(pnode, snode, torch_name):
        w = get(torch_name + ".weight")
        if w is None:
            return
        pnode["scale"] = w.astype(np.float32)
        pnode["bias"] = get(torch_name + ".bias").astype(np.float32)
        snode["mean"] = get(torch_name + ".running_mean").astype(np.float32)
        snode["var"] = get(torch_name + ".running_var").astype(np.float32)

    def put_block(t, b, b_bs):
        w = get(t + ".cpe.0.weight")
        if w is not None:
            b["cpe_kernel"] = _spconv_w_inv(w).astype(np.float32)
            b["cpe_bias"] = get(t + ".cpe.0.bias").astype(np.float32)
        put_dense(b["cpe_fc"], t + ".cpe.1")
        put_ln(b["cpe_norm"], t + ".cpe.2")
        put_ln(b["norm1"], t + ".norm1.0")
        put_dense(b["attn"]["qkv"], t + ".attn.qkv")
        put_dense(b["attn"]["proj"], t + ".attn.proj")
        put_ln(b["norm2"], t + ".norm2.0")
        put_dense(b["mlp_fc1"], t + ".mlp.0.fc1")
        put_dense(b["mlp_fc2"], t + ".mlp.0.fc2")

    p, bs = enc_params, enc_stats
    w = get("embedding.stem.conv.weight")
    if w is not None:
        p["embedding"]["kernel"] = _spconv_w_inv(w).astype(np.float32)
    put_bn(p["embedding_bn"], bs["embedding_bn"], "embedding.stem.norm")
    for s in range(len(enc_depths)):
        if s > 0:
            put_dense(p[f"pool{s}_proj"], f"enc.enc{s}.down.proj")
            put_bn(p[f"pool{s}_bn"], bs[f"pool{s}_bn"],
                   f"enc.enc{s}.down.norm.0")
        for i in range(enc_depths[s]):
            put_block(f"enc.enc{s}.block{i}", p[f"enc{s}_block{i}"],
                      bs.get(f"enc{s}_block{i}", {}))
    for s in range(len(dec_depths)):
        t = f"dec.dec{s}.up"
        put_dense(p[f"unpool{s}_proj"], t + ".proj.0")
        put_bn(p[f"unpool{s}_bn"], bs[f"unpool{s}_bn"], t + ".proj.1")
        put_dense(p[f"unpool{s}_proj_skip"], t + ".proj_skip.0")
        put_bn(p[f"unpool{s}_skip_bn"], bs[f"unpool{s}_skip_bn"],
               t + ".proj_skip.1")
        for i in range(dec_depths[s]):
            put_block(f"dec.dec{s}.block{i}", p[f"dec{s}_block{i}"],
                      bs.get(f"dec{s}_block{i}", {}))


def export_scene_predictor(params: Dict, batch_stats: Dict,
                           backbone: str) -> Dict[str, np.ndarray]:
    """Full scene GaussianSplatPredictor -> reference naming
    (point_network.encoder.* via the name-exact backbone maps above,
    point_network.final.*, image_conv.*, fusion_mlps.* — reference
    gaussian_predictor.py:192-234)."""
    pn = params["point_network"]
    pn_bs = batch_stats.get("point_network", {})
    exporters = {"sparseunet": export_sparseunet_backbone,
                 "ptv3": export_ptv3_backbone}
    sd = exporters[backbone](pn["encoder"], pn_bs.get("encoder", {}),
                             prefix="point_network.encoder")
    sd["point_network.final.0.weight"] = _dense_w(pn["final"]["fc1"]["kernel"])
    sd["point_network.final.0.bias"] = _np(pn["final"]["fc1"]["bias"])
    sd["point_network.final.2.weight"] = _dense_w(pn["final"]["fc2"]["kernel"])
    sd["point_network.final.2.bias"] = _np(pn["final"]["fc2"]["bias"])
    if "image_conv" in params:
        ic = params["image_conv"]["layers_0"]
        sd["image_conv.0.weight"] = _np(ic["scale"])
        sd["image_conv.0.bias"] = _np(ic["bias"])
        conv = params["image_conv"]["layers_1"]
        sd["image_conv.1.weight"] = _conv2d_w(conv["kernel"])
        sd["image_conv.1.bias"] = _np(conv["bias"])
    if "fusion_mlps" in params:
        # scene fusion_mlps = SubMConv3d + BN + ReLU (reference
        # gaussian_predictor.py:226-234)
        fm = params["fusion_mlps"]
        fm_bs = batch_stats.get("fusion_mlps", {})
        sd["fusion_mlps.0.weight"] = _spconv_w(fm["conv"]["kernel"])
        _bn(sd, "fusion_mlps.1", fm["bn"], fm_bs["bn"])
    return sd


def save_torch_checkpoint(path: str, state_dict: Dict[str, np.ndarray],
                          extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a torch-loadable checkpoint (reference save format:
    {model_state_dict, ...}, train_network.py:200-220)."""
    payload = {"model_state_dict": {
        k: torch.from_numpy(np.ascontiguousarray(v).copy())
        for k, v in state_dict.items()}}
    if extra:
        payload.update(extra)
    torch.save(payload, path)
