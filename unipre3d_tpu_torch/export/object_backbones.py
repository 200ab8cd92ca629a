"""Name-exact torch export/import for pointmlp / pcm / mamba3d.

Counterpart of unipre3d_tpu/export/object_backbones.py, on the nested
numpy trees of ``weights.state_dict_to_jax`` (see torch_export.py).

The downstream fine-tune repos consume the pretrained backbones as torch
state dicts with the reference module names (reference README.md:139-143
model zoo; weights loaded strict=False at model/point_predictor.py:
44-53). The transformer / SparseUNet / PTv3 maps live in
``torch_export.py``; this module covers the remaining three object
backbones via a declarative spec: each entry is
``(torch_prefix, kind, flax_path)`` and a generic walker runs it in
either direction, so export and import cannot drift apart.

Reference naming sources:
* pointmlp — openpoints/models/backbone/pointmlp.py:198-638
  (``embedding.net.*``, ``local_grouper_list.{i}.affine_*``,
  ``pre/pos_blocks_list.{i}.operation.{j}.net1/net2``,
  ``decode_list.{i}.fuse/extraction``).
* mamba3d — openpoints/models/Mamba3D/Mamba3D.py:59-552 +
  bimamba_ssm/modules/mamba_simple.py:60-290 (``encoder.first_conv/
  second_conv``, ``blocks.blocks.{i}.lfa/mixer``, bimamba ``*_b``
  parameter set).
* pcm — openpoints/models/PCM/PCM.py:82-251 + mamba_layer.py:10-94 +
  segmentation/base_seg.py:17-151 (BaseSeg ``encoder./decoder./head.``
  prefixes, ``mamba_blocks_list.{i}.{j}.norm/mixer``,
  ``order_prompt.weight``, per-stage ``pos_proj/order_prompt_proj``).
  The reference decoder's ``gmp_map_list`` is initialized but never
  used in its forward (PCM.py:627-635 vs :663-726), so no keys are
  emitted for it (downstream loads are strict=False).

Tensor conventions as in torch_export.py; the mamba causal-conv weight
``[K, D]`` (taps oldest->newest, ops/scan.py:causal_conv1d) maps to torch
``Conv1d(groups=D)`` weight ``[D, 1, K]`` with the same tap order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from unipre3d_tpu_torch.export.torch_export import (_conv1d_w, _dense_w,
                                                    _np)

Entry = Tuple[str, str, List[str]]


def _get(tree: Dict, path: List[str]):
    node = tree
    for k in path:
        if node is None or k not in node:
            return None
        node = node[k]
    return node


# ---------------------------------------------------------------------------
# generic spec walker
# ---------------------------------------------------------------------------

def _export_entry(sd, t, kind, p_node, s_node):
    if kind == "raw":
        sd[t] = _np(p_node)
    elif kind in ("dense", "dense_nobias"):
        sd[t + ".weight"] = _dense_w(p_node["kernel"])
        if kind == "dense" and "bias" in p_node:
            sd[t + ".bias"] = _np(p_node["bias"])
    elif kind in ("conv1d", "conv1d_nobias"):
        sd[t + ".weight"] = _conv1d_w(p_node["kernel"])
        if kind == "conv1d" and "bias" in p_node:
            sd[t + ".bias"] = _np(p_node["bias"])
    elif kind == "ln":   # LayerNorm / RMSNorm (weight-only when no bias)
        sd[t + ".weight"] = _np(p_node["scale"])
        if "bias" in p_node:
            sd[t + ".bias"] = _np(p_node["bias"])
    elif kind == "bn":
        sd[t + ".weight"] = _np(p_node["scale"])
        sd[t + ".bias"] = _np(p_node["bias"])
        sd[t + ".running_mean"] = _np(s_node["mean"])
        sd[t + ".running_var"] = _np(s_node["var"])
    elif kind == "causal_conv":
        sd[t + ".weight"] = _np(p_node["conv_weight"]).T[:, None, :]
        sd[t + ".bias"] = _np(p_node["conv_bias"])
    elif kind == "dt_proj":
        sd[t + ".weight"] = _dense_w(p_node["dt_proj"]["kernel"])
        sd[t + ".bias"] = _np(p_node["dt_bias"])
    else:  # pragma: no cover
        raise ValueError(kind)


def _import_entry(get, t, kind, p_node, s_node):
    def f32(a):
        return None if a is None else np.asarray(a, np.float32)

    if kind == "raw":
        return f32(get(t))
    if kind in ("dense", "dense_nobias", "conv1d", "conv1d_nobias"):
        w = get(t + ".weight")
        if w is not None:
            p_node["kernel"] = f32(w.reshape(w.shape[0], -1).T)
            b = get(t + ".bias")
            if b is not None and "bias" in p_node:
                p_node["bias"] = f32(b)
    elif kind == "ln":
        w = get(t + ".weight")
        if w is not None:
            p_node["scale"] = f32(w)
            b = get(t + ".bias")
            if b is not None and "bias" in p_node:
                p_node["bias"] = f32(b)
    elif kind == "bn":
        w = get(t + ".weight")
        if w is not None:
            p_node["scale"] = f32(w)
            p_node["bias"] = f32(get(t + ".bias"))
            s_node["mean"] = f32(get(t + ".running_mean"))
            s_node["var"] = f32(get(t + ".running_var"))
    elif kind == "causal_conv":
        w = get(t + ".weight")
        if w is not None:
            p_node["conv_weight"] = f32(w[:, 0, :].T)
            p_node["conv_bias"] = f32(get(t + ".bias"))
    elif kind == "dt_proj":
        w = get(t + ".weight")
        if w is not None:
            p_node["dt_proj"]["kernel"] = f32(w.T)
            p_node["dt_bias"] = f32(get(t + ".bias"))
    else:  # pragma: no cover
        raise ValueError(kind)
    return None


def _run_spec(spec: List[Entry], params: Dict, stats: Dict,
              sd: Optional[Dict] = None, prefix: str = "",
              mode: str = "export") -> Dict[str, np.ndarray]:
    pre = (prefix + ".") if prefix else ""
    out = sd if sd is not None else {}

    def get(name):
        v = out.get(pre + name)
        if v is None:
            return None
        return np.asarray(getattr(v, "numpy", lambda: v)())

    for t, kind, path in spec:
        p_node = _get(params, path)
        if kind == "raw":
            p_parent = _get(params, path[:-1])
            if p_parent is None or path[-1] not in p_parent:
                continue
            if mode == "export":
                out[pre + t] = _np(p_parent[path[-1]])
            else:
                v = get(t)
                if v is not None:
                    p_parent[path[-1]] = np.asarray(v, np.float32)
            continue
        if p_node is None:
            continue
        s_node = _get(stats, path) if kind == "bn" else None
        if mode == "export":
            _export_entry(out, pre + t, kind, p_node, s_node)
        else:
            _import_entry(get, t, kind, p_node, s_node)
    return out


# ---------------------------------------------------------------------------
# shared building blocks (ConvBNReLU1D / ConvBNReLURes1D / Pre / Pos / FP)
# ---------------------------------------------------------------------------

def _cbr(t: str, pp: List[str]) -> List[Entry]:
    """ConvBNReLU1D: Sequential(Conv1d, BN, act) -> net.0 / net.1."""
    return [(t + ".net.0", "conv1d", pp + ["conv"]),
            (t + ".net.1", "bn", pp + ["bn"])]


def _cbr_res(t: str, pp: List[str]) -> List[Entry]:
    """ConvBNReLURes1D (groups=1): net1 = (Conv, BN, act), net2 =
    (Conv, BN)."""
    return [(t + ".net1.0", "conv1d", pp + ["conv1"]),
            (t + ".net1.1", "bn", pp + ["bn1"]),
            (t + ".net2.0", "conv1d", pp + ["conv2"]),
            (t + ".net2.1", "bn", pp + ["bn2"])]


def _res_blocks(params, t: str, pp: List[str]) -> List[Entry]:
    """operation.{j} sequence driven by res{j} key presence."""
    node = _get(params, pp)
    spec: List[Entry] = []
    j = 0
    while node is not None and f"res{j}" in node:
        spec += _cbr_res(f"{t}.operation.{j}", pp + [f"res{j}"])
        j += 1
    return spec


def _pre_extraction(params, t: str, pp: List[str]) -> List[Entry]:
    return _cbr(t + ".transfer", pp + ["transfer"]) + \
        _res_blocks(params, t, pp)


def _feature_prop(params, t: str, pp: List[str]) -> List[Entry]:
    return _cbr(t + ".fuse", pp + ["fuse"]) + \
        _res_blocks(params, t + ".extraction", pp + ["extraction"])


def _mamba_mixer(t: str, pp: List[str]) -> List[Entry]:
    """MambaMixer -> reference Mamba (bimamba v2/v4 parameter set)."""
    spec: List[Entry] = [(t + ".in_proj", "dense_nobias", pp + ["in_proj"])]
    for suf, br in (("", "fwd"), ("_b", "bwd")):
        a_name = ".A_b_log" if suf else ".A_log"
        spec += [
            (t + f".conv1d{suf}", "causal_conv", pp + [br]),
            (t + f".x_proj{suf}", "dense_nobias", pp + [br, "x_proj"]),
            (t + f".dt_proj{suf}", "dt_proj", pp + [br]),
            (t + a_name, "raw", pp + [br, "A_log"]),
            (t + f".D{suf}", "raw", pp + [br, "D"]),
        ]
    spec.append((t + ".out_proj", "dense_nobias", pp + ["out_proj"]))
    return spec


# ---------------------------------------------------------------------------
# pointmlp
# ---------------------------------------------------------------------------

def _pointmlp_spec(params: Dict) -> List[Entry]:
    spec = _cbr("embedding", ["embedding"])
    i = 0
    while f"grouper{i}" in params:
        g = [f"grouper{i}"]
        spec += [(f"local_grouper_list.{i}.affine_alpha", "raw",
                  g + ["affine_alpha"]),
                 (f"local_grouper_list.{i}.affine_beta", "raw",
                  g + ["affine_beta"])]
        spec += _pre_extraction(params, f"pre_blocks_list.{i}", [f"pre{i}"])
        spec += _res_blocks(params, f"pos_blocks_list.{i}", [f"pos{i}"])
        i += 1
    i = 0
    while f"decode{i}" in params:
        spec += _feature_prop(params, f"decode_list.{i}", [f"decode{i}"])
        i += 1
    return spec


def export_pointmlp_backbone(enc_params: Dict, enc_stats: Dict,
                             prefix: str = "") -> Dict[str, np.ndarray]:
    """Our PointMLPEncoder params -> reference pointmlp naming
    (openpoints/models/backbone/pointmlp.py:426-638)."""
    return _run_spec(_pointmlp_spec(enc_params), enc_params, enc_stats,
                     prefix=prefix, mode="export")


def import_pointmlp_backbone(sd: Dict[str, np.ndarray], enc_params: Dict,
                             enc_stats: Dict, prefix: str = "") -> None:
    """Inverse (strict=False: missing keys skipped)."""
    _run_spec(_pointmlp_spec(enc_params), enc_params, enc_stats, sd=sd,
              prefix=prefix, mode="import")


# ---------------------------------------------------------------------------
# mamba3d
# ---------------------------------------------------------------------------

def _mamba3d_spec(params: Dict) -> List[Entry]:
    e = ["encoder"]
    spec: List[Entry] = [
        ("encoder.first_conv.0", "conv1d", e + ["conv1"]),
        ("encoder.first_conv.1", "bn", e + ["bn1"]),
        ("encoder.first_conv.3", "conv1d", e + ["conv2"]),
        ("encoder.second_conv.0", "conv1d", e + ["conv3"]),
        ("encoder.second_conv.1", "bn", e + ["bn2"]),
        ("encoder.second_conv.3", "conv1d", e + ["conv4"]),
        ("cls_token", "raw", ["cls_token"]),
        ("cls_pos", "raw", ["cls_pos"]),
        ("pos_embed.0", "dense", ["pos_embed_fc1"]),
        ("pos_embed.2", "dense", ["pos_embed_fc2"]),
        ("norm", "ln", ["norm"]),
    ]
    i = 0
    while f"block{i}" in params:
        b = [f"block{i}"]
        t = f"blocks.blocks.{i}"
        spec += [
            (t + ".norm1", "ln", b + ["norm1"]),
            (t + ".norm2", "ln", b + ["norm2"]),
            (t + ".lfa.lga.affine_alpha_feat", "raw",
             b + ["lfa", "affine_alpha_feat"]),
            (t + ".lfa.lga.affine_beta_feat", "raw",
             b + ["lfa", "affine_beta_feat"]),
            (t + ".lfa.pre_norm_ft", "ln", b + ["lfa", "pre_norm_ft"]),
            (t + ".lfa.mlp.share_mlp", "conv1d", b + ["lfa", "share_mlp"]),
        ]
        spec += _mamba_mixer(t + ".mixer", b + ["mixer"])
        i += 1
    return spec


def export_mamba3d_backbone(enc_params: Dict, enc_stats: Dict,
                            prefix: str = "") -> Dict[str, np.ndarray]:
    """Our Mamba3DEncoder params -> reference Mamba3DSeg naming
    (openpoints/models/Mamba3D/Mamba3D.py:497-552: encoder / cls_token /
    cls_pos / pos_embed / blocks.blocks.{i} / norm)."""
    return _run_spec(_mamba3d_spec(enc_params), enc_params, enc_stats,
                     prefix=prefix, mode="export")


def import_mamba3d_backbone(sd: Dict[str, np.ndarray], enc_params: Dict,
                            enc_stats: Dict, prefix: str = "") -> None:
    _run_spec(_mamba3d_spec(enc_params), enc_params, enc_stats, sd=sd,
              prefix=prefix, mode="import")


# ---------------------------------------------------------------------------
# pcm (BaseSeg: encoder. / decoder. / head.)
# ---------------------------------------------------------------------------

def _pcm_spec(params: Dict,
              mamba_blocks=(1, 2, 2, 4)) -> List[Entry]:
    enc = params["encoder"]
    spec = [(f"encoder.{t}", k, ["encoder"] + p)
            for t, k, p in _cbr("embedding", ["embedding"])]
    if "order_prompt" in enc:
        spec.append(("encoder.order_prompt.weight", "raw",
                     ["encoder", "order_prompt"]))
    layer = 0
    i = 0
    while f"stage{i}" in enc:
        st = ["encoder", f"stage{i}"]
        spec += [
            (f"encoder.local_grouper_list.{i}.affine_alpha", "raw",
             st + ["grouper", "affine_alpha"]),
            (f"encoder.local_grouper_list.{i}.affine_beta", "raw",
             st + ["grouper", "affine_beta"]),
        ]
        spec += [(f"encoder.{t}", k, ["encoder"] + p) for t, k, p in
                 _pre_extraction(enc, f"pre_blocks_list.{i}",
                                 [f"stage{i}", "pre"])]
        if f"residual_proj{i}" in enc:
            spec.append((f"encoder.residual_proj_blocks_list.{i}",
                         "dense_nobias", ["encoder", f"residual_proj{i}"]))
        if f"pos_proj{i}" in enc:
            spec.append((f"encoder.pos_proj.{i}", "dense_nobias",
                         ["encoder", f"pos_proj{i}"]))
        if f"order_prompt_proj{i}" in enc:
            spec.append((f"encoder.order_prompt_proj.{i}", "dense_nobias",
                         ["encoder", f"order_prompt_proj{i}"]))
        for j in range(mamba_blocks[i]):
            mb = ["encoder", f"mamba{layer}"]
            t = f"encoder.mamba_blocks_list.{i}.{j}"
            spec.append((t + ".norm", "ln", mb + ["norm"]))
            spec += _mamba_mixer(t + ".mixer", mb + ["mixer"])
            layer += 1
        i += 1

    dec = params.get("decoder", {})
    i = 0
    while f"decode{i}" in dec:
        spec += [(f"decoder.{t}", k, ["decoder"] + p) for t, k, p in
                 _feature_prop(dec, f"decode_list.{i}",
                               [f"decode{i}"])]
        i += 1

    if "head" in params:
        spec += [
            ("head.head.0.0", "conv1d_nobias", ["head", "conv0", "conv"]),
            ("head.head.0.1", "bn", ["head", "conv0", "bn"]),
            ("head.head.2.0", "conv1d", ["head", "head"]),
        ]
    return spec


def export_pcm_backbone(params: Dict, stats: Dict, prefix: str = "",
                        mamba_blocks=(1, 2, 2, 4)
                        ) -> Dict[str, np.ndarray]:
    """Our PointMambaSeg params -> reference BaseSeg naming
    (openpoints/models/segmentation/base_seg.py:17-63 with the
    PointMambaEncoder/Decoder/SegHead subtrees). ``params``/``stats``
    are the PointMambaSeg node ({encoder, decoder, head})."""
    return _run_spec(_pcm_spec(params, mamba_blocks), params, stats,
                     prefix=prefix, mode="export")


def import_pcm_backbone(sd: Dict[str, np.ndarray], params: Dict,
                        stats: Dict, prefix: str = "",
                        mamba_blocks=(1, 2, 2, 4)) -> None:
    _run_spec(_pcm_spec(params, mamba_blocks), params, stats, sd=sd,
              prefix=prefix, mode="import")


EXPORTERS = {
    "pointmlp": export_pointmlp_backbone,
    "mamba3d": export_mamba3d_backbone,
    "pcm": export_pcm_backbone,
}
IMPORTERS = {
    "pointmlp": import_pointmlp_backbone,
    "mamba3d": import_mamba3d_backbone,
    "pcm": import_pcm_backbone,
}
