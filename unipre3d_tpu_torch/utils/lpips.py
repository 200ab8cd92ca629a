"""LPIPS perceptual distance (VGG16 variant).

Counterpart of unipre3d_tpu/utils/lpips.py, the ``lpips.LPIPS(net="vgg")``
module the reference uses for its perceptual loss and eval metric
(reference train_network.py:224-231, 292-296; eval.py Metricator):
input-scaling layer, torchvision-VGG16 trunk tapped at relu1_2 / relu2_2
/ relu3_3 / relu4_3 / relu5_3, features unit-normalized over channels,
learned non-negative per-channel weights, spatial mean, sum over the taps.

The parameters take the JAX module's tree (``vgg/conv<N>/{kernel, bias}``
with torchvision's ``features.N`` indices, ``lin<i>`` [C]), as
``load_lpips_params`` returns it; ``build_lpips`` loads them through
``weights.jax_to_state_dict``. Pretrained weights are not bundled: convert
them once with ``convert_lpips_torch_state_dict`` from a torchvision
``vgg16`` state dict and the ``lpips`` package's linear weights.

LPIPS computes in float32 on every run, whatever ``tpu.compute_dtype`` is,
as the JAX package's ``lpips_fn`` builds its module at float32.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torchvision vgg16.features layout: conv indices per slice
VGG_SLICES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
VGG_CHANNELS = ((64, 64), (128, 128), (256, 256, 256),
                (512, 512, 512), (512, 512, 512))

# lpips ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16 trunk emitting the five relu taps. Input NCHW in [-1, 1]."""

    def __init__(self):
        super().__init__()
        cin = 3
        for idxs, chans in zip(VGG_SLICES, VGG_CHANNELS):
            for idx, ch in zip(idxs, chans):
                self.add_module(f"conv{idx}", nn.Conv2d(cin, ch, 3,
                                                        padding=1))
                cin = ch
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x) -> List[torch.Tensor]:
        h = (x - self.shift) / self.scale
        taps = []
        for si, idxs in enumerate(VGG_SLICES):
            if si > 0:
                h = F.max_pool2d(h, 2, 2)
            for idx in idxs:
                h = F.relu(getattr(self, f"conv{idx}")(h))
            taps.append(h)
        return taps


class LPIPS(nn.Module):
    """Distance between two NCHW image batches in [-1, 1] -> [N]."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, chans in enumerate(VGG_CHANNELS):
            setattr(self, f"lin{i}", nn.Parameter(torch.ones(chans[-1])))

    def forward(self, x, y) -> torch.Tensor:
        fx = self.vgg(x)
        # no gradient reaches a target that does not ask for one (the
        # ground truth of the loss)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and y.requires_grad):
            fy = self.vgg(y)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.sqrt((a * a).sum(1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b * b).sum(1, keepdim=True) + 1e-10)
            d = (a - b) ** 2
            w = torch.clamp_min(getattr(self, f"lin{i}"), 0.0)
            # 1x1 conv with non-negative weights (lpips clamps at eval)
            wd = torch.einsum("bchw,c->bhw", d, w)
            total = total + wd.mean(dim=(1, 2))
        return total


def build_lpips(params: Dict, device=None) -> LPIPS:
    """A frozen float32 ``LPIPS`` on ``device`` holding ``params`` (the
    JAX tree, as ``load_lpips_params`` returns it)."""
    from unipre3d_tpu_torch import weights
    model = LPIPS()
    model.load_state_dict(weights.jax_to_state_dict(params))
    model.requires_grad_(False)
    return model.eval().to(device)


def lpips_fn(lpips: LPIPS, x, y) -> torch.Tensor:
    """Per-image distances [N] of ``x`` and ``y`` [N, 3, H, W] in [-1, 1],
    computed in float32."""
    return lpips(x.float(), y.float())


def convert_lpips_torch_state_dict(vgg_sd: Dict[str, "np.ndarray"],
                                   lin_sd: Dict[str, "np.ndarray"]
                                   ) -> Dict:
    """Convert torchvision ``vgg16().features`` weights + the lpips
    package's linear-layer weights into the LPIPS parameter tree.

    vgg_sd keys: ``features.N.weight``/``features.N.bias`` (or bare
    ``N.weight``); lin_sd keys: ``linN.model.1.weight`` [1, C, 1, 1] (or
    ``lins.N.model.1.weight``).
    """
    def get(sd, *names):
        for n in names:
            if n in sd:
                return np.asarray(sd[n])
        raise KeyError(names)

    vgg_params: Dict[str, Any] = {}
    for idxs in VGG_SLICES:
        for idx in idxs:
            w = get(vgg_sd, f"features.{idx}.weight", f"{idx}.weight")
            b = get(vgg_sd, f"features.{idx}.bias", f"{idx}.bias")
            vgg_params[f"conv{idx}"] = {
                # torch OIHW -> HWIO
                "kernel": np.transpose(w, (2, 3, 1, 0)),
                "bias": b,
            }
    params: Dict[str, Any] = {"vgg": vgg_params}
    for i in range(5):
        w = get(lin_sd, f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight")
        params[f"lin{i}"] = w.reshape(-1)
    return params


def load_lpips_params(path: str):
    """Load converted params from an .npz produced by
    ``np.savez(path, **flatten(params))`` (``/``-joined keys) or a torch
    .pth checkpoint containing both vgg and lin weights."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        params: Dict[str, Any] = {}
        for k, v in flat.items():
            node = params
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return params
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.numpy() for k, v in sd.items()}
    vgg_sd = {k: v for k, v in sd.items() if "features" in k or
              k.split(".")[0].isdigit()}
    lin_sd = {k: v for k, v in sd.items() if k.startswith(("lin", "lins"))}
    return convert_lpips_torch_state_dict(vgg_sd, lin_sd)
