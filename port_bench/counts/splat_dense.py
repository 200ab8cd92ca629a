"""Least time of one launch of the dense splat pair
(``csrc/splat_dense.cu``: ``dense_fwd_kernel``, ``dense_bwd_kernel``).

Bytes are the launch's inputs read once and its outputs written once, from
the shapes: the forward reads the depth-sorted table's 9 used rows [R, 9,
N_pad] and writes the images [R, 3, H*W] and the final transmittance [R,
1, H*W]; the backward reads the table, the images and their cotangent and
writes the table's 9 gradient rows. Operations are the (render, pixel,
gaussian) pairs that contribute to the images (the walk's live pairs, which
the benchmark counts itself from its reference's projected gaussians)
times 22 + 3 operations a pair forward and 60 + 4 backward. The least time
is the larger of bytes / 3.35 TB/s and operations / 67 TFLOP/s, the
H100's HBM bandwidth and float32 peak outside the tensor cores.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
OPS_PER_PAIR = {"fwd": 22 + 3, "bwd": 60 + 4}
KERNELS = {"fwd": "dense_fwd_kernel", "bwd": "dense_bwd_kernel"}


def launch_bytes(direction: str, renders: int, n_pad: int, pixels: int
                 ) -> int:
    table = renders * 9 * n_pad * 4
    images = renders * 3 * pixels * 4
    if direction == "fwd":
        return table + 12 + images + renders * pixels * 4
    return table + 2 * images + table


def least_seconds(direction: str, renders: int, n_pad: int, pixels: int,
                  pairs: float) -> float:
    return max(launch_bytes(direction, renders, n_pad, pixels)
               / HBM_BYTES_PER_S,
               pairs * OPS_PER_PAIR[direction] / FP32_FLOPS)


def shape_of(spec: dict):
    """(renders, N_pad, pixels) of the training step's launch: every
    (element, supervision view) one render of ``num_groups`` gaussians,
    padded as the program's table is; None for a config that does not
    render through the dense pair."""
    if "num_groups" not in spec:
        return None
    n = int(spec["num_groups"])
    n_pad = -(-n // 128) * 128
    if n_pad > 512:
        n_pad = -(-n_pad // 512) * 512
    return (int(spec["batch_size"]) * int(spec["imgs_per_obj"]), n_pad,
            int(spec["training_resolution"]) ** 2)


def pairs(spec: dict, gaussians: dict, host_batch: dict, device) -> int:
    """The contributing pairs of one training step's launch: the
    reference's projection and walk (reference/render.py, float32, TF32
    off) over that step's gaussians, as the program's model produced them,
    against its batch's supervision cameras."""
    from port_bench.reference import render
    from port_bench.reference.transformer_pretraining import (no_tf32,
                                                              on_device)
    n_in = int(spec["input_images"])
    res = int(spec["training_resolution"])
    bg = [1.0] * 3 if spec["white_background"] else [0.0] * 3
    counter = {}
    with no_tf32(), torch.no_grad():
        g = {k: v.to(device).float() for k, v in gaussians.items()}
        render.render_views(g, on_device(host_batch, device), n_in, res,
                            res, float(spec["fov"]), bg, counter)
    return int(counter.get("pairs", 0))
