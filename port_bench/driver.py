"""Drives the port's pretraining iteration for one cell.

The iteration is the one ``unipre3d_tpu_torch/train_network.py`` composes
(its loop, without the phase synchronizes that only time its phases):
the loader's next batch (``data.loader.Loader`` over the cell's traffic,
its prefetch thread), ``batch_to``, the feature cache's ``attach`` (made
by ``train_network.make_cache``), the scene geometry where the config has
one (``trainer.make_geometry_fn``), and ``trainer.make_train_step`` with
LPIPS where the cell has it. Each call sits in a ``bench/...`` range of
the profiler. The model holds the weights ``weights.make_weights`` made
from the seed; nothing else of the program's state is set by hand but the
state's step where the mix starts past step 0.

``Program.check_steps`` runs the first steps through the same iteration
and keeps what the correctness check compares: each step's loss, step 1's
conditioning features (what ``attach`` returned), gaussians (the model's
output) and supervision renders (what the step rendered), step 1's
gradient as the optimizer took it (its first moment over 1 - b1), and the
parameters and EMA after the last check step.

A configuration's plain reference is ``port_bench/reference/<config>.py``,
found by the configuration's name; the program's config keys that the
benchmark's file states are listed in that file (``program.keys``).
"""

from __future__ import annotations

import importlib
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

from port_bench import generator
from port_bench.reference.transformer_pretraining import BN_START
from port_bench.weights import make_weights, shapes_of

WEIGHT_STREAM, LPIPS_STREAM, DROP_STREAM, ORDER_STREAM = 10, 11, 12, 13


def config_value(cfg, path: str):
    node = cfg
    for part in path.split("."):
        node = node[part]
    return node.to_plain() if hasattr(node, "to_plain") else node


def program_config(spec: dict):
    """The program's composed config for the spec, checked against every
    key of the spec that the program reads (``program.keys``: the spec's
    key -> the dotted path in the program's config)."""
    from unipre3d_tpu_torch.training.config import load_config
    prog = spec["program"]
    cfg = load_config(prog["config_name"], overrides=list(prog["overrides"]))
    for key, path in prog["keys"].items():
        if config_value(cfg, path) != spec[key]:
            raise ValueError(f"{path} is {config_value(cfg, path)!r} in the "
                             f"program's config, {spec[key]!r} in the "
                             f"benchmark's")
    return cfg


def reference_of(spec: dict):
    """The configuration's plain reference module, by its name."""
    return importlib.import_module(f"port_bench.reference.{spec['name']}")


def detached(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A float32 copy of a dict of tensors (masks and indices as they
    are)."""
    return {k: (v.detach().float() if v.is_floating_point() else
                v.detach()).clone() for k, v in out.items()}


@contextmanager
def observed(model, store: dict, renders: bool = True):
    """While open, every forward of ``model`` leaves a copy of its output
    (the gaussians) in ``store["gaussians"]``; with ``renders`` also of its
    Gaussian head's raw channels in ``store["head"]``, and every
    supervision render of the program's step its images in
    ``store["renders"]``: what the timed path computed, read where it is
    produced."""
    from unipre3d_tpu_torch.training import trainer
    hooks = [model.register_forward_hook(
        lambda _m, _a, out: store.__setitem__("gaussians", detached(out)))]
    if renders:
        hooks.append(model.point_network.final.register_forward_hook(
            lambda _m, _a, out: store.__setitem__(
                "head", out.detach().float().clone())))
    render = trainer.render_supervision_views

    def observe(*args, **kwargs):
        out = render(*args, **kwargs)
        store["renders"] = out.detach().float().clone()
        return out

    if renders:
        trainer.render_supervision_views = observe
    try:
        yield store
    finally:
        for hook in hooks:
            hook.remove()
        trainer.render_supervision_views = render


def predictor_weights(spec: dict, seed: int, device) -> Dict:
    model, _ = reference_of(spec).build(spec)
    return make_weights(shapes_of(model),
                        generator.stream_seed(seed, WEIGHT_STREAM), device)


def lpips_weights(spec: dict, seed: int, device) -> Dict:
    _, lp = reference_of(spec).build(spec, with_lpips=True)
    return make_weights(shapes_of(lp),
                        generator.stream_seed(seed, LPIPS_STREAM), device)


def load_into(module, weights: Dict[str, torch.Tensor]) -> None:
    names = {n for n, _ in module.named_parameters()}
    if names != set(weights):
        raise ValueError(f"parameters the weights do not cover or name "
                         f"otherwise: {sorted(names ^ set(weights))[:5]}")
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(weights[n])


class Program:
    """The port's training state, step, feature cache and loader for one
    cell, built from the seed."""

    def __init__(self, spec: dict, mix: dict, seed: int, device,
                 wrap_step=None):
        from unipre3d_tpu_torch.data import Loader
        from unipre3d_tpu_torch.train_network import make_cache
        from unipre3d_tpu_torch.training.trainer import (
            TrainState, compute_dtype_of, make_geometry_fn, make_optimizer,
            make_train_step, split_frozen)
        from unipre3d_tpu_torch.models.gaussian_predictor import \
            build_predictor
        self.spec, self.mix, self.seed, self.device = spec, mix, seed, device
        cfg = self.cfg = program_config(spec)
        self.n_in = int(spec["input_images"])
        model = build_predictor(cfg, dtype=compute_dtype_of(cfg)).to(device)
        load_into(model, predictor_weights(spec, seed, device))
        trainable = split_frozen(model)[0]
        self.names = [n for n, _ in trainable]
        self.params = [p for _, p in trainable]
        self.state = TrainState(
            step=int(mix.get("start_step", 0)),
            optimizer=make_optimizer(cfg, self.params),
            ema={n: p.detach().clone() for n, p in trainable},
            generator=torch.Generator(device=device).manual_seed(
                generator.stream_seed(seed, DROP_STREAM)))
        self.lpips = None
        if mix.get("lpips"):
            from unipre3d_tpu_torch.utils.lpips import LPIPS
            self.lpips = LPIPS().to(device)
            load_into(self.lpips, lpips_weights(spec, seed, device))
            self.lpips.requires_grad_(False).eval()
        self.model = model
        self.cache = make_cache(cfg, model, device)
        if self.cache is not None:
            self.warm_vae()
        step = make_train_step(cfg, model, self.lpips)
        self.train_step = wrap_step(step) if wrap_step else step
        self.geometry_fn = make_geometry_fn(cfg, model)
        self.dataset = generator.make_dataset(mix, spec, seed, device)
        # examples read by the loader's prefetch thread itself, with no
        # pool: fewer threads for the main thread's interpreter lock
        self.loader = Loader(self.dataset, int(spec["batch_size"]),
                             seed=generator.stream_seed(seed, ORDER_STREAM),
                             num_workers=1)
        self.batches = self.loader.iter_from(0)
        self.loader_ms: List[float] = []
        self.valid_rows: List[int] = []

    def warm_vae(self) -> None:
        """Run the feature cache's extractor once at every number of misses
        a batch can have (1 to all its conditioning images), so that no
        convolution shape is first met inside the window."""
        n = int(self.spec["batch_size"]) * self.n_in
        h, w = self.cache.shape[1:]
        images = torch.zeros(n, 3, h, w, device=self.device)
        for k in range(1, n + 1):
            self.model.extract_vae_features(images[:k])

    def iterate(self):
        """One iteration -> (host batch, device batch, the step's
        metrics)."""
        from unipre3d_tpu_torch.data import batch_to
        with record_function("bench/loader"):
            t = time.perf_counter()
            host = next(self.batches)
            self.loader_ms.append((time.perf_counter() - t) * 1e3)
        if isinstance(host.get("point_cloud"), dict):
            self.valid_rows += [int(m.sum()) for m in
                                host["point_cloud"]["mask"]]
        with record_function("bench/batch_to"):
            batch = batch_to(host, self.device)
        if self.cache is not None:
            with record_function("bench/attach"):
                batch["vae_features"] = self.cache.attach(host, self.n_in)
        if self.geometry_fn is not None:
            with record_function("bench/geometry"):
                batch["geometry"] = self.geometry_fn(batch)
        with record_function("bench/step"):
            metrics = self.train_step(self.state, batch)
        return host, batch, metrics

    def observed_iterate(self, renders: bool = True):
        """One iteration that also keeps its gaussians (and renders) ->
        (host batch, what was observed, the step's metrics)."""
        store = {}
        with observed(self.model, store, renders):
            host, _, metrics = self.iterate()
        return host, store, metrics

    def check_steps(self, n: int = 3) -> dict:
        """The first ``n`` iterations, with what the check compares."""
        b1 = float(self.state.optimizer.b1)
        out = {"batches": [], "losses": [], "grad_norm": []}
        for i in range(n):
            store = {}
            with observed(self.model, store, renders=i == 0):
                host, batch, metrics = self.iterate()
            out["batches"].append(host)
            out["losses"].append(float(metrics["loss"]))
            out["grad_norm"].append(float(metrics["grad_norm"]))
            if i == 0:
                feats = batch.get("vae_features")
                out["vae_features"] = None if feats is None else \
                    feats.flatten(0, 1).detach().float().clone()
                out["gaussians"] = store.get("gaussians")
                out["head"] = store.get("head")
                out["renders"] = store.get("renders")
                out["grads"] = {n_: (m / (1.0 - b1)).clone() for n_, m in
                                zip(self.names, self.state.optimizer.mu)}
                out["bn1"] = self.bn_stats()
        out["params"] = {n_: p.detach().clone()
                         for n_, p in zip(self.names, self.params)}
        out["ema"] = {n_: t.clone() for n_, t in self.state.ema.items()}
        out["bn"] = self.bn_stats()
        return out

    def bn_stats(self) -> Dict[str, torch.Tensor]:
        """A copy of every BatchNorm running statistic of the model."""
        return {n: b.detach().clone() for n, b in self.model.named_buffers()
                if n.rsplit(".", 1)[-1] in BN_START}

    def cache_counts(self) -> Optional[dict]:
        if self.cache is None:
            return None
        return {"hits": self.cache.hits, "l2_hits": self.cache.l2_hits,
                "misses": self.cache.misses}

    def close(self) -> None:
        self.batches.close()
        self.loader.close()


def program_readings(prog_out: dict, weights: Dict) -> dict:
    """The program's side in the reference's terms: step 1's gaussians,
    renders and gradient, the parameters' and EMA's change, and their leaf
    norms."""
    updates = {n: p.float() - weights[n].float()
               for n, p in prog_out["params"].items()}
    return {
        "losses": prog_out["losses"],
        "grads": prog_out["grads"],
        "grad_norms": {n: float(g.norm()) for n, g in
                       prog_out["grads"].items()},
        "updates": updates,
        "update_norms": {n: float(u.norm()) for n, u in updates.items()},
        "ema_norms": {n: float((e - weights[n]).norm())
                      for n, e in prog_out["ema"].items()},
        "vae_features": prog_out.get("vae_features"),
        "gaussians": prog_out.get("gaussians"),
        "head": prog_out.get("head"),
        "renders": prog_out.get("renders"),
        "bn_norms": bn_norms(prog_out["bn"]),
        "bn1_norms": bn_norms(prog_out["bn1"]),
    }


def bn_norms(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float((b - BN_START[n.rsplit(".", 1)[-1]]).norm())
            for n, b in stats.items()}


def reference_readings(spec: dict, mix: dict, seed: int, batches, device,
                       rounding: str = "float32", counter=None,
                       gaussians: Optional[dict] = None) -> dict:
    """The plain reference over the same weights (made again from the seed)
    and batches; with ``gaussians`` (the program's step 1 output) also the
    reference renderer's supervision views of them (``splat_renders``), so
    that the render stage is judged on its own."""
    weights = predictor_weights(spec, seed, device)
    lp = lpips_weights(spec, seed, device) if mix.get("lpips") else None
    ref = reference_of(spec)
    out = ref.run_steps(
        spec, weights, batches, generator.stream_seed(seed, DROP_STREAM),
        int(mix.get("start_step", 0)), device, rounding=rounding,
        lpips_weights=lp, counter=counter)
    out["splat_renders"] = splat_renders(spec, gaussians, batches[0], device)
    return out


def splat_renders(spec: dict, gaussians: Optional[dict], host_batch,
                  device):
    """The reference renderer's views of a side's step 1 gaussians against
    the batch's cameras; None where there are none or not one a sample of
    the batch (the check then finds nothing to compare, which it counts
    against the run)."""
    if gaussians is None or next(iter(gaussians.values())).shape[0] != \
            len(host_batch["gt_images"]):
        return None
    return reference_of(spec).render_gaussians(spec, gaussians, host_batch,
                                               device)
