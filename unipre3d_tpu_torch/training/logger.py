"""Training logger: the console, ``metrics.jsonl`` in the output directory,
and wandb when configured.

Port of unipre3d_tpu/training/logger.py. Under several processes only
rank 0 (``is_main``) writes, prints and starts wandb, as JAX's gates on
process index 0; the other ranks' ``log`` returns its dict alone. Each
``log`` call writes one JSON line of ``<prefix>/<key>`` values with
``step`` and ``wall_s`` (seconds since the logger started), adds
``log10(loss + 1e-8)`` beside every loss term, and prints the line. wandb
is imported and started only when ``wandb.entity`` is set; if that fails
the logger stays on the console and the file.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Optional

from unipre3d_tpu_torch.parallel.distributed import process_index


class Logger:
    def __init__(self, cfg, out_dir: str):
        self.cfg = cfg
        self.out_dir = out_dir
        self.wandb = None
        self.jsonl = None
        self._t0 = time.time()
        self.is_main = process_index() == 0
        if not self.is_main:
            return
        os.makedirs(out_dir, exist_ok=True)
        self.jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        entity = (cfg.get("wandb") or {}).get("entity")
        if entity:
            try:
                import wandb
                # resume this output directory's previous run if it has one
                run_id = self._find_previous_run_id(out_dir)
                wandb.init(project=cfg.wandb.project, entity=entity,
                           config=cfg.to_plain(), dir=out_dir, id=run_id,
                           resume="must" if run_id else None)
                self.wandb = wandb
            except Exception as e:   # no wandb, or offline
                print(f"[logger] wandb unavailable ({e}); console only",
                      flush=True)

    @staticmethod
    def _find_previous_run_id(out_dir: str) -> Optional[str]:
        latest = os.path.join(out_dir, "wandb", "latest-run")
        try:
            target = os.path.basename(os.path.realpath(latest))
            # run directories are named run-<timestamp>-<id>
            if target.startswith("run-"):
                return target.split("-")[-1]
        except OSError:
            pass
        return None

    def log(self, step: int, metrics: Dict, prefix: str = "train") -> Dict:
        """Write and print one line; returns the logged dict."""
        flat = {f"{prefix}/{k}": (float(v) if hasattr(v, "__float__") else v)
                for k, v in metrics.items()}
        for k, v in list(flat.items()):
            base = k.split("/")[-1]
            if isinstance(v, float) and (base == "loss" or
                                         base.endswith("_loss") or
                                         base == "lpips"):
                flat[f"{k}_log10"] = math.log10(max(v, 0.0) + 1e-8)
        flat["step"] = int(step)
        flat["wall_s"] = round(time.time() - self._t0, 1)
        if not self.is_main:
            return flat
        self.jsonl.write(json.dumps(flat) + "\n")
        self.jsonl.flush()
        msg = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in flat.items())
        print(f"[{prefix}] {msg}", flush=True)
        if self.wandb:
            self.wandb.log(flat, step=int(step))
        return flat

    def log_videos(self, step: int, paths, fps: int = 14) -> None:
        """The written test videos' paths to the file; to wandb as videos
        when it is on."""
        self.log(step, {"videos": ";".join(paths)}, prefix="video")
        if self.wandb:
            try:
                self.wandb.log(
                    {f"test_video_{i}": self.wandb.Video(p, fps=fps,
                                                         format="mp4")
                     for i, p in enumerate(paths)}, step=int(step))
            except Exception as e:
                print(f"[logger] wandb video upload failed: {e}", flush=True)

    def close(self) -> None:
        if self.jsonl is not None:
            self.jsonl.close()
        if self.wandb:
            self.wandb.finish()
