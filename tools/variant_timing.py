"""Versions of one kernel source built and timed side by side on one card.

Shared by tools/time_dense_kernels.py, tools/time_binned_kernels.py and
tools/time_stream_kernels.py:
each source is compiled with the package's nvcc command (all at once) and
its C entry points bound with ctypes; the versions' launches are timed with
CUDA events in turns (A B ... then reversed, per round), so that they
compare within one call on one card.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build(src, so, entries):
    from unipre3d_tpu_torch import kernels
    proc = subprocess.run(kernels.nvcc_command(src, so),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    lib = ctypes.CDLL(so)
    fns = []
    for name, n_ptr, n_int in entries:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append(fn)
    report = [ln.strip() for ln in proc.stdout.splitlines()
              if any(k in ln for k in ("Compiling entry", "registers",
                                       "spill"))]
    return fns, report


def build_all(sources, out_dir, entries):
    """Each source built into ``out_dir`` and its entry points ``entries``
    ((C name, pointer count, int count) each; the stream is appended)
    bound -> [(functions, ptxas' register and spill lines)] in order."""
    with ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(
            lambda a: _build(a[1], os.path.join(out_dir, f"v{a[0]}.so"),
                             entries), enumerate(sources)))


def stream_arg():
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def time_rounds(rows, rounds, iters):
    """Times each row's ``fwd`` and ``bwd`` closures (``cuda_ms`` over
    ``iters`` launches after a warm-up), the rows in order and then
    reversed, ``rounds`` times; appends to its ``fwd_ms`` / ``bwd_ms``."""
    import chip_smoke
    for rnd in range(rounds):
        for row in rows if rnd % 2 == 0 else rows[::-1]:
            row.setdefault("fwd_ms", []).append(
                chip_smoke.cuda_ms(row["fwd"], iters))
            row.setdefault("bwd_ms", []).append(
                chip_smoke.cuda_ms(row["bwd"], iters))


def report(rows, out=None, head=(), **extra):
    """Prints the JSON lines ``head`` and one per row (without its
    closures, with ``extra`` and the medians of its times); ``out`` also
    gets them as a file."""
    lines = [json.dumps(h) for h in head]
    for row in rows:
        row = {k: v for k, v in row.items() if k not in ("fwd", "bwd")}
        row.update(extra, fwd_median_ms=statistics.median(row["fwd_ms"]),
                   bwd_median_ms=statistics.median(row["bwd_ms"]))
        lines.append(json.dumps(row))
    for line in lines:
        print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")


def source_name(src):
    return os.path.relpath(os.path.abspath(src), ROOT)
