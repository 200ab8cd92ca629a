#!/usr/bin/env python3
"""Count the CUDA launches of the selective scan on the default run's path,
for the port's package in each of several trees, on one card.

    python3 tools/count_scan_launches.py [TREE ...]

Each TREE (default: this repository) is a checkout holding
``unipre3d_tpu_torch/``, e.g. an earlier commit unpacked with ``git
archive`` into a directory that .gitignore lists. Each runs in a process of
its own with its package first on the path, through this repository's
``chip_smoke.scan_launches``: the kernel launches (torch.profiler) of one
bf16 ``SSMBranch`` forward + backward at Mamba3D's shape, and of its
``selective_scan`` call alone. Prints one JSON line per tree with the
card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import torch
import unipre3d_tpu_torch
print(json.dumps(dict(cs.scan_launches(torch.device("cuda")),
                      package=unipre3d_tpu_torch.__file__)))
"""


def main(argv=None):
    trees = (argv if argv is not None else sys.argv[1:]) or [ROOT]
    import torch
    if not torch.cuda.is_available():
        print("count_scan_launches: no CUDA device available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    card = chip_smoke.nvidia_smi_line()
    for tree in trees:
        out = subprocess.run(
            [sys.executable, "-c", CHILD, os.path.abspath(tree),
             os.path.join(ROOT, "chip_smoke.py")], capture_output=True,
            text=True, check=True, cwd=os.path.abspath(tree))
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(row, tree=os.path.relpath(
            os.path.abspath(tree), ROOT), card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
