"""Each cell runs briefly on the card, end to end, and comes out correct
(``python -m pytest port_bench/tests -m cuda`` on a machine with one)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in MANIFEST["workloads"]
                                  if c["chips"] == 1])
def test_cell_runs_on_the_card(cuda_card, cell):
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         "2147483711", "--seconds", "3", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert "setup_s" in result["metrics"]
