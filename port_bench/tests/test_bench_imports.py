"""Nothing the benchmark runs imports JAX, jaxlib, flax or the JAX
package, and the plain reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "port_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "unipre3d_tpu")
PROBE = """
import sys, importlib.util, json, pathlib
sys.path.insert(0, {repo!r})
import port_bench.run, port_bench.calibrate, port_bench.driver
import port_bench.generator, port_bench.check, port_bench.trace
import port_bench.counts.model_flops, port_bench.counts.splat_dense
import port_bench.reference.transformer_pretraining
import unipre3d_tpu_torch.train_network
import unipre3d_tpu_torch.training.trainer, unipre3d_tpu_torch.utils.lpips
for f in pathlib.Path({bench!r}, "metrics").glob("*.py"):
    s = importlib.util.spec_from_file_location(f.stem, f)
    s.loader.exec_module(importlib.util.module_from_spec(s))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_harness_and_port_load_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(repo=str(REPO),
                                            bench=str(BENCH))],
        capture_output=True, text=True, timeout=300, check=True)
    top = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert "unipre3d_tpu_torch" in top     # compared whole, not as a prefix


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN + ("unipre3d_tpu_torch",)
