"""BENCHMARK.json: its names, units and limits keep to the contract, and
every cell, configuration, mix and metric is found by name from a file of
its own."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "port_bench"
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["paths"] == ["port_bench"]
    assert MANIFEST["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    cells = len(MANIFEST["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(MANIFEST["configs"]) <= 24
    assert sum(c["chips"] == 4 for c in MANIFEST["workloads"]) <= \
        max(1, cells // 4)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [c["name"] for c in MANIFEST["workloads"]]
                         + [c["name"] for c in MANIFEST["configs"]])
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in MANIFEST["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in [m["name"] for m in MANIFEST["end_to_end"]]
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    src = (BENCH / "metrics" / f"{metric['name']}.py").read_text()
    assert "def read(ctx)" in src


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda c: c["name"])
def test_every_cell_finds_its_files_and_reports_enough(cell):
    config = [c for c in MANIFEST["configs"] if c["name"] == cell["config"]]
    assert len(config) == 1
    spec = json.loads((REPO / config[0]["file"]).read_text())
    assert spec["name"] == cell["config"]
    assert (BENCH / "reference" / f"{cell['config']}.py").exists()
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    assert (BENCH / "kinds" / f"{mix['kind']}.py").exists()
    assert (BENCH / "limits" / f"{cell['name']}.json").exists()
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200

    def reported(group):
        return [m["name"] for m in MANIFEST[group]
                if cell["name"] in m.get("workloads", [cell["name"]])]
    e2e = reported("end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert reported("per_layer")


def test_config_files_are_unique_and_under_paths():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith("port_bench/configs/") for f in files)
    for c in MANIFEST["configs"]:
        spec = json.loads((REPO / c["file"]).read_text())
        assert spec["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(c["config"], c["traffic"]) for c in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda c: c["name"])
def test_each_config_names_the_program_keys_it_states(entry):
    """The keys checked against the program's config are listed in the
    configuration's own file, and each is a key the file states."""
    spec = json.loads((REPO / entry["file"]).read_text())
    keys = spec["program"]["keys"]
    assert keys and all(k in spec for k in keys)
    assert all(v.count(".") >= 1 for v in keys.values())
