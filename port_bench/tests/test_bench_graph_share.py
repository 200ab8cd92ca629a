"""``backbone_graph_share``, on hand-built traces: the window's
``graph/replay`` ranges per ``bench/step`` in %, keeping to the window's
bounds, and nothing (None) where the program opens no such range, as a
program without the graphs does not."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from port_bench.trace import Trace

REPO = Path(__file__).resolve().parents[2]
MS = 1_000_000   # ns


def read(ranges, t0=0, t1=1000 * MS):
    spec = importlib.util.spec_from_file_location(
        "backbone_graph_share",
        REPO / "port_bench" / "metrics" / "backbone_graph_share.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(SimpleNamespace(trace=Trace(list(ranges), [], t0, t1)))


STEPS = [("bench/step", 0, 100 * MS), ("bench/step", 200 * MS, 300 * MS),
         ("bench/step", 400 * MS, 500 * MS),
         ("bench/step", 600 * MS, 700 * MS)]


def test_every_step_replayed_reads_100():
    replays = [("graph/replay", s + MS, s + 2 * MS) for _, s, _ in STEPS]
    assert read(STEPS + replays) == pytest.approx(100.0)


def test_counts_the_replays_inside_the_window():
    replays = [("graph/replay", 10 * MS, 11 * MS),
               ("graph/replay", 610 * MS, 611 * MS),
               ("graph/replay", 1500 * MS, 1501 * MS)]   # past the window
    assert read(STEPS + replays) == pytest.approx(50.0)


def test_reads_nothing_without_replays_or_steps():
    assert read(STEPS + [("graph/capture", 5 * MS, 9 * MS)]) is None
    assert read([("graph/replay", MS, 2 * MS)]) is None
    assert read([]) is None
