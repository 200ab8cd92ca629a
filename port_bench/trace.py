"""The traced window, reduced from ``torch.profiler``'s events.

``Trace`` holds the named ranges on the host (``record_function``: the
harness's ``bench/...`` and the program's ``step/...``), each device
operation (kernels, copies, sets) with its interval on the device and the
host time of the call that launched it, and the window's bounds. A
device operation belongs to a range when its launch falls inside the
range; the backward's kernels, launched by autograd's thread while the
main thread waits inside ``step/backward``, count there too.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

LAUNCH_PREFIXES = ("cuda", "cu")


class Trace:
    def __init__(self, ranges: List[Tuple[str, int, int]],
                 ops: List[Tuple[str, int, int, Optional[int]]],
                 t0: int, t1: int):
        self.t0, self.t1 = t0, t1
        self.ops = [o for o in ops if o[1] < t1 and o[1] + o[2] > t0]
        self.by_name: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        for name, s, e in ranges:
            self.by_name[name].append((s, e))
        for v in self.by_name.values():
            v.sort()
        self.ranges = sorted(ranges, key=lambda r: r[1])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def launched_in(self, name: str) -> List[Tuple[str, int, int, int]]:
        """Device operations launched inside any range called ``name``."""
        spans = self.by_name.get(name, [])
        starts = [s for s, _ in spans]
        out = []
        for op in self.ops:
            launch = op[3]
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and spans[i][1] >= launch:
                out.append(op)
        return out

    def nth_launched_in(self, name: str, k: int
                        ) -> List[Tuple[str, int, int, int]]:
        """Device operations launched inside the ``k``-th range called
        ``name`` (in time order), none where there is no such range."""
        spans = self.by_name.get(name, [])
        if k >= len(spans):
            return []
        s, e = spans[k]
        return [op for op in self.ops
                if op[3] is not None and s <= op[3] <= e]

    def device_s(self, name: str) -> float:
        return sum(op[2] for op in self.launched_in(name)) * 1e-9

    def count(self, name: str) -> int:
        return len(self.by_name.get(name, []))

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window."""
        iv = sorted((max(s, self.t0), min(s + d, self.t1))
                    for _, s, d, _ in self.ops)
        merged: List[List[int]] = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged if e > s]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, int] = defaultdict(int)
        for name, _, d, _ in self.ops:
            tot[name] += d
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]

    def _names_at(self, times: List[int]) -> List[str]:
        """The innermost range open on the host at each of the ascending
        ``times`` (``none`` where none is), by one sweep over the nested
        ranges."""
        stack: List[Tuple[str, int, int]] = []
        out, i = [], 0
        for t in times:
            while i < len(self.ranges) and self.ranges[i][1] <= t:
                r = self.ranges[i]
                while stack and stack[-1][2] < r[1]:
                    stack.pop()
                stack.append(r)
                i += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            out.append(stack[-1][0] if stack else "none")
        return out

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle time on the device summed by the range open on the host
        where each gap began, the largest ``n``."""
        busy = self.busy_intervals()
        edges = [(self.t0, self.t0)] + busy + [(self.t1, self.t1)]
        gaps = [(e0, s1 - e0) for (_, e0), (s1, _) in zip(edges, edges[1:])
                if s1 > e0]
        tot: Dict[str, int] = defaultdict(int)
        for name, (_, d) in zip(self._names_at([g[0] for g in gaps]), gaps):
            tot[name] += d
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]


def from_profiler(prof) -> Trace:
    """A ``Trace`` of a ``torch.profiler.profile`` run over its
    ``bench/window`` range."""
    events = prof.profiler.kineto_results.events()
    ranges, launches, device = [], {}, []
    for ev in events:
        on_device = "cuda" in str(ev.device_type()).lower()
        name = ev.name()
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.is_user_annotation():
            if not on_device:
                ranges.append((name, start, start + dur))
            continue
        if on_device:
            device.append((name, start, dur, ev.correlation_id(),
                           ev.linked_correlation_id()))
        elif name.startswith(LAUNCH_PREFIXES):
            launches[ev.correlation_id()] = start
    ops = []
    for name, start, dur, corr, linked in device:
        launch = launches.get(corr, launches.get(linked))
        ops.append((name, start, dur, launch))
    (_, t0, t1), = [r for r in ranges if r[0] == "bench/window"]
    return Trace([r for r in ranges if r[0] != "bench/window"], ops, t0, t1)
