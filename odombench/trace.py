"""Reduces a ``torch.profiler`` trace of the fleet's steps to what the
per-layer readers take: host time inside each ``step.*`` range, op counts,
device time by kernel, the device's busy intervals and the idle gaps
between them, each gap named by the ``step.*`` range the host was in."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

RANGE_PREFIX = "step."
# the harness's own range around the traced steps
ANNOTATIONS = ("window",)
NAME_CHARS = 120  # a device op's name in the breakdown, cut to this


@dataclasses.dataclass
class TraceSummary:
    steps: int  # steps in the traced window
    window_us: float  # the traced window on the host's clock
    busy_us: float  # union of the device's activity intervals
    ranges_us: Dict[str, float]  # host time inside each step.* range
    op_counts: Dict[str, int]  # CPU-side op events by name
    device_us: Dict[str, float]  # device time by kernel / copy name
    idle_gaps: List[Tuple[str, float]]  # (host range, seconds), longest first

    def per_step(self, value: float) -> float:
        return value / self.steps

    def range_ms_per_step(self, name: str):
        if name not in self.ranges_us:
            return None
        return self.ranges_us[name] / 1e3 / self.steps

    def ops_matching(self, prefix: str) -> int:
        return sum(n for k, n in self.op_counts.items()
                   if k.startswith(prefix))

    def device_top(self, n: int = 10) -> List[Tuple[str, float]]:
        top = sorted(self.device_us.items(), key=lambda kv: -kv[1])[:n]
        return [(k[:NAME_CHARS], v / 1e6) for k, v in top]


def _annotation(name: str) -> bool:
    """A profiler range (``step.*``, the traced window) rather than a
    kernel or a copy."""
    return name.startswith(RANGE_PREFIX) or name in ANNOTATIONS


def _union(intervals: List[Tuple[float, float]]):
    """Merged, sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _innermost(ranges: List[Tuple[float, float, str]], t: float) -> str:
    """The ``step.*`` range containing host time ``t`` (ranges of one step
    do not overlap), or "between steps"."""
    lo, hi = 0, len(ranges)
    while lo < hi:  # last range starting at or before t
        mid = (lo + hi) // 2
        if ranges[mid][0] <= t:
            lo = mid + 1
        else:
            hi = mid
    if lo and ranges[lo - 1][1] >= t:
        return ranges[lo - 1][2]
    return "between steps"


def summarise(events, steps: int, window: Tuple[float, float],
              n_gaps: int = 10) -> TraceSummary:
    """``events``: records ``(name, on_device, start_us, end_us)`` of one
    traced window (the profiler's events, host and device on one clock);
    ``window``: its start and end in the same microseconds."""
    ranges_us: Dict[str, float] = {}
    op_counts: Dict[str, int] = {}
    device_us: Dict[str, float] = {}
    host_ranges = []
    host_ops = []
    busy = []
    w0, w1 = window
    for name, on_device, start, end in events:
        if on_device and _annotation(name):
            continue  # a host range's shadow on the device's timeline
        if on_device:
            s, e = max(start, w0), min(end, w1)
            if e > s:
                busy.append((s, e))
            device_us[name] = device_us.get(name, 0.0) + (end - start)
        elif name.startswith(RANGE_PREFIX):
            ranges_us[name] = ranges_us.get(name, 0.0) + (end - start)
            host_ranges.append((start, end, name))
        else:
            host_ops.append((start, -end, name))
    # an op nested directly in an op of its own name is one op (vmap's
    # batching layers record each op again inside itself): counted as the
    # profiler's event list counts it
    stack = []
    for start, neg_end, name in sorted(host_ops):
        while stack and stack[-1][0] <= start:
            stack.pop()
        if not (stack and stack[-1][1] == name):
            op_counts[name] = op_counts.get(name, 0) + 1
        stack.append((-neg_end, name))
    merged = _union(busy)
    busy_us = sum(b - a for a, b in merged)
    host_ranges.sort()
    gaps = []
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((_innermost(host_ranges, a), (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return TraceSummary(steps=steps, window_us=w1 - w0, busy_us=busy_us,
                        ranges_us=ranges_us, op_counts=op_counts,
                        device_us=device_us, idle_gaps=gaps[:n_gaps])


def profiler_events(prof):
    """``(name, on_device, start_us, end_us)`` of every event of a
    ``torch.profiler.profile`` run, host ops and device activities alike,
    read from the profiler's raw results (building its event tree takes
    minutes for a fleet's million events)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        yield (e.name(), e.device_type() == cuda, start,
               start + e.duration_ns() / 1e3)
