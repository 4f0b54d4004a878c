"""Profiling and logging utilities.

Replaces the reference's TicToc stopwatch / ScopedTimer RAII logger
(reference tic_toc.h:11-32, superodom_utils.h:26-43) and adds a
torch.profiler trace capture around device work.

The PyTorch port's copy of the JAX package's ``utils``; its
``device_trace`` records with ``torch.profiler`` where the JAX package's
uses ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time
from typing import Dict, List, Optional


class TicToc:
    """Millisecond stopwatch (reference tic_toc.h)."""

    def __init__(self):
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0


@contextlib.contextmanager
def scoped_timer(name: str, sink: Optional[List[Dict]] = None, verbose=False):
    """RAII-style scope timer (reference ScopedTimer); appends
    {"name", "ms"} records to ``sink`` if given."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ms = (time.perf_counter() - t0) * 1000.0
        if sink is not None:
            sink.append({"name": name, "ms": ms})
        if verbose:
            print(f"[timer] {name}: {ms:.2f} ms")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace capture around a block: host ranges and, where
    a CUDA device is present, its kernels, written to ``log_dir`` as a
    Chrome trace (``trace.json``)."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_ms(fn, inner: int = 20, reps: int = 50) -> float:
    """Median device time (ms) of one call of ``fn`` on the current CUDA
    device: ``inner`` calls captured in one CUDA graph, replayed ``reps``
    times between CUDA events (so the host's launch cost is not counted)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


class JsonlLogger:
    """Structured per-scan stats sink — the host side of the reference's
    OptimizationStats topic stream (script/save_superodom_stats.py)."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def log(self, record: dict):
        self._f.write(json.dumps(record) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
