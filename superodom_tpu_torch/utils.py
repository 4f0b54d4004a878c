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
