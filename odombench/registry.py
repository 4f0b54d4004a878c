"""Finds what a cell is made of by the names in ``BENCHMARK.json``.

Each part lives in a file of its own under the benchmark's folder, found by
its name, so that a new configuration, traffic mix, metric or kernel count
is a new file and a new manifest entry, never an edit:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the traffic mix's parameters;
* ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``;
* ``kernels/<kernel>.py``: a hand kernel's device name (``DEVICE_NAME``) and
  its bytes and operations for one step of a cell (``count(cell)``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import typing
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    """One workload: its manifest entry, configuration, traffic and the
    metrics it reports, each with its manifest entry."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    folder: Path

    @property
    def instances(self) -> int:
        return int(self.config["instances"])


def _load_module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(
        f"odombench_{tag}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: Path, workload: str, folder: Path = HERE) -> Cell:
    """The cell ``workload`` of the manifest at ``root``, its parts read
    from ``folder``."""
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    with open(folder / "configs" / f"{entry['config']}.json") as f:
        config = json.load(f)
    with open(folder / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=workload, chips=int(entry["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in man["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in man["per_layer"]
                           if _reports(m, workload)],
                folder=folder)


def reader(folder: Path, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _load_module(folder / "metrics" / f"{metric}.py", "metric").read


def kernel_counts(folder: Path) -> Dict[str, object]:
    """Every ``kernels/<name>.py``, by name."""
    out = {}
    for path in sorted((folder / "kernels").glob("*.py")):
        if path.stem.startswith("_"):
            continue
        out[path.stem] = _load_module(path, "kernel")
    return out


def _build(cls, value):
    """A (nested, frozen) dataclass of type ``cls`` from plain JSON."""
    if dataclasses.is_dataclass(cls):
        hints = typing.get_type_hints(cls)
        return cls(**{f.name: _build(hints[f.name], value[f.name])
                      for f in dataclasses.fields(cls) if f.name in value})
    if isinstance(value, list):
        return tuple(_build(None, v) for v in value)
    return value


def pipeline_config(config: dict, cls):
    """The configuration file's ``pipeline`` as an instance of ``cls`` (the
    program's or the reference's ``PipelineConfig``)."""
    return _build(cls, config["pipeline"])


def check_names(man: dict) -> List[str]:
    """Names and units outside the allowed characters, as messages."""
    bad = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man.get(key, []):
            if not NAME.match(e["name"]):
                bad.append(f"{key}: name {e['name']!r}")
            if "unit" in e and not UNIT.match(e["unit"]):
                bad.append(f"{key}: unit {e['unit']!r}")
            for k in ("config", "traffic"):
                if k in e and not NAME.match(e[k]):
                    bad.append(f"{key}: {k} {e[k]!r}")
            for k in e.get("reduced", []):
                if not NAME.match(k):
                    bad.append(f"{key}: reduced key {k!r}")
    return bad


def cache_dirs(root: Path) -> Dict[str, str]:
    """Build and kernel caches of the program, at fixed paths inside the
    checkout."""
    base = root / ".bench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton")}


def set_cache_dirs(root: Path, environ: Optional[dict] = None) -> None:
    env = os.environ if environ is None else environ
    for k, v in cache_dirs(root).items():
        env[k] = v
