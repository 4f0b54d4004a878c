"""The harness finds every part of a cell by its name in BENCHMARK.json,
and a new part is new files and manifest entries alone."""

import json
import re
import shutil

import pytest
import torch

from odombench import harness, registry
from odombench.tests.tiny import BENCH, ROOT, tiny_folder

torch.set_num_threads(2)


def test_each_cell_finds_its_parts():
    man = registry.manifest(ROOT)
    for w in man["workloads"]:
        cell = registry.cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert cell.instances >= 1
        for m in cell.end_to_end + cell.per_layer:
            assert callable(registry.reader(BENCH, m["name"]))
    counts = registry.kernel_counts(BENCH)
    assert {"octant_lookup", "knn_select", "plane_fit", "gn",
            "voxel_claim"} <= set(counts)
    assert all(isinstance(m.DEVICE_NAME, str) for m in counts.values())


def test_manifest_names_and_units_use_allowed_characters():
    man = registry.manifest(ROOT)
    assert registry.check_names(man) == []
    assert not registry.check_names({"configs": [{"name": "a b"}]}) == []
    assert not registry.check_names(
        {"end_to_end": [{"name": "x", "unit": "tokens per s"}]}) == []
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in man[k]]
    assert len(names) == len(set(names))
    for e in man["configs"]:
        assert e["file"].startswith(tuple(p + "/" for p in man["paths"]))
    for m in man["end_to_end"] + man["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_/%.\-]{1,16}", m["unit"])
        assert m["better"] in ("lower", "higher")


def test_a_dummy_added_as_files_is_found(tmp_path):
    """A configuration, a traffic mix, a metric and a kernel count added to
    a copy as new files, and a manifest that names them: the cell runs its
    parts without an edit to a file that was there."""
    folder = tiny_folder(tmp_path / "bench")
    c = json.loads((folder / "configs" / "os1_128_ship.json").read_text())
    c.update(name="dummy_cfg", instances=2)
    (folder / "configs" / "dummy_cfg.json").write_text(json.dumps(c))
    t = json.loads((folder / "traffic" / "fleet_replay.json").read_text())
    t.update(name="dummy_mix")
    (folder / "traffic" / "dummy_mix.json").write_text(json.dumps(t))
    (folder / "metrics" / "dummy_metric.py").write_text(
        "def read(run):\n    return run.instances * 10.0\n")
    (folder / "kernels" / "dummy_kernel.py").write_text(
        "DEVICE_NAME = 'dummy_kernel'\n\n"
        "def count(cell, data):\n    return [(1000, 10)]\n")
    root = tmp_path / "root"
    root.mkdir()
    man = registry.manifest(ROOT)
    man["workloads"].append({"name": "dummy_cfg.dummy_mix",
                             "config": "dummy_cfg", "traffic": "dummy_mix",
                             "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "dummy_metric", "unit": "n",
                             "better": "lower", "source": "program_counter",
                             "layer": "test", "moves": "scans_per_s",
                             "workloads": ["dummy_cfg.dummy_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = registry.cell(root, "dummy_cfg.dummy_mix", folder=folder)
    assert cell.instances == 2
    assert [m["name"] for m in cell.per_layer][-1] == "dummy_metric"
    run = harness.RunRecord(cell=cell, instances=2, steps=1, window_s=1.0,
                            setup_s=1.0, peak_window_bytes=0)
    assert registry.reader(folder, "dummy_metric")(run) == 20.0
    assert "dummy_kernel" in registry.kernel_counts(folder)
    with pytest.raises(KeyError):
        registry.cell(root, "no_such.cell", folder=folder)
