"""Whole runs of a tiny cell on the CPU: a sound run is correct and loads
neither JAX nor the JAX package; a run with the timed path broken
underneath is not correct, for each fault a fleet cell can have."""

import json
import subprocess
import sys
import time

import pytest
import torch

from odombench import harness, registry
from odombench.check import LIMITS, VoxelMaps, map_numbers
from odombench.run import FORBIDDEN
from odombench.tests.tiny import ROOT, tiny_folder

torch.set_num_threads(2)

SCRIPT = """
import json, sys, time
t0 = time.perf_counter()
from pathlib import Path
import torch
torch.set_num_threads(2)
from odombench import harness, registry
from odombench.run import forbidden_modules
cell = registry.cell(Path(sys.argv[1]), sys.argv[2], folder=Path(sys.argv[3]))
r = harness.run_cell(cell, 2 ** 31 + 5, 0.1, True, torch.device("cpu"), t0)
print(json.dumps({"result": r, "forbidden": forbidden_modules(),
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_rehearsal_is_correct_and_imports_no_jax(tmp_path):
    folder = tiny_folder(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(ROOT), "os1_128_ship.fleet_replay",
         str(folder)], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    r = got["result"]
    assert got["forbidden"] == []
    assert not set(got["modules"]) & set(FORBIDDEN)
    assert "superodom_tpu_torch" in got["modules"]
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] == 4 * r["window"]["steps"]
    assert list(r)[-1] == "compared"
    assert {"frontend_host_ms", "smoother_host_ms",
            "dispatch_ops_per_step"} <= set(r["metrics"])
    # the compared numbers are printed last on standard error
    assert out.stderr.strip().splitlines()[-1].startswith("rollout_gap_m")
    assert set(r["compared"]) == set(LIMITS)


def _unchanged(vstep):
    def f(state, *inputs):
        return state, vstep(state, *inputs)[1]
    return f


def _half_left_out(vstep):
    """The second half of the fleet is not stepped: its state stays, its
    outputs are zeros."""
    from superodom_tpu_torch.pipeline import tree_map

    def f(state, *inputs):
        new, out = vstep(state, *inputs)
        n = new.frame_count.shape[0]
        keep = torch.arange(n) < n // 2

        def pick(a, b):
            k = keep.reshape((n,) + (1,) * (a.dim() - 1))
            return torch.where(k, a, b)

        new = tree_map(pick, new, state)
        out = tree_map(lambda a: pick(a, torch.zeros_like(a)), out)
        return new, out
    return f


def _answer_altered(vstep):
    """Each pose moved by 1 cm where the step produces it."""
    def f(state, *inputs):
        new, out = vstep(state, *inputs)
        pose = out.pose._replace(t=out.pose.t + 0.01)
        return new, out._replace(pose=pose)
    return f


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _answer_altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
def test_broken_timed_path_is_not_correct(tmp_path, fault):
    folder = tiny_folder(tmp_path)
    cell = registry.cell(ROOT, "os1_128_ship.fleet_replay", folder=folder)
    r = harness.run_cell(cell, 2 ** 31 + 5, 0.1, False, torch.device("cpu"),
                         time.perf_counter(), fault=fault)
    assert r["correct"] is False
    assert any(v > lim for v, lim in r["compared"].values())


def test_bf16_control_fails_where_the_program_passes(tmp_path):
    """The control with the points held in bfloat16 fails the comparison
    (TF32 products exist only on the card: that control's test is
    ``test_odombench_control_cuda.py``; the controls' readings at the
    cells' sizes are in PERF.md)."""
    folder = tiny_folder(tmp_path)
    cell = registry.cell(ROOT, "os1_128_ship.fleet_replay", folder=folder)
    r = harness.run_cell(cell, 2 ** 31 + 7, 0.1, False, torch.device("cpu"),
                         time.perf_counter(), control=True)
    assert r["correct"] is True
    bf16 = r["control"]["bf16"]
    assert bf16["map_point_gap_m"] > LIMITS["map_point_gap_m"]


def test_map_points_are_compared_only_under_the_same_key():
    """A slot whose keys differ counts as an entry that differs, and its
    points are not measured against each other."""
    keys = torch.tensor([[1, 2, -1]], dtype=torch.int32)
    cnt = torch.tensor([[1, 1, 0]], dtype=torch.int32)
    pts = torch.full((3, 6), 1e30)
    pts[0, [0, 2, 4]] = torch.tensor([1.0, 2.0, 3.0])
    pts[1, [0, 2, 4]] = torch.tensor([5.0, 5.0, 5.0])
    ref = VoxelMaps(keys, pts, cnt)
    moved = pts.clone()
    moved[0, 0] += 0.25
    moved[1, [0, 2, 4]] = torch.tensor([50.0, 50.0, 50.0])
    other = VoxelMaps(torch.tensor([[1, 7, -1]], dtype=torch.int32),
                      moved, cnt)
    gap, differ = map_numbers(other, ref)
    assert gap == pytest.approx(0.25)
    assert differ == 1
