"""A copy of the benchmark's parts at a size the CPU runs in seconds: the
two configurations cut to 4,096 points, 256 features and an 8,192-slot
map, four instances, two trajectories of 15 + 24 scans, chunks of 2."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "odombench"
PARTS = ("configs", "traffic", "metrics", "kernels")


def tiny_folder(tmp: Path) -> Path:
    for d in PARTS:
        shutil.copytree(BENCH / d, tmp / d)
    for path in (tmp / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        s = c["pipeline"]["sensor"]
        c["points_per_sweep"] = c["points_per_sweep"] * 4096 \
            // s["max_points"]
        s.update(max_points=4096, max_surface_features=256,
                 compact_width=4096, filter_point_size=2)
        c["pipeline"]["map"].update(table_size=8192, cell_size=1.0)
        c["pipeline"]["imu"]["max_imu_per_scan"] = 48
        c["instances"] = 4
        path.write_text(json.dumps(c))
    path = tmp / "traffic" / "fleet_replay.json"
    t = json.loads(path.read_text())
    t.update(trajectories=2, lap_scans=24, chunk=2, checks=2, check_steps=4,
             rollout_steps=6, trace_steps=2)
    path.write_text(json.dumps(t))
    return tmp
