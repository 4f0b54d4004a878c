"""The port's qualification tools against the JAX package's
(``superodom_tpu_torch.tools.stress_matrix`` / ``.profile`` against
``tools/stress_matrix.py`` / ``tools/profile.py``), on the CPU: the
battery's two configurations field by field at two densities; variant
parsing and overrides field by field; one short battery case through the
port's tool against the same case through the JAX package's runner (the
row's keys, its verdict, its settled ATE within 2 mm: the two step
implementations agree in the ICP pose within 1e-4 m a scan and in the
smoother's state not to the bit, ROADMAP C2); and ``stages`` and ``ab``
on a tiny configuration with few repetitions, printing JAX's stage
names."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from superodom_tpu.io import scenarios as jsc  # noqa: E402
from superodom_tpu.io.datasets import ate_rmse  # noqa: E402
from superodom_tpu.runner import OdometryRunner as JRunner  # noqa: E402

from superodom_tpu_torch.tools import profile as tprof  # noqa: E402
from superodom_tpu_torch.tools import stress_matrix as tsm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import profile as jprof  # noqa: E402
from tools import stress_matrix as jsm  # noqa: E402

# the JAX tool's row keys (tools/stress_matrix.py)
ROW_KEYS = ["case", "config", "n_scans", "ate_m", "bound_m", "check_ok",
            "pass", "wall_s"]
CASE, POINTS, SCALE = "range_noise", 2048, 0.5
ATE_TOL_M = 2e-3
# the JAX package's stage names (tools/profile.py run_stages)
STAGES = ["full_step", "frontend/voxel_downsample",
          "frontend/select_features", "frontend/select+undistort",
          "icp/gather_candidates", "icp/select_knn",
          "icp/plane_corrs(incl select)", "icp/gauss_newton(4it)",
          "icp/full_register", "map/insert", "map/evict", "map/census",
          "smoother/update"]
TINY = ("sensor.max_points=2048,sensor.max_surface_features=256,"
        "map.table_size=8192")


@pytest.mark.parametrize("points", [16384, 4096])
def test_battery_configs_equal_jax(points):
    ours, theirs = tsm._configs(points), jsm._configs(points)
    assert [n for n, _ in ours] == [n for n, _ in theirs] == ["ship",
                                                              "parity"]
    for (_, a), (_, b) in zip(ours, theirs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("spec", [
    "base", "parity", "A:registration.max_icp_iters=3",
    "parityB:sensor.scan_thin_mode=none,map.cell_capacity=32,"
    "registration.tukey_anneal=0.5"])
def test_variants_equal_jax(spec):
    (na, a), (nb, b) = tprof.parse_variant(spec), jprof.parse_variant(spec)
    assert na == nb
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    ov = {"imu.smoother_gn_iters": 3, "map.cell_size": 1.5}
    assert dataclasses.asdict(tprof.apply_overrides(a, ov)) == \
        dataclasses.asdict(jprof.apply_overrides(b, ov))


def test_battery_case_matches_jax_runner(tmp_path, capsys):
    """``range_noise`` at 2,048 points and half length through the port's
    tool on the CPU, against the JAX package's runner on the same case:
    the row has the JAX tool's keys and its verdict, and the settled ATE
    is within ATE_TOL_M of JAX's."""
    out = tmp_path / "rows.json"
    with pytest.raises(SystemExit) as ex:
        tsm.main(["--points", str(POINTS), "--scale", str(SCALE), "--cases",
                  CASE, "--configs", "ship", "--device", "cpu", "--json",
                  str(out)])
    rec = json.loads(out.read_text())
    (row,) = rec["rows"]
    assert list(row) == ROW_KEYS
    assert rec["provenance"]["device"] == "cpu"
    assert ex.value.code == (0 if row["pass"] else 1)
    assert f"{CASE:20s} ship" in capsys.readouterr().out

    (case,) = [c for c in jsc.stress_battery(points_per_scan=POINTS,
                                             scale=SCALE) if c.name == CASE]
    cfg = dataclasses.replace(jsm._configs(POINTS)[0][1],
                              **case.cfg_overrides)
    ds = case.build(np.random.default_rng(7))
    runner = JRunner(cfg)
    jsc.prime_prior_map(runner, case, np.random.default_rng(8))
    res = runner.run_dataset(ds, use_imu=True)
    s = case.settle
    ate = ate_rmse(res.poses_t[s:], np.asarray(ds.gt_poses_t)[s:])
    assert row["n_scans"] == len(ds.scans) == 25
    assert row["pass"] == bool(ate < case.ate_bound) and row["check_ok"]
    assert abs(row["ate_m"] - ate) <= ATE_TOL_M, (row["ate_m"], ate)


def test_stages_on_a_tiny_config(capsys):
    results = tprof.main(["stages", "--reps", "2", "--warm-scans", "12",
                          "--config", "base:" + TINY, "--device", "cpu"])
    assert list(results) == STAGES
    assert all(np.isfinite(v) and v > 0 for v in results.values())
    out = capsys.readouterr().out
    assert "device: cpu" in out and "sum of coarse stages" in out
    for name in STAGES:
        assert f"{name:38s}" in out


def test_ab_on_a_tiny_config(capsys):
    results = tprof.main(["ab", "base:" + TINY,
                          "parity:" + TINY, "--n", "10", "--reps", "1",
                          "--device", "cpu"])
    assert list(results) == ["base", "parity"]
    for rows in results.values():
        (sps, ate), = rows
        assert sps > 0 and np.isfinite(ate)
    out = capsys.readouterr().out
    assert "median" in out and "device: cpu" in out
