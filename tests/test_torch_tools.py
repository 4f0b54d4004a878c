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
names.  ``tools.kernel_ab``'s cases and output checks, with the plain
versions standing in for the kernels (the builds run on the card only)."""

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

from superodom_tpu_torch import kernels, mapstate  # noqa: E402
from superodom_tpu_torch import registration  # noqa: E402
from superodom_tpu_torch.tools import kernel_ab  # noqa: E402
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


def test_kernel_ab_cases_and_checks(monkeypatch):
    """Every case of a recorded K9a / K9b / K10 / K11b launch set at fleets
    of 1 and 3 launches on fleet-shaped inputs and passes its check
    against itself; the checks catch a changed valid K9a or K9b lane, a
    changed K10 keep or round-2 neighbour and a changed K11b output off
    the gate margins, and pass a change in an invalid or a flagged
    lane."""
    import types

    from superodom_tpu_torch.ops import voxel

    g = np.random.default_rng(5)

    def reduced(w, nq=7):
        xyz = [torch.from_numpy(g.integers(-4, 5, (nq, w)).astype(np.float32))
               for _ in range(3)]
        valid = g.random((nq, w)) < 0.7
        valid[0] = False  # a query with no valid lane
        return (*xyz, torch.from_numpy(valid),
                torch.from_numpy(g.normal(size=(nq, 3)).astype(np.float32)))

    m, k = 24, 10
    line = g.normal(size=(m, 1, 3)) * np.linspace(0, 1, k)[None, :, None]
    neigh = torch.from_numpy(
        (line + 0.01 * g.normal(size=(m, k, 3))).astype(np.float32))
    edge = (neigh, (neigh ** 2).sum(-1), torch.ones(m, k, dtype=torch.bool),
            torch.ones(m, dtype=torch.bool), torch.tensor(0.5), 3, 0.2)
    C, nq = 16, 9
    pts = torch.from_numpy(g.integers(-3, 4, (12, 3 * C)).astype(np.float32))
    slots = torch.from_numpy(g.integers(-1, 12, (nq, 8)).astype(np.int32))
    slots[0] = -1  # a query with no valid lane
    q = torch.from_numpy(g.integers(-2, 3, (nq, 3)).astype(np.float32))
    cloud = torch.from_numpy(g.uniform(-5, 5, (300, 3)).astype(np.float32))
    live = torch.from_numpy(g.random(300) < 0.9)
    seen = {("select_reduced", 16): (*reduced(16), 5),
            ("select_reduced", 20): (*reduced(20), 10), "edge_fit": edge,
            ("reduce_candidates", 16): (pts, slots, q, 16, 5),
            ("voxel_claim", "path V"): (cloud, live, torch.tensor(0.5), 10)}

    def select(x, y, z, valid, q, k):
        return mapstate.select_knn_reduced_reference(
            mapstate.ReducedCandidates(x, y, z, valid), q, k)

    def each(fn, n, *args):
        outs = [fn(*(a[i] if isinstance(a, torch.Tensor) else a
                     for a in args)) for i in range(n)]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        return tuple(torch.stack(o) for o in zip(*outs))

    def fit(*args):
        return each(registration.edge_fit_reference, args[0].shape[0], *args)

    def reduce(*args):
        return each(lambda *a: (lambda r, n: r + n)(
            *mapstate.reduce_candidates_reference(*a)), args[0].shape[0],
            *args)

    def claim(*args):
        return each(voxel.voxel_downsample_scatter_reference,
                    args[0].shape[0], *args)[0]

    # a build with K9a's k nearest and K10's cluster form
    monkeypatch.setattr(kernels, "_lib",
                        types.SimpleNamespace(so_voxel_claim_clusters=None))
    monkeypatch.setattr(kernels, "select_reduced", select)
    monkeypatch.setattr(kernels, "edge_fit_batched", fit)
    monkeypatch.setattr(kernels, "reduce_candidates_batched", reduce)
    monkeypatch.setattr(kernels, "voxel_claim_batched", claim)
    runs = kernel_ab.cases(seen, fleets=(1, 3))
    assert sorted(runs) == sorted(
        [f"select_reduced {kk} of {w}, B={b}" for w, kk in ((16, 5), (20, 10))
         for b in (1, 3)] + [f"edge_fit {m} x {k}, B={b}" for b in (1, 3)]
        + [f"reduce_candidates 16{r}, B={b}" for b in (1, 3)
           for r in ("", " + round 2's 5")]
        + [f"voxel_claim path V 300 x 2^10, B={b}" for b in (1, 3)])
    for label, (launch, same) in runs.items():
        got = launch()
        b = int(label.rsplit("=", 1)[1])
        first = got if isinstance(got, torch.Tensor) else got[0]
        assert first.shape[0] == (b * 7 if "select" in label else b), label
        assert same(got, launch()), label

    a = select(*seen[("select_reduced", 16)])
    lane = tuple(int(i) for i in torch.nonzero(a[2])[0])
    off = tuple(int(i) for i in torch.nonzero(~a[2])[0])
    for at, ok in ((lane, False), (off, True)):
        sq = a[1].clone()
        sq[at] += 1.0
        assert kernel_ab.same_valid_lanes((a[0], sq, a[2]), a) is ok
    r = reduce(pts[None], slots[None], q[None], 16, 5)
    v = r[3]
    for at, ok in ((tuple(int(i) for i in torch.nonzero(v)[0]), False),
                   (tuple(int(i) for i in torch.nonzero(~v)[0]), True)):
        x = r[0].clone()
        x[at] += 1.0
        assert kernel_ab.same_valid_planes((x, *r[1:]), r) is ok
    round2 = runs["reduce_candidates 16 + round 2's 5, B=1"][1]
    sq = r[5].clone()
    sq[0, 0, 0] = float("nan")
    assert round2(r, r) and not round2((*r[:5], sq, r[6]), r)
    keep = runs["voxel_claim path V 300 x 2^10, B=1"]
    got = keep[0]()
    flipped = got.clone()
    flipped[0, 7] = ~flipped[0, 7]
    assert keep[1](got, got) and not keep[1](flipped, got)
    e = fit(*(t[None] for t in edge[:5]), *edge[5:])
    coeff = e[2].clone()
    coeff[0, 3] += 1.0
    changed = (*e[:2], coeff, *e[3:])
    near = torch.zeros(m, dtype=torch.bool)
    assert not kernel_ab.same_off_gates(changed, e, near)
    near[3] = True
    assert kernel_ab.same_off_gates(changed, e, near)
