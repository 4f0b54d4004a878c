"""The per-layer arithmetic on a small recorded trace, and the kernel
counts against ``chip_smoke.py``'s bounds at the shapes of PERF.md's
kernel table."""

import json

import pytest

from odombench import harness, registry, trace
from odombench.tests.tiny import BENCH, ROOT

# two steps of 10 ms: host ranges, ops, and device work with gaps
EVENTS = [
    ("step.frontend", False, 0.0, 2000.0),
    ("step.registration", False, 2000.0, 5000.0),
    ("step.smoother", False, 5000.0, 10000.0),
    ("step.frontend", False, 10000.0, 11000.0),
    ("step.registration", False, 11000.0, 14000.0),
    ("step.smoother", False, 14000.0, 20000.0),
    ("aten::add", False, 100.0, 110.0),
    # vmap records an op again inside itself: one op
    ("aten::add", False, 101.0, 109.0),
    ("aten::add", False, 200.0, 210.0),
    ("aten::matmul", False, 5100.0, 5200.0),
    ("superodom::matmul", False, 5100.0, 5300.0),
    ("cudaLaunchKernel", False, 300.0, 305.0),
    ("plane_fit_kernel(float const*)", True, 3000.0, 3010.0),
    ("plane_fit_kernel(float const*)", True, 12000.0, 12010.0),
    ("gn_kernel(GnArgs)", True, 3005.0, 3030.0),  # overlaps the one above
    ("elementwise_kernel", True, 6000.0, 7000.0),
    ("Memcpy DtoH", True, 19990.0, 20010.0),  # runs past the window
    # a host range's shadow on the device's timeline: not device work
    ("step.smoother", True, 5000.0, 10000.0),
    ("window", True, 0.0, 20000.0),
]


def summary():
    return trace.summarise(EVENTS, steps=2, window=(0.0, 20000.0))


def test_summary_of_a_recorded_trace():
    s = summary()
    assert s.window_us == 20000.0
    # union: [3000, 3030] + [6000, 7000] + [12000, 12010] + [19990, 20000]
    assert s.busy_us == pytest.approx(30 + 1000 + 10 + 10)
    assert s.range_ms_per_step("step.smoother") == pytest.approx(5.5)
    assert s.range_ms_per_step("step.map_update") is None
    assert s.ops_matching("aten::") == 3
    assert s.ops_matching("superodom::") == 1
    assert s.device_us["plane_fit_kernel(float const*)"] == 20.0
    # the longest gaps: [12010, 19990] began in step.registration, [7000,
    # 12000] in step.smoother, [0, 3000] in step.frontend
    assert s.idle_gaps[:3] == [("step.registration", pytest.approx(0.00798)),
                               ("step.smoother", pytest.approx(0.005)),
                               ("step.frontend", pytest.approx(0.003))]
    top = s.device_top(2)
    assert top[0] == ("elementwise_kernel", pytest.approx(1e-3))


def _record(s, **kw):
    cell = registry.cell(ROOT, "os1_128_ship.fleet_replay")
    rec = harness.RunRecord(cell=cell, instances=4, steps=30, window_s=12.0,
                            setup_s=33.0,
                            peak_window_bytes=3 * 2 ** 20, trace=s)
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_readers_on_the_recorded_trace():
    s = summary()
    rec = _record(s, kernel_bound_us={"plane_fit": 5.0, "gn": 1.0},
                  kernel_us={"plane_fit": 20.0, "gn": 25.0})

    def read(name):
        return registry.reader(BENCH, name)(rec)

    assert read("scans_per_s") == 4 * 30 / 12.0
    assert read("setup_s") == 33.0
    assert read("frontend_host_ms") == pytest.approx(1.5)
    assert read("registration_host_ms") == pytest.approx(3.0)
    assert read("smoother_host_ms") == pytest.approx(5.5)
    assert read("map_update_host_ms") is None
    assert read("dispatch_ops_per_step") == 1.5
    assert read("invariant_calls_per_step") == 0.5
    assert read("hand_kernels_roofline") == pytest.approx(100 * 6 / 45)
    assert read("hand_kernel_us_per_step") == pytest.approx(22.5)
    assert read("device_idle_share") == pytest.approx(1 - 1050 / 20000)
    assert read("peak_mem_mib") == 3.0
    # no trace, nothing to read: the metric is left out, never 0
    bare = _record(None)
    for name in ("frontend_host_ms", "dispatch_ops_per_step",
                 "hand_kernels_roofline", "device_idle_share"):
        assert registry.reader(BENCH, name)(bare) is None


def _bound_us(launch):
    b, o = launch
    return max(b / harness.HBM_BYTES_PER_S, o / harness.F32_OPS_PER_S) * 1e6


@pytest.mark.parametrize("kernel, data, want_us", [
    # PERF.md's kernel table, ship shapes (2,048 features, k 5, 16-point
    # cells, buckets of 128): K1 0.105 (511 touched rows), K2 0.413 (5,403
    # live slot rows), K3 0.083, K4 gn_solve 0.023 and normal_system 0.020
    ("octant_lookup", {"touched": 511}, [0.105]),
    ("knn_select", {"live": 5403, "found": 16384}, [0.413, 0.413]),
    ("plane_fit", {}, [0.083, 0.083]),
    ("gn", {}, [0.023, 0.023, 0.020]),
])
def test_counts_equal_chip_smoke_bounds_ship(kernel, data, want_us):
    cell = registry.cell(ROOT, "os1_128_ship.fleet_replay")
    launches = registry.kernel_counts(BENCH)[kernel].count(cell, data)
    assert [round(_bound_us(x), 3) for x in launches] == want_us


def _vlp16_cell():
    """The VLP-16 configuration's cell (its files are kept for a later
    manifest entry; PERF.md)."""
    return registry.Cell(
        name="vlp16_ship.fleet_replay", chips=1,
        config=json.loads((BENCH / "configs" / "vlp16_ship.json")
                          .read_text()),
        traffic=json.loads((BENCH / "traffic" / "fleet_replay.json")
                           .read_text()),
        end_to_end=[], per_layer=[], folder=BENCH)


def test_counts_equal_chip_smoke_bounds_vlp16():
    """K10 at path V's 10,923 lanes: 0.046 us; K2 once a round (4)."""
    cell = _vlp16_cell()
    counts = registry.kernel_counts(BENCH)
    assert [round(_bound_us(x), 3) for x in
            counts["voxel_claim"].count(cell, {})] == [0.046]
    assert len(counts["knn_select"].count(
        cell, {"live": 1, "found": 1})) == 4
    assert counts["voxel_claim"].count(
        registry.cell(ROOT, "os1_128_ship.fleet_replay"), {}) is None
    # a count that needs the reference's lookups has nothing without them
    assert counts["octant_lookup"].count(cell, {}) is None
