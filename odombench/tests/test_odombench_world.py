"""The trajectories' lap wraps continuously in pose and time, and the
sequences are the seed's."""

import math

import numpy as np
import torch

from odombench import world
from odombench.tests.tiny import BENCH

import json

torch.set_num_threads(2)
P = json.loads((BENCH / "traffic" / "fleet_replay.json").read_text())


def test_lap_wrap_is_continuous_in_pose_and_time():
    n0, lap = P["static_scans"], P["lap_scans"]
    T = world.lap_time(P)
    t_end = torch.tensor([world.lap_start(P) + T], dtype=torch.float64)
    t_start = torch.tensor([world.lap_start(P)], dtype=torch.float64)
    q1, p1 = world.pose_at(P, t_end)
    q0, p0 = world.pose_at(P, t_start)
    assert torch.allclose(p1, p0, atol=1e-9)
    assert torch.allclose(q1.abs(), q0.abs(), atol=1e-9)  # q and -q
    # velocity just before the lap's end equals that just after its start
    h = 1e-4
    v_end = (world.pose_at(P, t_end)[1] - world.pose_at(P, t_end - h)[1]) / h
    v_start = (world.pose_at(P, t_start + h)[1]
               - world.pose_at(P, t_start)[1]) / h
    assert torch.allclose(v_end, v_start, atol=1e-3)
    # step indices: the lap repeats, each time one lap's period later
    assert world.step_index(P, n0 + lap - 1) == (n0 + lap - 1, 0)
    assert world.step_index(P, n0 + lap) == (n0, 1)
    assert world.step_index(P, n0 + 2 * lap + 3) == (n0 + 3, 2)
    for s in range(n0 + lap - 3, n0 + 3 * lap):
        idx, wraps = world.step_index(P, s)
        t = idx * P["scan_period"] + wraps * T
        assert math.isclose(t, s * P["scan_period"], abs_tol=1e-9)


def test_sequences_follow_the_seed():
    p = dict(P, static_scans=2, lap_scans=3, trajectories=2)
    a = world.make_trajectories(p, 512, 2 ** 31 + 7, "cpu")
    b = world.make_trajectories(p, 512, 2 ** 31 + 7, "cpu")
    c = world.make_trajectories(p, 512, 5, "cpu")
    assert len(a) == 2 and len(a[0].scans) == 5
    assert np.array_equal(a[1].scans[4].xyz_body, b[1].scans[4].xyz_body)
    assert np.array_equal(a[0].imu.acc, b[0].imu.acc)
    assert not np.array_equal(a[0].scans[0].xyz_body,
                              c[0].scans[0].xyz_body)
    s = a[0].scans[3]
    assert s.xyz_body.dtype == np.float32 and np.all(np.diff(s.t_rel) >= 0)
    # the gyro's mean at rest is its bias
    rest = a[0].imu.t < p["static_scans"] * p["scan_period"] - 0.02
    assert np.allclose(a[0].imu.gyr[rest].mean(0), p["gyr_bias"], atol=5e-4)
