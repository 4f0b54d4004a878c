"""The CUDA kernels against their plain PyTorch versions on the card, at
shapes and cases the main path does not reach: odd query counts, other
cell capacities, k = 10, missing slots, tied distances; the Gauss-Newton
kernel at row counts that do not fill its cluster's blocks,
with the axis hold biting, an enabled prior, a non-finite system, and
repeat runs; a replay repeated over poisoned freed memory; and the
wrappers' input checks.  Needs a CUDA device and nvcc; elsewhere every
test skips.

Run on the GPU machine (no JAX there, so without the JAX conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from superodom_tpu_torch import kernels, mapstate, registration  # noqa: E402
from superodom_tpu_torch.config import MapConfig, RuntimeParams  # noqa: E402
from superodom_tpu_torch.config import ship_config  # noqa: E402
from superodom_tpu_torch.geometry import Pose, quat_mul, so3_exp  # noqa: E402
from superodom_tpu_torch.io.datasets import BoxWorld, make_dataset  # noqa: E402
from superodom_tpu_torch.runner import OdometryRunner  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run "
                    "only on the card")
    return torch.device("cuda")


def _map(dev, cap, seed):
    """A map filled by the port's insert from clustered random points."""
    cfg = MapConfig(cell_size=1.0, table_size=1 << 12, cell_capacity=cap)
    g = torch.Generator(device="cpu").manual_seed(seed)
    centers = torch.rand((40, 3), generator=g) * 12.0 - 6.0
    pts = (centers[torch.randint(0, 40, (4000,), generator=g)]
           + 0.4 * torch.randn((4000, 3), generator=g)).to(dev)
    m = mapstate.empty_map(cfg, device=dev)
    for i in range(4):
        sl = slice(1000 * i, 1000 * (i + 1))
        m = mapstate.insert(m, cfg, pts[sl].contiguous(),
                            torch.ones(1000, dtype=torch.bool, device=dev),
                            torch.tensor(0.05, device=dev))
    q = (pts[:333] + 0.1 * torch.randn((333, 3), generator=g).to(dev))
    return cfg, m, q.contiguous()


@pytest.mark.parametrize("cap,k", [(16, 5), (24, 10), (32, 5)])
def test_lookup_and_select_match_plain(dev, cap, k):
    cfg, m, q = _map(dev, cap, seed=cap)
    s_k = kernels.octant_lookup(m.keys, q, cfg.cell_size)
    s_r = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
    assert torch.equal(s_k, s_r) and (s_r >= 0).any() and (s_r < 0).any()
    out_k = kernels.knn_select(m.pts, s_r, q, k)
    out_r = mapstate.knn_select_reference(m.pts, s_r, q, k)
    for a, b in zip(out_k, out_r):
        assert torch.equal(a, b)


def test_select_ties_go_to_the_lower_lane(dev):
    C = 8
    pts = torch.full((64, 3 * C), 1e30, device=dev)
    offs = torch.tensor([[0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5], [-0.5, 0, 0],
                         [0, -0.5, 0], [0, 0, -0.5], [1, 0, 0], [0, 1, 0]],
                        device=dev)
    for row in (3, 9):
        for j in range(C):
            for a in range(3):
                pts[row, a * C + j] = 1.0 + offs[(j + row) % 8, a]
    slots = torch.tensor([[3, -1, 9, -1, -1, 3, -1, -1]], dtype=torch.int32,
                         device=dev)
    q = torch.ones((1, 3), device=dev)
    out_k = kernels.knn_select(pts, slots, q, 8)
    out_r = mapstate.knn_select_reference(pts, slots, q, 8)
    for a, b in zip(out_k, out_r):
        assert torch.equal(a, b)
    assert torch.all(out_k[1] == 0.25)
    assert torch.all(out_k[3][0, 1:] > out_k[3][0, :-1])


def test_plane_fit_and_normal_system_match_plain(dev):
    cfg, m, q = _map(dev, 16, seed=5)
    slots = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
    neigh, sq, nvalid, _ = mapstate.knn_select_reference(m.pts, slots, q, 5)
    mask = torch.arange(q.shape[0], device=dev) % 7 != 0
    pose = Pose(quat_mul(so3_exp(torch.tensor([0.01, -0.02, 0.03],
                                              device=dev)),
                         torch.tensor([1.0, 0, 0, 0], device=dev)),
                torch.tensor([0.1, -0.2, 0.05], device=dev))
    res = torch.tensor(0.3, device=dev)
    args = (neigh.contiguous(), sq.contiguous(), nvalid.contiguous(), mask,
            q, pose.q.contiguous(), res)
    out_k = kernels.plane_fit(*args)
    out_r = registration.plane_fit_reference(*args)
    for a, b in zip(out_k, out_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert out_r[3].sum() > 10
    args4 = (q, out_r[0].contiguous(), out_r[1], out_r[2], out_r[3],
             pose.q.contiguous(), pose.t.contiguous(), 3.0 * res)
    with pytest.raises(ValueError):  # the wrappers take contiguous inputs
        kernels.plane_fit(neigh, sq, *args[2:])
    H_k, g_k, c_k = kernels.normal_system(*args4)
    H_r, g_r, c_r = registration.normal_system_reference(*args4)
    scale = float(H_r.abs().max())
    assert float((H_k - H_r).abs().max()) <= 1e-5 * scale
    assert float((g_k - g_r).abs().max()) <= 1e-5 * float(g_r.abs().max())
    assert torch.equal(H_k, kernels.normal_system(*args4)[0])  # no atomics


GN_TOL = 1e-5  # pose: metres and quaternion components


def _gn_case(dev, m):
    """``m`` correspondences fitted by the plain K1-K3 at a pose perturbed
    from the one that maps them onto the map."""
    cfg, mp, world = _map(dev, 16, seed=11)
    world = world[:m].contiguous()
    true = Pose(so3_exp(torch.tensor([0.02, -0.01, 0.03], device=dev)),
                torch.tensor([0.3, -0.2, 0.1], device=dev))
    p_body = true.inverse().apply(world).contiguous()
    pose0 = Pose(quat_mul(so3_exp(torch.tensor([0.004, -0.003, 0.006],
                                               device=dev)), true.q),
                 true.t + torch.tensor([0.03, -0.02, 0.01], device=dev))
    w_pt = pose0.apply(p_body).contiguous()
    slots = mapstate.octant_lookup_reference(mp.keys, w_pt, cfg.cell_size)
    neigh, sq, nvalid, _ = mapstate.knn_select_reference(mp.pts, slots, w_pt,
                                                         5)
    res = torch.tensor(0.3, device=dev)
    fit = registration.plane_fit_reference(
        neigh.contiguous(), sq.contiguous(), nvalid.contiguous(),
        torch.ones(m, dtype=torch.bool, device=dev), w_pt,
        pose0.q.contiguous(), res)
    planes = registration.PlaneCorrs(p_body, *fit)
    return pose0, planes, RuntimeParams(torch.tensor(0.1, device=dev), res)


def _prior(pose0, enabled):
    dev = pose0.t.device
    return registration.PosePrior(
        pose=Pose(pose0.q, pose0.t + 0.05),
        information=torch.tensor([40.0, 50.0, 60.0, 10.0, 10.0, 0.0],
                                 device=dev),
        enabled=torch.tensor(enabled, device=dev))


def _solve_both(pose0, planes, rt, **kw):
    """The kernel's solve (twice) and the plain solve on the same card."""
    args = (pose0, planes, None, rt, 4)
    kw = dict(dict(hold_enabled=torch.tensor(True, device=pose0.t.device)),
              **kw)
    n = kernels.launch_counts["gn_solve"]
    pk, sk = registration.gauss_newton_solve(*args, **kw)
    pk2, sk2 = registration.gauss_newton_solve(*args, **kw)
    assert kernels.launch_counts["gn_solve"] == n + 2
    pr, sr = registration.gauss_newton_solve_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pk.q, pk2.q) and torch.equal(pk.t, pk2.t)  # no atomics
    assert bool(sk) == bool(sk2) == bool(sr)
    assert float((pk.q - pr.q).abs().max()) <= GN_TOL
    assert float((pk.t - pr.t).abs().max()) <= GN_TOL
    return pk, pr


@pytest.mark.parametrize("m", [333, 100, 7])
def test_gn_solve_matches_plain(dev, m):
    """M not a multiple of the cluster's slice (333), smaller than one
    block (100), smaller than a warp (7); main-path hold and prior."""
    pose0, planes, rt = _gn_case(dev, m)
    pk, _ = _solve_both(pose0, planes, rt, prior=_prior(pose0, False),
                        axis_hold_min=10)
    if m > 100:
        assert float((pk.t - pose0.t).abs().max()) > 1e-3  # it moved
    # the n_iters = 0 mode: the normal system at the given pose
    args = (planes.p_body, planes.normal, planes.d, planes.coeff,
            planes.valid, pose0.q.contiguous(), pose0.t.contiguous(),
            3.0 * rt.plane_res)
    H_k, g_k, c_k = kernels.normal_system(*args)
    H_r, g_r, c_r = registration.normal_system_reference(*args)
    scale = float(H_r.abs().max())
    assert float((H_k - H_r).abs().max()) <= 1e-5 * scale
    assert float((g_k - g_r).abs().max()) <= 1e-5 * scale
    assert torch.equal(H_k, kernels.normal_system(*args)[0])


def test_gn_solve_hold_prior_and_guard(dev):
    pose0, planes, rt = _gn_case(dev, 333)
    hold = dict(axis_hold_min=10000, axis_hold_frac=0.5)
    assert registration.axis_hold_mask(planes, **hold).any()
    _solve_both(pose0, planes, rt, **hold)  # the hold bites
    _solve_both(pose0, planes, rt, prior=_prior(pose0, True), **hold)
    _solve_both(pose0, planes, rt, prior=_prior(pose0, True),
                a_mult=torch.tensor(0.25, device=dev))
    # a non-finite system: delta is zeroed, the pose stays
    i = int(torch.nonzero(planes.valid)[0])
    coeff = planes.coeff.clone()
    coeff[i] = float("nan")
    pk, pr = _solve_both(pose0, planes._replace(coeff=coeff), rt, **hold)
    assert torch.equal(pk.t, pose0.t)


def test_replay_repeats_bit_for_bit(dev):
    """Two replays of the same OS1-128 scans in one process give the same
    poses to the bit, with the freed device memory filled with NaN in
    between: no kernel reads memory it was not given, and no reduction
    depends on the order blocks run in."""
    cfg = ship_config("os1")
    ds = make_dataset(np.random.default_rng(7), n_scans=20,
                      points_per_scan=cfg.sensor.max_points,
                      world=BoxWorld(half_extent=np.array([40.0, 30.0, 8.0])),
                      radius=5.0, laps=0.5 * 20 / 120.0, distortion=True)
    poses = []
    n = kernels.launch_counts["gn_solve"]
    for _ in range(2):
        res = OdometryRunner(cfg, device=dev).run_dataset(ds)
        poses.append(np.concatenate([res.poses_t, res.poses_q], axis=1))
        junk = [torch.full(((1 << k) + 3 * j,), float("nan"), device=dev)
                for k in range(2, 23) for j in range(4)]
        del junk
    assert kernels.launch_counts["gn_solve"] - n == 2 * sum(
        s["n_iterations"] for s in res.stats)
    assert np.isfinite(poses[0]).all()
    np.testing.assert_array_equal(poses[0], poses[1])


def test_wrappers_check_inputs_and_count(dev):
    cfg, m, q = _map(dev, 16, seed=7)
    before = dict(kernels.launch_counts)
    kernels.octant_lookup(m.keys, q, cfg.cell_size)
    assert kernels.launch_counts["octant_lookup"] == \
        before["octant_lookup"] + 1
    qt = (torch.tensor([1.0, 0, 0, 0], device=dev), torch.zeros(3, device=dev))
    z = torch.zeros((60000, 3), device=dev)
    b = torch.zeros(60000, dtype=torch.bool, device=dev)
    s = torch.zeros(60000, device=dev)
    with pytest.raises(ValueError):  # 60,000 rows exceed the cluster's memory
        kernels.normal_system(z, z, s, s, b, *qt, s[0])
    # 20,000 rows: more than the 48 KB of shared memory a block gets unasked
    z, b, s = z[:20000], b[:20000], s[:20000]
    H, _, _ = kernels.normal_system(z, z, s, s, b, *qt, s[0] + 1.0)
    assert kernels.launch_counts["normal_system"] == \
        before["normal_system"] + 1 and float(H.abs().max()) == 0.0
    with pytest.raises(ValueError):
        kernels.octant_lookup(m.keys, q.double(), cfg.cell_size)
    with pytest.raises(ValueError):
        kernels.octant_lookup(m.keys, q.t(), cfg.cell_size)
    with pytest.raises(ValueError):
        kernels.knn_select(m.pts, torch.zeros((5, 8), dtype=torch.int32,
                                              device=dev), q, 5)
    with pytest.raises(ValueError):
        kernels.octant_lookup(m.keys.cpu(), q, cfg.cell_size)
    # a CUDA tensor always reaches the kernel through the dispatcher
    n = kernels.launch_counts["octant_lookup"]
    mapstate.octant_lookup(m.keys, q, cfg.cell_size)
    assert kernels.launch_counts["octant_lookup"] == n + 1
    assert np.isfinite(kernels.build_seconds or 0.0)
