"""The CUDA kernels against their plain PyTorch versions on the card, at
shapes and cases the main path does not reach: odd query counts, other
cell capacities, k = 10, missing slots, tied distances; the octant lookup
over bucket sizes and counts, duplicate keys, wrapped and boundary cells;
the plane fit, bit for bit, over k (templated and
generic instances), tile heads and tails, unaligned base pointers,
invalid, NaN and inf rows; the Gauss-Newton kernel at row counts that do not fill its cluster's blocks,
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


def _map(dev, cap, seed, nq=333):
    """A map filled by the port's insert from clustered random points, and
    ``nq`` queries near its points."""
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
    q = (pts[:nq] + 0.1 * torch.randn((nq, 3), generator=g).to(dev))
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


def _wall_map(dev, seed, nq):
    """A map of three noisy walls (x = 5, y = 5, z = 5), dense enough that
    16 neighbours lie within the plane fit's reach, and ``nq`` queries
    near them."""
    cfg = MapConfig(cell_size=1.0, table_size=1 << 12, cell_capacity=16)
    g = torch.Generator(device="cpu").manual_seed(seed)
    pts = torch.rand((8000, 3), generator=g) * 8.0 - 4.0
    wall = torch.randint(0, 3, (8000,), generator=g)
    pts[torch.arange(8000), wall] = 5.0
    pts = (pts + 0.02 * torch.randn((8000, 3), generator=g)).to(dev)
    m = mapstate.empty_map(cfg, device=dev)
    for i in range(4):
        sl = slice(2000 * i, 2000 * (i + 1))
        m = mapstate.insert(m, cfg, pts[sl].contiguous(),
                            torch.ones(2000, dtype=torch.bool, device=dev),
                            torch.tensor(0.05, device=dev))
    q = pts[:nq] + 0.05 * torch.randn((nq, 3), generator=g).to(dev)
    return cfg, m, q.contiguous()


def _keys_table(cells, nb, B, dev):
    """A key table int32[nb, B] holding ``cells`` (int [N, 3]), each in the
    first free lane of its bucket row, as the map's insert places them;
    cells that find their row full are dropped."""
    packed = mapstate.pack_cells(torch.as_tensor(cells, dtype=torch.int32))
    bucket = mapstate._bucket_of(packed, nb)
    keys = np.full((nb, B), -1, np.int32)
    fill = np.zeros(nb, np.int64)
    for p, b in zip(packed.tolist(), bucket.tolist()):
        if fill[b] < B and p not in keys[b, :fill[b]]:
            keys[b, fill[b]] = p
            fill[b] += 1
    return torch.from_numpy(keys).to(dev)


def _lookup_both(keys, q, cell_size):
    s_k = kernels.octant_lookup(keys, q, cell_size)
    s_r = mapstate.octant_lookup_reference(keys, q, cell_size)
    torch.cuda.synchronize()
    assert s_k.dtype == torch.int32 and s_k.shape == (q.shape[0], 8)
    assert torch.equal(s_k, s_r)
    return s_r


@pytest.mark.parametrize("nb", [1, 64, 512])
@pytest.mark.parametrize("B", [32, 64, 128, 256])
def test_octant_lookup_bucket_shapes(dev, B, nb):
    """Every bucket size and count: B = 128 is the instance with the row's
    vector count known when compiled, the others take the generic one."""
    rng = np.random.default_rng(B + nb)
    cells = rng.integers(-7, 8, size=(min(nb * B, 1500), 3))
    keys = _keys_table(cells, nb, B, dev)
    q = torch.from_numpy(rng.uniform(-8.0, 8.0, (500, 3)).astype(np.float32))
    s = _lookup_both(keys, q.to(dev), 1.0)
    assert (s >= 0).any() and (s < 0).any()


@pytest.mark.parametrize("nq", [0, 1, 2048])
def test_octant_lookup_query_counts(dev, nq):
    rng = np.random.default_rng(nq)
    keys = _keys_table(rng.integers(-7, 8, size=(1500, 3)), 512, 128, dev)
    q = torch.from_numpy(rng.uniform(-8.0, 8.0, (nq, 3)).astype(np.float32))
    s = _lookup_both(keys, q.to(dev), 1.0)
    assert nq == 0 or (s >= 0).any()


@pytest.mark.parametrize("B,lanes", [(128, (70, 5)), (128, (33, 32)),
                                     (128, (127, 0)), (32, (31, 9)),
                                     (256, (200, 130))])
def test_octant_lookup_duplicate_key_takes_the_lowest_lane(dev, B, lanes):
    """A row that holds the key twice (in one 16-byte vector, in vectors
    of different lanes of a probe): the lowest index wins."""
    nb = 64
    cell = torch.tensor([[2, -3, 1]], dtype=torch.int32)
    packed = int(mapstate.pack_cells(cell)[0])
    b = int(mapstate._bucket_of(mapstate.pack_cells(cell), nb)[0])
    keys = torch.full((nb, B), -1, dtype=torch.int32)
    keys[b, list(lanes)] = packed
    q = torch.tensor([[2.25, -2.75, 1.25]], device=dev)
    s = _lookup_both(keys.to(dev), q, 1.0)
    assert int(s[0, 0]) == b * B + min(lanes) and int((s >= 0).sum()) == 1


def test_octant_lookup_negative_and_wrapped_cells(dev):
    """Cells below zero and on both sides of the +-512-cell wrap of the
    10-bit key fields."""
    edge = [-513, -512, -511, -2, -1, 0, 1, 510, 511, 512]
    cells = np.array([(x, y, z) for x in edge for y in (-1, 0, 511)
                      for z in (-512, 0)])
    keys = _keys_table(cells, 64, 128, dev)
    rng = np.random.default_rng(3)
    q = np.stack([rng.choice(edge, 600) + rng.uniform(0, 1, 600),
                  rng.choice([-1, 0, 511], 600) + rng.uniform(0, 1, 600),
                  rng.choice([-512, 0], 600) + rng.uniform(0, 1, 600)], 1)
    s = _lookup_both(keys, torch.from_numpy(q.astype(np.float32)).to(dev),
                     1.0)
    assert (s >= 0).sum() > 600 and (s < 0).any()


@pytest.mark.parametrize("cell_size", [1.0, 0.4, 0.3])
def test_octant_lookup_boundary_queries(dev, cell_size):
    """Queries exactly on a cell boundary and on the half cell, where the
    quotient's rounding decides the cell and the side."""
    rng = np.random.default_rng(11)
    keys = _keys_table(rng.integers(-6, 7, size=(1200, 3)), 64, 128, dev)
    steps = torch.arange(-10, 11, dtype=torch.float32) * 0.5  # cells, halves
    g = torch.stack(torch.meshgrid(steps, steps[::3], steps[::5],
                                   indexing="ij"), -1).reshape(-1, 3)
    q = (g * torch.tensor(cell_size)).contiguous()
    s = _lookup_both(keys, q.to(dev), cell_size)
    assert (s >= 0).any() and (s < 0).any()


def _plane_fit_args(dev, k, nq, offset=False, seed=5):
    """K3's inputs from the plain K1 and K2 over the map of walls.  With
    ``offset`` every per-row tensor is a contiguous view that starts one
    row into its allocation, so no base pointer lies on a 16-byte line
    unless the row size happens to."""
    n = nq + 1 if offset else nq
    cfg, m, q = _wall_map(dev, seed, n)
    slots = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
    neigh, sq, nvalid, _ = mapstate.knn_select_reference(m.pts, slots, q, k)
    mask = torch.arange(n, device=dev) % 7 != 0
    quat = quat_mul(so3_exp(torch.tensor([0.01, -0.02, 0.03], device=dev)),
                    torch.tensor([1.0, 0, 0, 0], device=dev)).contiguous()
    rows = [neigh.contiguous(), sq.contiguous(), nvalid.contiguous(), mask,
            q]
    if offset:
        whole, rows = rows, [x[1:].contiguous() for x in rows]
        assert nq == 0 or all(
            x.data_ptr() == y.data_ptr() + y.stride(0) * y.element_size()
            for x, y in zip(rows, whole))
        assert nq == 0 or k % 4 == 0 or rows[0].data_ptr() % 16 != 0
    return (*rows, quat, torch.tensor(0.3, device=dev))


def _assert_plane_fit_bitwise(args):
    """Every output of the kernel equals the plain version's to the bit
    (NaN equal to NaN): normal and d on every row; coeff, valid, code and
    bins may differ only in a row that gate_margin_lanes flags.  Returns
    (the plain outputs, rows that differ)."""
    out_k = kernels.plane_fit(*args)
    out_r = registration.plane_fit_reference(*args)
    torch.cuda.synchronize()
    neigh, sq, nvalid, _, w_pt, quat, res = args
    near = registration.gate_margin_lanes(neigh, sq, nvalid, w_pt, quat,
                                          out_r[0], out_r[1], res)
    differ = torch.zeros_like(near)
    for i, (a, b) in enumerate(zip(out_k, out_r)):
        assert a.dtype == b.dtype and a.shape == b.shape
        ne = (a != b) & ~((a != a) & (b != b))
        ne = ne if ne.dim() == 1 else ne.any(dim=1)
        assert i >= 2 or not ne.any(), (
            f"{int(ne.sum())} rows differ in {('normal', 'd')[i]}")
        differ |= ne
    n_differ, n_far = int(differ.sum()), int((differ & ~near).sum())
    print(f"plane_fit: {n_differ} of {near.numel()} rows differ, "
          f"{int(near.sum())} rows at a gate margin")
    assert n_far == 0, (f"{n_far} rows away from every gate differ "
                        f"({n_differ} rows differ in all)")
    return out_r, n_differ


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("nq", [0, 1, 31, 33, 333, 2048, 2049])
@pytest.mark.parametrize("k", [3, 5, 10, 16])
def test_plane_fit_bitwise(dev, k, nq, offset):
    """k = 5 and 10 are the instances with k known when compiled, 3 and 16
    the generic one; the row counts end inside, on and just past a tile."""
    out_r, _ = _assert_plane_fit_bitwise(_plane_fit_args(dev, k, nq, offset))
    if nq >= 333:  # 3 points span a plane exactly: the PCA gate refuses
        assert (~out_r[3]).sum() > 10 and (k == 3 or out_r[3].sum() > 10)


@pytest.mark.parametrize("k", [5, 16])
def test_plane_fit_degenerate_rows(dev, k):
    """Rows with no valid neighbour, with NaN or inf neighbours (valid or
    not), and a whole launch that is invalid or masked out."""
    args = list(_plane_fit_args(dev, k, 333))
    neigh, sq, nvalid = (x.clone() for x in args[:3])
    nvalid[3] = False
    nvalid[4, k - 1] = False
    neigh[5, 0, 1] = float("nan")
    neigh[6, k - 1, 2] = float("inf")
    neigh[7, 1, 0] = float("-inf")
    neigh[8, 1] = float("nan")
    nvalid[8, 1] = False
    sq[9, k - 1] = float("inf")
    neigh[10] = neigh[10, :1]  # k identical points: an isotropic scatter
    out_r, _ = _assert_plane_fit_bitwise((neigh, sq, nvalid, *args[3:]))
    assert not out_r[3][3:11].any() and out_r[3].sum() > 10
    assert int(out_r[4][3]) == registration.MATCH_NOT_ENOUGH_NEIGHBORS
    dead, _ = _assert_plane_fit_bitwise(
        (neigh, sq, torch.zeros_like(nvalid), *args[3:]))
    assert not dead[3].any() and bool((dead[5] == -1).all())
    masked, _ = _assert_plane_fit_bitwise(
        (*args[:3], torch.zeros_like(args[3]), *args[4:]))
    assert not masked[3].any()
    assert bool((masked[4] == registration.MATCH_UNKNOWN).all())


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
    out_r, n_differ = _assert_plane_fit_bitwise(args)
    assert n_differ == 0  # bit for bit on every row of this case
    assert out_r[3].sum() > 10
    args4 = (q, out_r[0].contiguous(), out_r[1], out_r[2], out_r[3],
             pose.q.contiguous(), pose.t.contiguous(), 3.0 * res)
    with pytest.raises(ValueError):  # the wrappers take contiguous inputs
        kernels.plane_fit(neigh, sq, *args[2:])
    with pytest.raises(ValueError):  # k beyond the kernel's 16
        kernels.plane_fit(torch.zeros((4, 17, 3), device=dev),
                          torch.zeros((4, 17), device=dev),
                          torch.zeros((4, 17), dtype=torch.bool, device=dev),
                          mask[:4].contiguous(), q[:4].contiguous(),
                          pose.q.contiguous(), res)
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
    buf = torch.empty((m.keys.numel() + 1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # the table must be 16-byte aligned
        kernels.octant_lookup(buf[1:].view(m.keys.shape), q, cfg.cell_size)
    # a CUDA tensor always reaches the kernel through the dispatcher
    n = kernels.launch_counts["octant_lookup"]
    mapstate.octant_lookup(m.keys, q, cfg.cell_size)
    assert kernels.launch_counts["octant_lookup"] == n + 1
    assert np.isfinite(kernels.build_seconds or 0.0)
