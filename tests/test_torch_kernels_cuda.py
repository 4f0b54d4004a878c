"""The CUDA kernels against their plain PyTorch versions on the card, at
shapes and cases the main path does not reach: odd query counts, other
cell capacities, k = 10, missing slots, tied distances; the octant lookup
over bucket sizes and counts, duplicate keys, wrapped and boundary cells;
the plane fit, bit for bit, over k (templated and
generic instances), tile heads and tails, unaligned base pointers,
invalid, NaN and inf rows; the Gauss-Newton kernel at row counts that do not fill its cluster's blocks,
with the axis hold biting, an enabled prior, a non-finite system, and
repeat runs; the candidate reduction and the selection from it over cell
capacities, widths, k, query counts, rows with nothing valid and tied
distances, and the selection by rank at every group width (1-32
lanes, k = 1 and k = width, an odd query count, ties of three, a NaN
query); the voxel claim over lane counts, table sizes, a resolution
that changes on the device and repeat runs; the curvature edges over
wrapped lanes, ring boundaries, padded tails and NaN rows; the line fit
over query counts, ties in the inlier count (of two and of three lines),
rows with no or one valid neighbour and sentinel neighbours, every k of
its 16-lane group and an odd group count over a fleet; the Gauss-Newton kernel with 0, 1 and
512 edge rows beside 2,048 planes and the hold on edge votes alone;
replays of the four paths repeated over poisoned freed memory; the
chunked replay repeated at chunk sizes 20 and 4, preloaded and streamed,
and one chunk against its four steps; a SuperLoc replay (VIO and a
frozen prior map) repeated the same way; ``query_knn`` and
``gather_candidates`` against their CPU composition on a warm ship map;
K2's gathered mode bit for bit against its plain version (lane-granular
masks, ties, short rows, its input checks) and the library's
correspondence functions against the CPU;
the wrappers' input checks; every entry over three instances through
its vmap rule, each instance bit for bit its single launch (with one
tensor shared), the batched launches at n = 1 and at any instance
stride, the voxel claim with a resolution an instance, the curvature
stencil wrapping inside each instance, the line fit with a line
resolution an instance, a launch under vmap without its rule refused, and a batched
replay of two instances against their single replays.  Needs a CUDA device and nvcc; elsewhere every
test skips.

Run on the GPU machine (no JAX there, so without the JAX conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

from superodom_tpu_torch import frontend, kernel_ops, kernels  # noqa: E402
from superodom_tpu_torch import mapstate  # noqa: E402
from superodom_tpu_torch import registration  # noqa: E402
from superodom_tpu_torch.config import MapConfig, RuntimeParams  # noqa: E402
from superodom_tpu_torch.config import parity_config, ship_config  # noqa: E402
from superodom_tpu_torch.geometry import Pose, quat_mul, so3_exp  # noqa: E402
from superodom_tpu_torch.io.datasets import (  # noqa: E402
    BoxWorld,
    make_dataset,
    pole_lattice,
    ring_sweep,
)
from superodom_tpu_torch.ops import voxel  # noqa: E402
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


@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("B", [32, 128])
def test_octant_lookup_shard_window(dev, B, M):
    """K1 with a shard window (``mapstate.ShardedMap``): each of M shards
    of a table bit for bit its windowed plain version (global slots, -1
    outside the window), directly and through the vmap rule over three
    instances; merged by a maximum, the whole table's lookup; and a
    window that does not fit its table refused."""
    nb = 64
    rng = np.random.default_rng(B + M)
    keys = _keys_table(rng.integers(-7, 8, size=(1500, 3)), nb, B, dev)
    q = torch.from_numpy(rng.uniform(-8.0, 8.0, (700, 3)).astype(
        np.float32)).to(dev)
    whole = _lookup_both(keys, q, 1.0)
    nbl = nb // M
    merged = torch.full_like(whole, -1)
    for j in range(M):
        sh = keys[j * nbl:(j + 1) * nbl].contiguous()
        args = (sh, q, 1.0, j * nbl, nb)
        s_k = kernels.octant_lookup(*args)
        s_r = mapstate.octant_lookup_reference(*args)
        three = torch.func.vmap(kernel_ops.octant_lookup,
                                in_dims=(None, 0, None, None, None))(
            sh, torch.stack([q, q + 0.5, q - 0.25]), 1.0, j * nbl, nb)
        torch.cuda.synchronize()
        assert torch.equal(s_k, s_r)
        assert torch.equal(three[0], s_k)
        for i, d in ((1, 0.5), (2, -0.25)):
            assert torch.equal(three[i], mapstate.octant_lookup_reference(
                sh, (q + d).contiguous(), 1.0, j * nbl, nb))
        assert torch.all(s_k[s_k >= 0] // (nbl * B) == j)
        merged = torch.maximum(merged, s_k)
    assert torch.equal(merged, whole)
    with pytest.raises(ValueError, match="window"):
        kernels.octant_lookup(keys[:nbl].contiguous(), q, 1.0, nb, nb)


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
    H_k, g_k, c_k = registration.normal_system(*args4)
    H_r, g_r, c_r = registration.normal_system_reference(*args4)
    scale = float(H_r.abs().max())
    assert float((H_k - H_r).abs().max()) <= 1e-5 * scale
    assert float((g_k - g_r).abs().max()) <= 1e-5 * float(g_r.abs().max())
    assert torch.equal(H_k, registration.normal_system(*args4)[0])  # no atomics


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


def _solve_both(pose0, planes, rt, lines=None, **kw):
    """The kernel's solve (twice) and the plain solve on the same card."""
    args = (pose0, planes, lines, rt, 4)
    kw = dict(dict(hold_enabled=torch.tensor(True, device=pose0.t.device),
                   use_edges=lines is not None), **kw)
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
    H_k, g_k, c_k = registration.normal_system(*args)
    H_r, g_r, c_r = registration.normal_system_reference(*args)
    scale = float(H_r.abs().max())
    assert float((H_k - H_r).abs().max()) <= 1e-5 * scale
    assert float((g_k - g_r).abs().max()) <= 1e-5 * scale
    assert torch.equal(H_k, registration.normal_system(*args)[0])


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


def _replay_twice(dev, cfg, n_scans=20):
    """Two replays of the same scans in one process, the freed device
    memory filled with NaN in between; returns (the two pose arrays, the
    last replay's stats, the launches of both)."""
    ds = make_dataset(np.random.default_rng(7), n_scans=n_scans,
                      points_per_scan=cfg.sensor.max_points,
                      world=BoxWorld(half_extent=np.array([40.0, 30.0, 8.0])),
                      radius=5.0, laps=0.5 * n_scans / 120.0, distortion=True)
    poses = []
    before = dict(kernels.launch_counts)
    for _ in range(2):
        res = OdometryRunner(cfg, device=dev).run_dataset(ds)
        poses.append(np.concatenate([res.poses_t, res.poses_q], axis=1))
        junk = [torch.full(((1 << k) + 3 * j,), float("nan"), device=dev)
                for k in range(2, 23) for j in range(4)]
        del junk
    launched = {k: kernels.launch_counts[k] - before[k] for k in before}
    assert np.isfinite(poses[0]).all()
    np.testing.assert_array_equal(poses[0], poses[1])
    return poses, res.stats, launched


def test_replay_repeats_bit_for_bit(dev):
    """Two replays of the same OS1-128 scans in one process give the same
    poses to the bit, with the freed device memory filled with NaN in
    between: no kernel reads memory it was not given, and no reduction
    depends on the order blocks run in."""
    _, stats, launched = _replay_twice(dev, ship_config("os1"))
    assert launched["gn_solve"] == 2 * sum(s["n_iterations"] for s in stats)


@pytest.mark.parametrize("path", ["parity", "vlp16", "edges"])
def test_further_paths_replay_bit_for_bit(dev, path):
    """The same for the reference-envelope path (candidate refresh: the
    reduction's winners and the claim table are scratch that must be
    written before it is read), the VLP-16 default path (integer
    atomics: any arrival order gives the same table) and path E (the
    reference-envelope path with curvature edges: full-width scans, the
    edge map, the claim table of the edge stream)."""
    cfg = {"parity": parity_config("os1"), "vlp16": ship_config("vlp16"),
           "edges": dataclasses.replace(parity_config("os1"),
                                        use_edge_features=True)}[path]
    _, stats, launched = _replay_twice(dev, cfg)
    rounds = sum(s["n_iterations"] for s in stats)
    n = len(stats)
    # K9a gives round 2 its neighbours, K9b selects those of rounds 3..
    refreshing = sum(s["n_iterations"] > 1 for s in stats)
    assert launched["gn_solve"] == 2 * rounds
    if path == "edges":
        assert launched["knn_select"] == launched["octant_lookup"] == 4 * n
        assert launched["reduce_candidates"] == 4 * refreshing > 0
        assert launched["select_reduced"] == 4 * (rounds - n - refreshing) > 0
        assert launched["edge_fit"] == 2 * rounds
        assert launched["curvature_edges"] == launched["voxel_claim"] == 2 * n
        assert all(s["edge_stack"] > 0 for s in stats)
    elif path == "parity":
        assert launched["knn_select"] == 2 * n
        assert launched["select_reduced"] == 2 * (rounds - n - refreshing) > 0
        assert launched["reduce_candidates"] == 2 * refreshing > 0
        assert launched["voxel_claim"] == 0
    else:
        assert launched["knn_select"] == 2 * rounds
        assert launched["voxel_claim"] == 2 * n
        assert launched["reduce_candidates"] == 0


def _assert_reduced_match(pts, slots, q, w, k, q_shift=0.02):
    """K9a against its plain version, its k nearest against K9b on its own
    planes at the same queries (every lane, bit for bit) and against the
    plain version's (as K9b's contract); then K9b (from the plain
    version's lanes, at queries moved as a round of ICP moves them)
    against its own: ``valid`` identical and every value of a valid lane
    identical.  What a lane that is not valid holds is no part of the
    contract (the BIG sentinel, or a point of table row 0), except its
    distance, which is at least BIG / 2.  Returns both plain results."""
    out = kernels.reduce_candidates(pts, slots, q, w, k)
    red_k, near_k = out[:4], out[4:]
    red_r, near_r = mapstate.reduce_candidates_reference(pts, slots, q, w, k)
    near_b = kernels.select_reduced(*red_k, q, k)
    torch.cuda.synchronize()
    v = red_r.valid
    assert red_k[3].dtype == torch.bool and red_k[3].shape == v.shape
    assert torch.equal(red_k[3], v)
    for a, b in zip(red_k[:3], red_r[:3]):
        assert a.shape == b.shape and torch.equal(a[v], b[v])
    for a, b in zip(near_k, near_b):
        assert _same(a, b)
    vk = near_r[2]
    assert torch.equal(near_k[2], vk)
    assert torch.equal(near_k[0][vk], near_r[0][vk])
    assert torch.equal(near_k[1][vk], near_r[1][vk])
    assert bool((near_k[1][~vk] == mapstate.BIG).all())
    return red_r, _assert_select_match(red_r, (q + q_shift).contiguous(), k)


def _assert_select_match(red, q, k):
    sel_k = kernels.select_reduced(*red, q, k)
    sel_r = mapstate.select_knn_reduced_reference(red, q, k)
    torch.cuda.synchronize()
    vs = sel_r[2]
    assert torch.equal(sel_k[2], vs)
    assert torch.equal(sel_k[0][vs], sel_r[0][vs])
    assert torch.equal(sel_k[1][vs], sel_r[1][vs])
    assert bool((sel_k[1][~vs] >= mapstate.BIG * 0.5).all())
    return sel_r


@pytest.mark.parametrize("w,k", [(5, 5), (16, 5), (16, 10), (20, 5),
                                 (20, 10), (32, 5), (32, 32)])
@pytest.mark.parametrize("cap", [16, 24, 32])
def test_reduce_and_select_reduced_match_plain(dev, cap, w, k):
    """Capacities with and without the vector loads, the widths of the
    reference-envelope path (16), of its edge half (20), the least (w = k)
    and a whole warp (32); rows with fewer than w and fewer than k live
    candidates."""
    cfg, m, q = _map(dev, cap, seed=cap + w)
    slots = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
    red, sel = _assert_reduced_match(m.pts, slots, q, w, k)
    n_valid = red.valid.sum(1)
    assert (n_valid == w).any() and sel[2].any()
    assert w == 5 or (n_valid < w).any()
    # fewer valid lanes than k: every other row keeps its first three
    few = red.valid.clone()
    few[::2, 3:] = False
    sel = _assert_select_match(red._replace(valid=few),
                               (q - 0.01).contiguous(), k)
    assert not sel[2][::2, 3:].any() and sel[2][::2, :3].any()


@pytest.mark.parametrize("nq", [0, 1, 2047, 2048])
def test_reduce_and_select_reduced_query_counts(dev, nq):
    cfg, m, q = _map(dev, 16, seed=3, nq=nq)
    slots = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
    red, sel = _assert_reduced_match(m.pts, slots, q, 16, 5)
    assert red.x.shape == (nq, 16) and sel[0].shape == (nq, 5, 3)
    assert nq == 0 or red.valid.any()


def test_reduced_rows_with_nothing_valid(dev):
    """Rows whose eight slots are all missing, and a whole launch of
    them: nothing valid comes out of either kernel."""
    cfg, m, q = _map(dev, 16, seed=4)
    slots = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
    slots[::3] = -1
    red, sel = _assert_reduced_match(m.pts, slots, q, 16, 5)
    assert not red.valid[::3].any() and red.valid[1::3].any()
    assert not sel[2][::3].any()
    red, sel = _assert_reduced_match(m.pts, torch.full_like(slots, -1), q,
                                     16, 5)
    assert not red.valid.any() and not sel[2].any()


def test_reduced_ties_go_to_the_lower_lane(dev):
    """Three live slots that hold the same eight points: every distance
    occurs three or more times, and both kernels must order the tied
    lanes as the stable sort does."""
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
    red, sel = _assert_reduced_match(pts, slots, q, 16, 8, q_shift=0.0)
    assert red.valid.all() and sel[2].all()
    assert torch.all(sel[1] == 0.25)
    # the kernels' lanes that are not contract-bound agree here too: all
    # lanes are valid, so the outputs are equal as wholes
    for a, b in zip(kernels.reduce_candidates(pts, slots, q, 16, 8),
                    red + tuple(sel)):
        assert torch.equal(a, b)
    for a, b in zip(kernels.select_reduced(*red, q, 8), sel):
        assert torch.equal(a, b)


def test_reduced_nan_queries(dev):
    """Queries with a NaN coordinate of either sign: none of their lanes is
    valid, and K9a's k nearest are K9b's on its planes in every lane (NaN
    equal to NaN), at the surface and the edge widths."""
    cfg, m, q = _map(dev, 16, seed=9)
    slots = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
    q[3, 0] = float("nan")
    q[5] = -float("nan")
    q[8, 2] = -float("nan")
    for w, k in ((16, 5), (20, 10)):
        red, _ = _assert_reduced_match(m.pts, slots, q, w, k)
        assert not red.valid[[3, 5, 8]].any() and red.valid.any()


def _grid_reduced(dev, nq, w, seed):
    """Reduced lanes on an integer grid of 5 x 5 x 5 points and queries on
    it (distances tie in threes and more), every fifth row with no valid
    lane, row 1 three copies of one point at lanes 0, w // 2 and w - 1."""
    rng = np.random.default_rng(seed)
    x, y, z = (torch.from_numpy(rng.integers(-2, 3, (nq, w)).astype(
        np.float32)).to(dev) for _ in range(3))
    valid = torch.from_numpy(rng.random((nq, w)) < 0.8).to(dev)
    valid[::5] = False
    if nq > 1:
        for c in (x, y, z):
            c[1, [0, w // 2, w - 1]] = 1.0
        valid[1] = True
    q = torch.from_numpy(rng.integers(-1, 2, (nq, 3)).astype(
        np.float32)).to(dev)
    return mapstate.ReducedCandidates(x, y, z, valid), q


@pytest.mark.parametrize("nq", [1, 2, 333])
@pytest.mark.parametrize("w", [1, 2, 15, 16, 17, 20, 31, 32])
def test_select_reduced_by_rank(dev, w, nq):
    """K9b's selection by rank at every group width (two queries a warp up
    to 16 lanes, one above), k = 1 and k = w, an odd query count (the last
    half-warp group alone), rows with no valid lane and ties of three and
    more: the contract's lanes equal the plain version's, and with finite
    inputs the whole outputs are equal too."""
    red, q = _grid_reduced(dev, nq, w, seed=100 * w + nq)
    for k in sorted({1, w}):
        sel = _assert_select_match(red, q, k)
        for a, b in zip(kernels.select_reduced(*red, q, k), sel):
            assert torch.equal(a, b), (w, k)
        if nq > 1:
            assert not sel[2][::5].any()
    if nq > 1:  # three copies of one point: the lanes in order
        sel = kernels.select_reduced(*red, q, w)
        d1 = float(((q[1] - 1.0) ** 2).sum())
        at = (sel[1][1] == d1).nonzero().flatten().tolist()
        assert len(at) >= (3 if w >= 3 else w)


def test_select_reduced_nan_query(dev):
    """A query with a NaN coordinate: its valid lanes' distances are NaN,
    which the rank order puts after BIG as the plain version's sort puts
    NaN last; the whole outputs equal the plain version's (NaN equal to
    NaN), at both group widths."""
    for w, k in ((16, 5), (20, 10)):
        red, q = _grid_reduced(dev, 33, w, seed=w)
        q[2, 1] = float("nan")
        q[7] = float("nan")
        red.valid[7] = True
        got = kernels.select_reduced(*red, q, k)
        want = mapstate.select_knn_reduced_reference(red, q, k)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert _same(a, b), (w, k)
        assert not want[2][7].any() and bool(torch.isnan(want[1][7]).any())


def _cloud(dev, n, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    xyz = (torch.rand((n, 3), generator=g) * 60.0 - 30.0)
    xyz[: n // 2, 2] = -1.5  # a floor: many points a voxel
    mask = torch.rand((n,), generator=g) > 0.15
    return xyz.to(dev).contiguous(), mask.to(dev).contiguous()


@pytest.mark.parametrize("bits", [4, 17, 19, 20])
@pytest.mark.parametrize("n", [0, 1, 10923, 43691])
def test_voxel_claim_matches_plain(dev, n, bits):
    """The lane counts of a decimated VLP-16 and OS1-128 scan and the
    edges; the tables of those sensors and a 16-entry one that makes every
    lane collide (the claim table in a cluster's shared memory), and 2^20
    slots (the global form); the resolution changed on the device between
    launches; repeat runs identical (integer atomics)."""
    xyz, mask = _cloud(dev, n, seed=n + bits)
    res = torch.tensor(0.2, device=dev)
    keeps = []
    for r in (0.2, 0.8, 0.2):
        res.fill_(r)
        keep_k = kernels.voxel_claim(xyz, mask, res, bits)
        keep_r = voxel.voxel_downsample_scatter_reference(xyz, mask, res,
                                                          bits)
        torch.cuda.synchronize()
        assert keep_k.dtype == torch.bool and keep_k.shape == (n,)
        assert torch.equal(keep_k, keep_r)
        assert not (keep_k & ~mask).any()
        keeps.append(keep_k)
    assert torch.equal(keeps[0], keeps[2])
    if n > 1:
        assert keeps[0].any() and (keeps[0] != keeps[1]).any()
        assert int(keeps[0].sum()) <= min(1 << bits, int(mask.sum()))
    if n > 1 and bits == 4:
        assert int(keeps[0].sum()) == 16  # one survivor a table entry
    dead = kernels.voxel_claim(xyz, torch.zeros_like(mask), res, bits)
    assert not dead.any()


def test_voxel_claim_through_the_dispatcher(dev):
    """A CUDA tensor reaches the kernel, with the resolution as a device
    scalar or a Python number, negative coordinates included; the default
    table is four times the lane count."""
    xyz, mask = _cloud(dev, 3000, seed=1)
    n0 = kernels.launch_counts["voxel_claim"]
    a = voxel.voxel_downsample_scatter(xyz, mask, torch.tensor(0.2,
                                                               device=dev))
    b = voxel.voxel_downsample_scatter(xyz, mask, 0.2)
    assert kernels.launch_counts["voxel_claim"] == n0 + 2
    ref = voxel.voxel_downsample_scatter_reference(xyz, mask, 0.2)
    assert torch.equal(a, ref) and torch.equal(b, ref)
    assert torch.equal(a.cpu(), voxel.voxel_downsample_scatter(
        xyz.cpu(), mask.cpu(), 0.2))
    assert (xyz < 0).any()


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
    H, _, _ = registration.normal_system(z, z, s, s, b, *qt, s[0] + 1.0)
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
    # K9 and K10
    slots = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
    n = dict(kernels.launch_counts)
    red, _ = mapstate.reduce_candidates(m.pts, slots, q, 16, 5)
    mapstate.select_knn_reduced(red, q, 5)
    assert kernels.launch_counts["reduce_candidates"] == \
        n["reduce_candidates"] + 1
    assert kernels.launch_counts["select_reduced"] == n["select_reduced"] + 1
    assert kernels.launch_counts["knn_select"] == n["knn_select"]
    with pytest.raises(ValueError):  # a width beyond one warp
        kernels.reduce_candidates(m.pts, slots, q, 33, 5)
    with pytest.raises(ValueError):  # k beyond the width
        kernels.reduce_candidates(m.pts, slots, q, 16, 17)
    with pytest.raises(ValueError):  # k beyond the width
        kernels.select_reduced(*red, q, 17)
    with pytest.raises(ValueError):
        kernels.select_reduced(red.x, red.y, red.z.t(), red.valid, q, 5)
    with pytest.raises(ValueError):
        kernels.select_reduced(*red, q.cpu(), 5)
    xyz = q
    ok = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    res = torch.tensor(0.2, device=dev)
    with pytest.raises(ValueError):  # a table below 16 entries
        kernels.voxel_claim(xyz, ok, res, 3)
    with pytest.raises(ValueError):  # the resolution lives on the card
        kernels.voxel_claim(xyz, ok, res.cpu(), 14)
    with pytest.raises(ValueError):
        kernels.voxel_claim(xyz, ok.to(torch.uint8), res, 14)
    assert kernels.launch_counts["voxel_claim"] == n["voxel_claim"]


# ---------------------------------------------------------------- edges


def _assert_curvature_bitwise(xyz, ring, mask, thr=0.2, min_range=0.5):
    out_k = kernels.curvature_edges(xyz, ring, mask, 5, thr, min_range)
    out_r = frontend.curvature_edge_extraction_reference(
        xyz, ring, mask, 5, thr, min_range)
    torch.cuda.synchronize()
    assert out_k.dtype == torch.bool and torch.equal(out_k, out_r), (
        f"{int((out_k != out_r).sum())} of {out_r.numel()} lanes differ")
    return out_r


@pytest.mark.parametrize("case", ["ring_major", "zero_ring", "padded_nan",
                                  "tiny"])
def test_curvature_edges_bitwise(dev, case):
    """The OS1-128 sweep shape (128 rings x 1,024 azimuths) with its rings
    and with the replay's zero ring (the wrap is live: lanes 0-4 and
    N-5..N-1 see each other); a padded tail with NaN and inf rows; and
    clouds narrower than the stencil (every neighbour wraps, some more
    than once)."""
    xyz, ring = ring_sweep(128, 1024)
    xyz = torch.from_numpy(xyz).to(dev)
    ring = torch.from_numpy(ring).to(dev)
    mask = torch.ones(xyz.shape[0], dtype=torch.bool, device=dev)
    if case == "ring_major":
        out = _assert_curvature_bitwise(xyz, ring, mask)
        edges_every = _assert_curvature_bitwise(xyz, ring, mask, thr=-1.0)
        assert not edges_every[:5].any() and edges_every[5:1019].all()
        assert out.sum() > 500
    elif case == "zero_ring":
        zero = torch.zeros_like(ring)
        edges_every = _assert_curvature_bitwise(xyz, zero, mask, thr=-1.0)
        assert edges_every[:5].all() and edges_every[-5:].all()
        _assert_curvature_bitwise(xyz, zero, mask)
    elif case == "padded_nan":
        xyz, mask = xyz.clone(), mask.clone()
        xyz[-777:] = 0.0
        mask[-777:] = False
        xyz[1000, 1] = float("nan")
        xyz[2000] = float("inf")
        xyz[3000, 2] = float("-inf")
        out = _assert_curvature_bitwise(xyz, ring, mask)
        assert not out[[1000, 2000, 3000]].any() and not out[-782:].any()
        assert not out[995:1006].any() and out.sum() > 500
    else:
        for n in (1, 2, 7, 11, 12, 300):
            x, r, m = (t[:n].contiguous() for t in (xyz, ring, mask))
            _assert_curvature_bitwise(x, r, m, thr=-1.0)
            _assert_curvature_bitwise(x, torch.zeros_like(r), m)
        empty = _assert_curvature_bitwise(xyz[:0], ring[:0], mask[:0])
        assert empty.shape == (0,)


def _edge_case(dev, ne=512, npl=2048, seed=3, k=10):
    """Path E's shapes (capacity 16, 2 m cells) on a pole lattice (the
    edge map) inside a box room (the surface map), both filled by the
    port's insert: ``ne`` line correspondences (plain K1, K2 at ``k``,
    plain K11b) and ``npl`` plane ones (plain K1-K3) at a pose perturbed
    from the true one.  Returns (pose0, planes, lines, rt, (neigh, sq,
    nvalid, mask) of the lines)."""
    rng = np.random.default_rng(seed)
    cfg = MapConfig(cell_capacity=16)
    pole = torch.from_numpy(pole_lattice(rng)).to(dev)
    walls = rng.uniform(-8, 8, (6, 3000, 3))
    for i in range(6):
        walls[i, :, i // 2] = 8.0 if i % 2 else -8.0
    walls = torch.from_numpy(walls.reshape(-1, 3).astype(np.float32)).to(dev)
    rt = RuntimeParams(torch.tensor(0.1, device=dev),
                       torch.tensor(0.2, device=dev))
    maps = []
    for pts, res in ((pole, 0.03), (walls, 0.2)):
        m = mapstate.empty_map(cfg, device=dev)
        for chunk in torch.split(pts, 1000):
            m = mapstate.insert(m, cfg, chunk.contiguous(),
                                torch.ones(len(chunk), dtype=torch.bool,
                                           device=dev),
                                torch.tensor(res, device=dev))
        maps.append(m)
    true = Pose(so3_exp(torch.tensor([0.0, 0.0, 0.04], device=dev)),
                torch.tensor([0.15, -0.1, 0.05], device=dev))
    pick_e = torch.from_numpy(rng.integers(0, len(pole), ne)).to(dev)
    pick_p = torch.from_numpy(rng.integers(0, len(walls), npl)).to(dev)
    e_body = true.inverse().apply(pole[pick_e]).contiguous()
    p_body = true.inverse().apply(walls[pick_p]).contiguous()
    pose0 = Pose(quat_mul(so3_exp(torch.tensor([0.003, -0.002, 0.01],
                                               device=dev)), true.q),
                 true.t + torch.tensor([0.03, -0.02, 0.01], device=dev))
    out = []
    for m, body, kk in ((maps[0], e_body, k), (maps[1], p_body, 5)):
        w = pose0.apply(body).contiguous()
        slots = mapstate.octant_lookup_reference(m.keys, w, cfg.cell_size)
        neigh, sq, nvalid, _ = mapstate.knn_select_reference(m.pts, slots, w,
                                                             kk)
        out.append((w, neigh.contiguous(), sq.contiguous(),
                    nvalid.contiguous()))
    (_, neigh, sq, nvalid), (w_p, pn, ps, pv) = out
    e_mask = torch.arange(ne, device=dev) % 13 != 0
    reg = registration.RegistrationConfig()
    fit = registration.edge_fit_reference(
        neigh, sq, nvalid, e_mask, rt.line_res, reg.min_edge_neighbors,
        reg.edge_max_dist_inlier)
    lines = registration.EdgeCorrs(e_body, *fit)
    pfit = registration.plane_fit_reference(
        pn, ps, pv, torch.ones(npl, dtype=torch.bool, device=dev), w_p,
        pose0.q.contiguous(), rt.plane_res)
    planes = registration.PlaneCorrs(p_body, *pfit)
    return pose0, planes, lines, rt, (neigh, sq, nvalid, e_mask)


def _assert_edge_fit_bitwise(neigh, sq, nvalid, mask, line_res):
    """Every output of K11b equals the plain version's to the bit (NaN
    equal to NaN), except in a row that edge_gate_margin_lanes flags.
    Returns (the plain outputs, rows that differ)."""
    reg = registration.RegistrationConfig()
    args = (neigh, sq, nvalid, mask, line_res, reg.min_edge_neighbors,
            reg.edge_max_dist_inlier)
    n = kernels.launch_counts["edge_fit"]
    out_k = registration.edge_fit(*args)
    assert kernels.launch_counts["edge_fit"] == n + 1
    out_r = registration.edge_fit_reference(*args)
    torch.cuda.synchronize()
    near = registration.edge_gate_margin_lanes(*args[:3], line_res,
                                               *args[5:])
    differ = torch.zeros_like(near)
    for a, b in zip(out_k, out_r):
        assert a.dtype == b.dtype and a.shape == b.shape
        ne = (a != b) & ~((a != a) & (b != b))
        differ |= ne if ne.dim() == 1 else ne.any(dim=1)
    n_far = int((differ & ~near).sum())
    print(f"edge_fit: {int(differ.sum())} of {near.numel()} rows differ, "
          f"{int(near.sum())} rows at a gate margin")
    assert n_far == 0, f"{n_far} rows away from every gate differ"
    return out_r, int(differ.sum())


@pytest.mark.parametrize("k", [10, 5])
@pytest.mark.parametrize("nq", [0, 1, 63, 65, 512, 2049])
def test_edge_fit_bitwise(dev, nq, k):
    """k = 10 is the instance with k known when compiled, 5 the generic
    one; the row counts end inside, on and past a block of 64."""
    *_, (neigh, sq, nvalid, mask) = _edge_case(dev, ne=max(nq, 1), npl=64,
                                               k=k)
    rows = [x[:nq].contiguous() for x in (neigh, sq, nvalid, mask)]
    out_r, _ = _assert_edge_fit_bitwise(*rows, torch.tensor(0.1, device=dev))
    if nq >= 512:  # most lines fit; some are refused
        assert out_r[3].float().mean() > 0.5 and (out_r[4] != 0).sum() > 10


def test_edge_fit_degenerate_rows(dev):
    """Rows with no and with one valid neighbour, sentinel neighbours (the
    BIG value of an empty lane, a point of table row 0), NaN and inf
    neighbours, masked rows; and a tie in the inlier count, which goes to
    the first line."""
    *_, (neigh, sq, nvalid, mask) = _edge_case(dev, ne=256, npl=64)
    neigh, sq, nvalid, mask = (x.clone() for x in (neigh, sq, nvalid, mask))
    nvalid[3] = False
    nvalid[4, 1:] = False
    neigh[5, 6:] = mapstate.BIG
    sq[5, 6:] = float("inf")
    nvalid[5, 6:] = False
    neigh[6, 7:] = neigh[0, 0]
    nvalid[6, 7:] = False
    neigh[7, 2, 1] = float("nan")
    neigh[8, 9, 0] = float("inf")
    mask[9] = False
    # row 10: four neighbours along x, four along y, then one within the
    # inlier distance of both lines (a tie of 5 inliers each); row 11: the
    # same with y first
    base = neigh[10, 0].clone()
    step = torch.arange(1, 5, device=dev, dtype=torch.float32)[:, None] * 0.25
    ex = torch.tensor([[1.0, 0.0, 0.0]], device=dev)
    ey = torch.tensor([[0.0, 1.0, 0.0]], device=dev)
    for row, first, second in ((10, ex, ey), (11, ey, ex)):
        pts = torch.cat([base[None], base + step * first, base + step * second,
                         base[None] + torch.tensor([[0.1, 0.1, 0.1]],
                                                   device=dev)])
        neigh[row] = pts
        sq[row] = ((pts - base) ** 2).sum(-1)
        nvalid[row] = True
        mask[row] = True
    out_r, _ = _assert_edge_fit_bitwise(neigh, sq, nvalid, mask,
                                        torch.tensor(0.1, device=dev))
    a, b, coeff, valid, code = out_r
    assert int(code[3]) == int(code[4]) == \
        registration.MATCH_NOT_ENOUGH_NEIGHBORS
    assert int(code[9]) == registration.MATCH_UNKNOWN and not valid[9]
    for row, axis in ((10, 0), (11, 1)):  # the first line of the tie wins
        d = (a[row] - b[row]) / (a[row] - b[row]).norm()
        assert float(d[axis].abs()) > 0.99, (row, d)
    assert valid.float().mean() > 0.4


@pytest.mark.parametrize("k", [2, 3, 9, 10, 16])
def test_edge_fit_group_widths(dev, k):
    """The 16-lane group at every k it serves (lanes k.. idle; k = 16
    fills the group, 15 lines), 65 rows (not a whole block's groups)."""
    *_, (neigh, sq, nvalid, mask) = _edge_case(dev, ne=65, npl=64, k=k)
    _assert_edge_fit_bitwise(neigh, sq, nvalid, mask,
                             torch.tensor(0.1, device=dev))


@pytest.mark.parametrize("k", [10, 16, 4])
def test_edge_fit_three_way_tie_goes_to_the_first_line(dev, k):
    """Neighbours on three axes through the nearest point, taken in turn
    (axis a, b, c, a, b, c, ... at 0.25 m steps, beyond the 0.2 m inlier
    distance of the other axes): every line's inlier count ties with two
    others', and the first line, along axis a, must win the group's keyed
    maximum: the selected points' mean, (a + b) / 2, lies off the nearest
    point along axis a alone.  (Their scatter has rank one, where eigh3's
    eigenvectors fall back to an axis, so the fitted direction does not
    tell the winner.)"""
    rng = np.random.default_rng(k)
    nq = 64
    neigh = np.zeros((nq, k, 3), np.float32)
    first = []
    for r in range(nq):
        base = rng.integers(-5, 5, 3).astype(np.float32)
        axes = rng.permutation(3)
        first.append(int(axes[0]))
        for i in range(1, k):
            neigh[r, i] = base
            neigh[r, i, axes[(i - 1) % 3]] += 0.25 * (1 + (i - 1) // 3)
        neigh[r, 0] = base
    sq = ((neigh - neigh[:, :1]) ** 2).sum(-1).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (
        neigh, sq, np.ones((nq, k), bool), np.ones(nq, bool))]
    out_r, _ = _assert_edge_fit_bitwise(*args, torch.tensor(0.5, device=dev))
    off = ((out_r[0] + out_r[1]) / 2 - args[0][:, 0]).abs().cpu()
    on_a = torch.nn.functional.one_hot(torch.tensor(first), 3).bool()
    assert bool((off[on_a] > 0.1).all()) and bool((off[~on_a] < 1e-5).all())


def _gn_edges_both(pose0, planes, lines, rt, **kw):
    pk, pr = _solve_both(pose0, planes, rt, lines, **kw)
    args = (planes.p_body, planes.normal, planes.d, planes.coeff,
            planes.valid, pose0.q.contiguous(), pose0.t.contiguous(),
            3.0 * rt.plane_res, tuple(x.contiguous() for x in (
                lines.p_body, lines.a, lines.b, lines.coeff, lines.valid)),
            3.0 * rt.line_res)
    H_k, g_k, c_k = registration.normal_system(*args)
    H_r, g_r, c_r = registration.normal_system_reference(*args)
    scale = float(H_r.abs().max())
    assert float((H_k - H_r).abs().max()) <= 1e-5 * scale
    assert float((g_k - g_r).abs().max()) <= 1e-5 * scale
    assert abs(float(c_k - c_r)) <= 1e-5 * float(c_r.abs()) + 1e-12
    assert torch.equal(H_k, registration.normal_system(*args)[0])
    return pk, pr, H_r


@pytest.mark.parametrize("ne", [0, 1, 512])
def test_gn_solve_with_edge_rows_matches_plain(dev, ne):
    """0, 1 and 512 edge rows beside path E's 2,048 planes: the solve
    (main-path hold and prior) within GN_TOL of the plain GN loop, repeat
    runs bit-identical, the n_iters = 0 mode's H within 1e-5 of its
    scale."""
    pose0, planes, lines, rt, _ = _edge_case(dev, ne=max(ne, 1))
    lines = registration.EdgeCorrs(*(x[:ne] for x in lines))
    pk, pr, H = _gn_edges_both(pose0, planes, lines, rt,
                               prior=_prior(pose0, False), axis_hold_min=10)
    assert float((pk.t - pose0.t).abs().max()) > 1e-3  # it moved
    if ne == 512:
        assert lines.valid.float().mean() > 0.5
        H_planes, _, _ = registration.normal_system_reference(
            planes.p_body, planes.normal, planes.d, planes.coeff,
            planes.valid, pose0.q, pose0.t, 3.0 * rt.plane_res)
        assert float((H - H_planes).abs().max()) > 0.01 * float(H.abs().max())


def test_gn_solve_hold_on_edge_votes_only(dev):
    """No valid plane: the hold's votes come from the vertical lines alone,
    which vote x and y and never z, so z is held; with an enabled prior
    nothing is."""
    pose0, planes, lines, rt, _ = _edge_case(dev, ne=512, npl=256)
    dead = planes._replace(valid=torch.zeros_like(planes.valid),
                           coeff=torch.zeros_like(planes.coeff),
                           obs_bins=torch.full_like(planes.obs_bins, -1))
    held = registration.axis_hold_mask(dead, 10, 0.005, None, None, lines,
                                       pose0.q)
    assert held.tolist() == [False, False, True]
    pk, pr, _ = _gn_edges_both(pose0, dead, lines, rt, axis_hold_min=10)
    assert float((pk.t - pose0.t).abs()[:2].max()) > 1e-3
    _gn_edges_both(pose0, dead, lines, rt, axis_hold_min=10,
                   prior=_prior(pose0, True))


def test_edge_wrappers_check_inputs_and_count(dev):
    pose0, planes, lines, rt, (neigh, sq, nvalid, mask) = _edge_case(
        dev, ne=64, npl=64)
    n = dict(kernels.launch_counts)
    xyz = planes.p_body
    ring = torch.zeros(xyz.shape[0], dtype=torch.int32, device=dev)
    ok = torch.ones(xyz.shape[0], dtype=torch.bool, device=dev)
    frontend.curvature_edge_extraction(xyz, ring, ok)
    assert kernels.launch_counts["curvature_edges"] == n["curvature_edges"] + 1
    with pytest.raises(ValueError):  # the halo holds at most 16
        kernels.curvature_edges(xyz, ring, ok, 17, 0.2, 0.5)
    with pytest.raises(ValueError):
        kernels.curvature_edges(xyz, ring.long(), ok, 5, 0.2, 0.5)
    with pytest.raises(ValueError):
        kernels.curvature_edges(xyz.t(), ring, ok, 5, 0.2, 0.5)
    res = torch.tensor(0.1, device=dev)
    with pytest.raises(ValueError):  # k beyond the kernel's 16
        kernels.edge_fit(torch.zeros((4, 17, 3), device=dev),
                         torch.zeros((4, 17), device=dev),
                         torch.zeros((4, 17), dtype=torch.bool, device=dev),
                         mask[:4].contiguous(), res, 4, 0.2)
    with pytest.raises(ValueError):  # the resolution lives on the card
        kernels.edge_fit(neigh, sq, nvalid, mask, res.cpu(), 4, 0.2)
    with pytest.raises(ValueError):
        kernels.edge_fit(neigh, sq, nvalid.to(torch.uint8), mask, res, 4, 0.2)
    rows = tuple(x.contiguous() for x in (lines.p_body, lines.a, lines.b,
                                          lines.coeff, lines.valid))
    args = (planes.p_body, planes.normal, planes.d, planes.coeff,
            planes.valid, pose0.q.contiguous(), pose0.t.contiguous(),
            3.0 * rt.plane_res)
    with pytest.raises(ValueError):  # the edges' support lives on the card
        kernels.normal_system(*args, rows, (3.0 * rt.line_res).cpu())
    with pytest.raises(ValueError):
        kernels.normal_system(*args, (rows[0][:3].contiguous(),) + rows[1:],
                              3.0 * rt.line_res)
    big = torch.zeros((60000, 3), device=dev)
    bigv = torch.zeros(60000, dtype=torch.bool, device=dev)
    bigs = torch.zeros(60000, device=dev)
    with pytest.raises(ValueError):  # planes and edges share the memory
        kernels.normal_system(*args, (big, big, big, bigs, bigv),
                              3.0 * rt.line_res)
    assert kernels.launch_counts["edge_fit"] == n["edge_fit"]
    assert kernels.launch_counts["normal_system"] == n["normal_system"]


def _ship_dataset(n_scans):
    return make_dataset(np.random.default_rng(7), n_scans=n_scans,
                        points_per_scan=131072,
                        world=BoxWorld(half_extent=np.array([40.0, 30.0, 8.0])),
                        radius=5.0, laps=0.5 * n_scans / 120.0, distortion=True)


def test_chunked_replay_repeats_bit_for_bit(dev):
    """The ship path's chunked replay over 20 scans: two replays at
    chunk = 20 with the freed device memory filled with NaN in between
    give the same poses to the bit, and so do chunks of 4 (with preloaded
    and with streamed inputs); the kernels launch once more for the
    warm-up step than the replay's rounds imply."""
    cfg = ship_config("os1")
    ds = _ship_dataset(20)
    poses = []
    for kw in (dict(chunk=20), dict(chunk=20), dict(chunk=4),
               dict(chunk=4, preload=False, time_chunks=True)):
        before = dict(kernels.launch_counts)
        res = OdometryRunner(cfg, device=dev).run_dataset_chunked(ds, **kw)
        launched = {k: kernels.launch_counts[k] - before[k] for k in before}
        rounds = sum(s["n_iterations"] for s in res.stats)
        assert launched["gn_solve"] == rounds + res.stats[0]["n_iterations"]
        assert launched["normal_system"] == 21
        poses.append(np.concatenate([res.poses_t, res.poses_q], axis=1))
        junk = [torch.full(((1 << k) + 3 * j,), float("nan"), device=dev)
                for k in range(2, 23) for j in range(4)]
        del junk
    assert np.isfinite(poses[0]).all() and poses[0].shape == (20, 7)
    for p in poses[1:]:
        np.testing.assert_array_equal(p, poses[0])


def test_chunk_is_its_steps(dev):
    """One ``make_chunked_step_fn`` chunk of 4 scans (with the IMU-rate
    stream) from a warm ship-path state gives, leaf by leaf and to the
    bit, the outputs of four ``step`` calls and their streams."""
    from superodom_tpu_torch import inertial, pipeline
    from superodom_tpu_torch.convert import to_numpy

    cfg = ship_config("os1")
    runner = OdometryRunner(cfg, device=dev)
    stacked, _, n_chunks = runner.stack_chunked_inputs(_ship_dataset(16),
                                                       chunk=8)
    assert n_chunks == 2
    inputs = runner._to_device(stacked)
    chunk_fn = pipeline.make_chunked_step_fn(runner.step_cfg, high_rate=True)
    state, _ = chunk_fn(runner.state,
                        *pipeline.tree_map(lambda a: a[0], inputs))
    second = pipeline.tree_map(lambda a: a[1, :4], inputs)
    _, stacked_out = chunk_fn(state, *second)
    for k in range(4):
        scan, imu, avail = pipeline.tree_map(lambda a: a[k], second)
        state, out = pipeline.step(runner.step_cfg, state, scan, imu, avail)
        poses, vels, mask = inertial.propagate_high_rate(state.smoother,
                                                         cfg.imu, imu)
        mine = pipeline.tree_map(np.asarray, to_numpy(
            (out, (imu.t, poses.q, poses.t, vels,
                   mask & ~state.smoother.failed))))
        theirs = to_numpy(pipeline.tree_map(lambda a: a[k], stacked_out))
        leaves_a, leaves_b = [], []
        pipeline.tree_map(lambda a, b: (leaves_a.append(a),
                                        leaves_b.append(b)),
                          mine, (theirs[0], tuple(theirs[1])))
        assert len(leaves_a) > 30
        for a, b in zip(leaves_a, leaves_b):
            np.testing.assert_array_equal(a, b)


def test_superloc_replay_repeats_bit_for_bit(dev):
    """The SuperLoc path over 20 scans of the stress battery's corridor at
    OS1-128 density (``ship_config("os1")`` with the case's overrides:
    VIO undistortion, the frozen corridor prior map): two replays with the
    freed device memory filled with NaN in between give the same poses to
    the bit; the prior map stays as it was loaded; the kernels launch as
    the rounds imply."""
    from superodom_tpu_torch.io import scenarios

    case = next(c for c in scenarios.stress_battery(
        points_per_scan=131072, scale=20.5 / 170)
        if c.name == "superloc_corridor")
    ds = case.build(np.random.default_rng(7))
    assert len(ds.scans) == 20 and ds.vio is not None
    cfg = dataclasses.replace(ship_config("os1"), **case.cfg_overrides)
    poses = []
    for _ in range(2):
        runner = OdometryRunner(cfg, device=dev)
        scenarios.prime_prior_map(runner, case, np.random.default_rng(8))
        before = dict(kernels.launch_counts)
        res = runner.run_dataset(ds)
        launched = {k: kernels.launch_counts[k] - before[k] for k in before}
        assert launched["gn_solve"] == sum(s["n_iterations"]
                                           for s in res.stats)
        assert launched["normal_system"] == 20
        assert int(mapstate.total_points(runner.state.surf_map)) == \
            runner.prior_map_total > 10000
        poses.append(np.concatenate([res.poses_t, res.poses_q], axis=1))
        junk = [torch.full(((1 << k) + 3 * j,), float("nan"), device=dev)
                for k in range(2, 23) for j in range(4)]
        del junk
    assert np.isfinite(poses[0]).all() and poses[0].shape == (20, 7)
    np.testing.assert_array_equal(poses[0], poses[1])


def test_query_knn_matches_the_cpu_composition(dev):
    """``mapstate.query_knn`` on the card (K1 octant_lookup, then K2
    knn_select) against the same function on the CPU (their plain
    versions), bit for bit, on a warm ship map (8 OS1-128 scans replayed
    on the card), with queries near the map's points and beyond it;
    ``gather_candidates`` (K1 and the row gather) the same way."""
    cfg = ship_config("os1")
    runner = OdometryRunner(cfg, device=dev)
    runner.run_dataset(_ship_dataset(8))
    m = runner.state.surf_map
    pts, valid = mapstate.extract_points(m)
    stored = pts[valid]
    g = torch.Generator(device="cpu").manual_seed(3)
    idx = torch.randint(0, stored.shape[0], (2000,), generator=g)
    q = torch.cat([stored[idx.to(dev)]
                   + 0.1 * torch.randn((2000, 3), generator=g).to(dev),
                   (torch.rand((48, 3), generator=g) * 400 - 200).to(dev)])
    m_cpu = mapstate.VoxelHashMap(*(a.cpu() for a in m))
    k = cfg.registration.plane_knn
    before = dict(kernels.launch_counts)
    got = mapstate.query_knn(m, cfg.map, q, k)
    assert kernels.launch_counts["octant_lookup"] == \
        before["octant_lookup"] + 1
    assert kernels.launch_counts["knn_select"] == before["knn_select"] + 1
    want = mapstate.query_knn(m_cpu, cfg.map, q.cpu(), k)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert want[2][:2000].any() and not want[2][2000:].any()
    for a, b in zip(mapstate.gather_candidates(m, cfg.map, q),
                    mapstate.gather_candidates(m_cpu, cfg.map, q.cpu())):
        assert torch.equal(a.cpu(), b)


# ------------------------------------- K2's gathered mode, the library


def _gathered_both(cand, cvalid, q, k):
    """K2's gathered mode and its plain version on the same inputs; every
    output (neighbours, sq, valid, lane) equal to the bit.  Returns the
    plain outputs."""
    n = kernels.launch_counts["knn_select_gathered"]
    out_k = kernels.knn_select_gathered(cand, cvalid, q, k)
    assert kernels.launch_counts["knn_select_gathered"] == n + 1
    out_r = mapstate.select_knn_reference(cand, cvalid, q, k)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_r):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return out_r


@pytest.mark.parametrize("cap,k,nq", [(16, 5, 333), (16, 10, 2049),
                                      (24, 10, 31), (32, 5, 1), (4, 12, 97)])
def test_select_knn_gathered_matches_plain(dev, cap, k, nq):
    """On a map filled by the insert: the gathered rows with their slot
    mask (the gathered mode then gives the slot mode's outputs to the
    bit) and with a lane-granular mask (about a third of the lanes of
    live slots dropped, not whole octants)."""
    cfg, m, q = _map(dev, cap, seed=cap + k, nq=nq)
    slots = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
    cand, cvalid = mapstate._candidate_rows(m.pts, slots)
    out = _gathered_both(cand, cvalid, q, k)
    for a, b in zip(out, kernels.knn_select(m.pts, slots, q, k)):
        assert torch.equal(a, b)
    g = torch.Generator(device="cpu").manual_seed(nq)
    lanes = (torch.rand(cvalid.shape, generator=g) < 0.67).to(dev)
    out = _gathered_both(cand, cvalid & lanes, q, k)
    assert out[2].any()


def test_select_knn_gathered_ties_and_short_rows(dev):
    """Exact ties on an integer grid (the lower lane wins), rows with
    fewer valid lanes than k and one with none, an empty (BIG) lane of
    every row left valid, and no query at all."""
    g = torch.Generator(device="cpu").manual_seed(3)
    nq, C, k = 96, 4, 12
    q = torch.randint(-4, 4, (nq, 3), generator=g).float()
    cand = q[:, None, None, :] + torch.randint(-1, 2, (nq, 8, C, 3),
                                               generator=g).float()
    cand[:, :, C - 1] = mapstate.BIG
    cand = cand.permute(0, 1, 3, 2).reshape(nq, 8, 3 * C)
    cvalid = torch.rand((nq, 8 * C), generator=g) < 0.6
    cvalid[:8] &= torch.arange(8 * C) < 5
    cvalid[8] = False
    cand, cvalid, q = (x.contiguous().to(dev) for x in (cand, cvalid, q))
    out = _gathered_both(cand, cvalid, q, k)
    assert (out[1][:, :-1] == out[1][:, 1:]).sum() > nq
    assert not out[2][:9, 4:].any()
    _gathered_both(cand[:0].contiguous(), cvalid[:0].contiguous(),
                   q[:0].contiguous(), k)


def test_select_knn_gathered_checks_inputs(dev):
    """The entry refuses what the kernel does not take, and no launch is
    counted then; a CUDA tensor reaches the kernel through the library's
    ``select_knn`` (three outputs, JAX's), and under vmap it raises."""
    cfg, m, q = _map(dev, 16, seed=9)
    slots = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
    cand, cvalid = mapstate._candidate_rows(m.pts, slots)
    n = kernels.launch_counts["knn_select_gathered"]
    for bad in ((cand[:, :, :-3].contiguous(), cvalid, q, 5),
                (cand, cvalid[:, :-1].contiguous(), q, 5),
                (cand, cvalid.to(torch.uint8), q, 5),
                (cand, cvalid, q.t(), 5),
                (cand, cvalid, q, 33),
                (cand.cpu(), cvalid, q, 5)):
        with pytest.raises(ValueError):
            kernels.knn_select_gathered(*bad)
    with pytest.raises(RuntimeError, match="without its rule"):
        torch.func.vmap(lambda c, v, x: kernels.knn_select_gathered(
            c, v, x, 5))(cand[None], cvalid[None], q[None])
    assert kernels.launch_counts["knn_select_gathered"] == n
    got = mapstate.select_knn(cand, cvalid, q, 5)
    assert len(got) == 3
    assert kernels.launch_counts["knn_select_gathered"] == n + 1
    want = mapstate.select_knn(cand.cpu(), cvalid.cpu(), q.cpu(), 5)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _rows_that_differ(got, want):
    """bool[M]: the rows in which any of two sets of per-row outputs
    differ (NaN equal to NaN), on the CPU."""
    differ = None
    for a, b in zip(got, want):
        a, b = a.cpu(), b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape
        ne = (a != b) & ~((a != a) & (b != b))
        ne = ne if ne.dim() == 1 else ne.any(dim=1)
        differ = ne if differ is None else differ | ne
    return differ


def _hold_corrs(got, fit, near, exact, cpu, cpu_near, tol_fields):
    """A library function's correspondences ``got`` (on the card, the
    features' field first) against the plain versions' fit of the same
    neighbourhoods on the card (``fit``, the fields after the first): the
    first ``exact`` of them equal to the bit on every row, the rest off
    the rows at a gate margin (``near``); and against the same function
    on the CPU (``cpu``): the decisions (validity, codes, bins) equal off
    the rows at a gate margin of either, the fields ``tol_fields`` within
    1e-5 where valid there (the CPU's transcendental functions round
    otherwise)."""
    near = near.cpu()
    assert torch.equal(got[0].cpu(), cpu[0])
    if exact:
        assert not _rows_that_differ(got[1:1 + exact], fit[:exact]).any()
    assert not (_rows_that_differ(got[1:], fit) & ~near).any()
    far = ~(near | cpu_near)
    for name in got._fields[1:]:
        a, b = getattr(got, name).cpu(), getattr(cpu, name)
        if name in tol_fields:
            ok = far & cpu.valid
            torch.testing.assert_close(a[ok], b[ok], rtol=0, atol=1e-5)
        elif a.dtype != torch.float32:
            assert torch.equal(a[far], b[far]), name
    return far


def test_correspondence_functions_on_the_card(dev):
    """``compute_plane_correspondences`` (K1, K2's gathered mode, K3) on
    a warm ship map (20 OS1-128 scans replayed on the card; features near
    its stored points, seen from a pose of their own) and
    ``plane_correspondences_from_candidates`` on its candidates;
    ``compute_edge_correspondences`` and
    ``edge_correspondences_from_candidates`` (K1, the gathered mode, K11b)
    on a pole lattice: the launches each makes, the plain versions'
    composition on the card, and the same function on the CPU."""
    cfg = ship_config("os1")
    runner = OdometryRunner(cfg, device=dev)
    runner.run_dataset(_ship_dataset(20))
    m = runner.state.surf_map
    m_cpu = mapstate.VoxelHashMap(*(a.cpu() for a in m))
    pts, valid = mapstate.extract_points(m)
    stored = pts[valid]
    g = torch.Generator(device="cpu").manual_seed(5)
    idx = torch.randint(0, stored.shape[0], (2048,), generator=g)
    world = stored[idx.to(dev)] + 0.02 * torch.randn((2048, 3),
                                                      generator=g).to(dev)
    pose = Pose(quat_mul(so3_exp(torch.tensor([0.0, 0.0, 0.3], device=dev)),
                         runner.state.pose.q),
                runner.state.pose.t + torch.tensor([0.5, -0.2, 0.1],
                                                   device=dev))
    p_body = pose.inverse().apply(world).contiguous()
    mask = torch.arange(p_body.shape[0], device=dev) % 9 != 0
    res = torch.tensor(0.2, device=dev)
    reg = cfg.registration

    def on_cpu(pose):
        return Pose(pose.q.cpu(), pose.t.cpu())

    before = dict(kernels.launch_counts)
    got = registration.compute_plane_correspondences(m, cfg.map, reg, pose,
                                                     p_body, mask, res)
    launched = {k: kernels.launch_counts[k] - before[k] for k in before}
    assert {k: v for k, v in launched.items() if v} == {
        "octant_lookup": 1, "knn_select_gathered": 1, "plane_fit": 1}
    w_pt = pose.apply(p_body).contiguous()
    cand, cvalid = mapstate.gather_candidates(m, cfg.map, w_pt)
    neigh, sq, nvalid, _ = mapstate.select_knn_reference(cand, cvalid, w_pt,
                                                         reg.plane_knn)
    fit = registration.plane_fit_reference(neigh, sq, nvalid, mask, w_pt,
                                           pose.q, res)
    near = registration.gate_margin_lanes(neigh, sq, nvalid, w_pt, pose.q,
                                          fit[0], fit[1], res)
    cpu = registration.compute_plane_correspondences(
        m_cpu, cfg.map, reg, on_cpu(pose), p_body.cpu(), mask.cpu(),
        res.cpu())
    w_c = on_cpu(pose).apply(p_body.cpu()).contiguous()
    nc, sc, vc = mapstate.select_knn(
        *mapstate.gather_candidates(m_cpu, cfg.map, w_c), w_c,
        reg.plane_knn)
    cpu_near = registration.gate_margin_lanes(nc, sc, vc, w_c, pose.q.cpu(),
                                              cpu.normal, cpu.d, res.cpu())
    far = _hold_corrs(got, fit, near, 2, cpu, cpu_near, ("normal", "d"))
    assert far.float().mean() > 0.9
    assert cpu.valid.sum() > 500 and (cpu.code != 0).sum() > 500
    again = registration.plane_correspondences_from_candidates(
        cand, cvalid, reg, pose, p_body, mask, res)
    assert not _rows_that_differ(again, got).any()

    pose0, _, _, rt, _ = _edge_case(dev, ne=512, npl=64)
    rng = np.random.default_rng(3)
    emap_cfg = MapConfig(cell_capacity=16)
    pole = torch.from_numpy(pole_lattice(rng)).to(dev)
    em = mapstate.empty_map(emap_cfg, device=dev)
    for chunk in torch.split(pole, 1000):
        em = mapstate.insert(em, emap_cfg, chunk.contiguous(),
                             torch.ones(len(chunk), dtype=torch.bool,
                                        device=dev),
                             torch.tensor(0.03, device=dev))
    e_body = pose0.inverse().apply(pole[::7][:512]).contiguous()
    e_mask = torch.arange(e_body.shape[0], device=dev) % 13 != 0
    before = dict(kernels.launch_counts)
    got = registration.compute_edge_correspondences(
        em, emap_cfg, reg, pose0, e_body, e_mask, rt.line_res)
    launched = {k: kernels.launch_counts[k] - before[k] for k in before}
    assert {k: v for k, v in launched.items() if v} == {
        "octant_lookup": 1, "knn_select_gathered": 1, "edge_fit": 1}
    e_w = pose0.apply(e_body).contiguous()
    cand, cvalid = mapstate.gather_candidates(em, emap_cfg, e_w)
    margin = (rt.line_res, reg.min_edge_neighbors, reg.edge_max_dist_inlier)
    neigh, sq, nvalid, _ = mapstate.select_knn_reference(cand, cvalid, e_w,
                                                         reg.edge_knn)
    fit = registration.edge_fit_reference(neigh, sq, nvalid, e_mask,
                                          *margin)
    near = registration.edge_gate_margin_lanes(neigh, sq, nvalid, *margin)
    em_cpu = mapstate.VoxelHashMap(*(a.cpu() for a in em))
    cpu = registration.compute_edge_correspondences(
        em_cpu, emap_cfg, reg, on_cpu(pose0), e_body.cpu(), e_mask.cpu(),
        rt.line_res.cpu())
    e_c = on_cpu(pose0).apply(e_body.cpu()).contiguous()
    nc, sc, vc = mapstate.select_knn(
        *mapstate.gather_candidates(em_cpu, emap_cfg, e_c), e_c,
        reg.edge_knn)
    cpu_near = registration.edge_gate_margin_lanes(
        nc, sc, vc, rt.line_res.cpu(), *margin[1:])
    far = _hold_corrs(got, fit, near, 0, cpu, cpu_near, ("a", "b", "coeff"))
    assert far.float().mean() > 0.9 and cpu.valid.float().mean() > 0.5
    again = registration.edge_correspondences_from_candidates(
        cand, cvalid, reg, pose0, e_body, e_mask, rt.line_res)
    assert not _rows_that_differ(again, got).any()


# ------------------------------------------------- many instances at once


def _same(a, b):
    """Equal to the bit, NaN where NaN."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | ((a != a) & (b != b))).all())


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_batched_entries_match_single_launches(dev, name):
    """Each entry's custom operator vmapped over three instances (three
    maps, poses, clouds): every instance's outputs equal its own single
    launch to the bit, from one launch (instance dimension, flattened);
    again with the first tensor shared by the instances (a stride of 0),
    and repeated runs equal."""
    from test_torch_kernel_ops import kernel_instances

    per = [a[name] for a in kernel_instances(dev, 3)]
    op = getattr(kernel_ops, name)
    single = [_tuple(op(*a)) for a in per]
    dims = tuple(0 if isinstance(x, torch.Tensor) else None for x in per[0])
    args = [torch.stack([p[i] for p in per]) if d == 0 else x
            for i, (x, d) in enumerate(zip(per[0], dims))]
    before = kernels.launch_counts[name]
    got = _tuple(torch.func.vmap(op, in_dims=dims)(*args))
    again = _tuple(torch.func.vmap(op, in_dims=dims)(*args))
    assert kernels.launch_counts[name] == before + 2
    for b in range(3):
        assert all(_same(g[b], s) for g, s in zip(got, single[b])), b
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    first = dims.index(0)
    shared = list(args)
    shared[first] = per[0][first]
    got = _tuple(torch.func.vmap(op, in_dims=dims[:first] + (None,)
                                 + dims[first + 1:])(*shared))
    for b in range(3):
        want = _tuple(op(*(per[0][i] if i == first else x
                           for i, x in enumerate(per[b]))))
        assert all(_same(g[b], w) for g, w in zip(got, want)), b


def test_batched_launches_take_any_instance_stride(dev):
    """K1-K4 and K9a called directly with n instances: n = 1 is the
    single entry, and instances a gap apart (every other row of a larger
    stack) or one table shared with a stride of 0 give each instance its
    single launch's bits."""
    from test_torch_kernel_ops import kernel_instances

    inst = kernel_instances(dev, 4)
    cases = {
        "octant_lookup": (kernels.octant_lookup, kernels.octant_lookup_batched),
        "knn_select": (kernels.knn_select, kernels.knn_select_batched),
        "reduce_candidates": (kernels.reduce_candidates,
                              kernels.reduce_candidates_batched),
        "plane_fit": (kernels.plane_fit, kernels.plane_fit_batched),
    }
    for name, (one, many) in cases.items():
        per = [a[name] for a in inst]
        t = [i for i, x in enumerate(per[0]) if isinstance(x, torch.Tensor)]
        lone = _tuple(one(*per[0]))
        assert all(_same(a[0], b) for a, b in zip(
            _tuple(many(*(x[None] if i in t else x
                          for i, x in enumerate(per[0])))), lone))
        gap = [torch.stack([p[i] for p in per])[::2] if i in t else x
               for i, x in enumerate(per[0])]
        assert gap[t[0]].stride(0) == 2 * per[0][t[0]].numel()
        got = _tuple(many(*gap))
        for b, j in enumerate((0, 2)):
            assert all(_same(g[b], w) for g, w in zip(got, _tuple(one(
                *per[j]))))
        zero = list(gap)
        zero[t[0]] = per[0][t[0]].expand((2,) + per[0][t[0]].shape)
        got = _tuple(many(*zero))
        for b, j in enumerate((0, 2)):
            want = _tuple(one(*(per[0][i] if i == t[0] else x
                                for i, x in enumerate(per[j]))))
            assert all(_same(g[b], w) for g, w in zip(got, want))
    # K4: both modes, two instances a gap apart against single launches
    per = [a["gn_solve"] for a in inst]
    rows = [torch.stack([p[i] for p in per])[::2] for i in range(9)]
    prior = tuple(torch.stack([p[i] for p in per])[::2]
                  for i in range(11, 15))
    hold = torch.stack([p[17] for p in per])[::2]
    out, small = kernels.gn_solve_batched(*rows, 4, 1e-4, prior, 10, 0.005,
                                          hold)
    ns = kernels.normal_system_batched(*rows[:5], *rows[6:9])
    for b, j in enumerate((0, 2)):
        p = per[j]
        qt, s = kernels.gn_solve(*p[:9], 4, 1e-4, p[11:15], 10, 0.005, p[17])
        assert torch.equal(out[b], qt) and bool(small[b]) == bool(s)
        assert torch.equal(ns[b], kernels.normal_system(*p[:5], *p[6:9]))


def test_voxel_claim_batched_resolutions_differ(dev):
    """K10 over four instances in one launch, at the VLP-16
    and OS1-128 tables: each its own cloud and resolution (0.1-0.8 m, as
    LIO's auto voxel size gives instances resolutions of their own), then
    one cloud shared by the four (a stride of 0) under their four
    resolutions; every keep-mask is its single launch's to the bit and
    the plain version's, each instance from its own claim table."""
    res = torch.tensor([0.1, 0.2, 0.4, 0.8], device=dev)
    for bits in (17, 19):
        clouds = [_cloud(dev, 10923, seed=40 + s) for s in range(4)]
        xyz = torch.stack([c[0] for c in clouds])
        mask = torch.stack([c[1] for c in clouds])
        for x in (xyz, xyz[0].expand(4, -1, -1)):
            n = kernels.launch_counts["voxel_claim"]
            got = kernels.voxel_claim_batched(x, mask, res, bits)
            assert kernels.launch_counts["voxel_claim"] == n + 1
            for b in range(4):
                one = kernels.voxel_claim(x[b].contiguous(), mask[b], res[b],
                                          bits)
                plain = voxel.voxel_downsample_scatter_reference(
                    x[b], mask[b], res[b], bits)
                assert torch.equal(got[b], one), (bits, b)
                assert torch.equal(one, plain), (bits, b)
            kept = got.sum(dim=1).tolist()
            assert kept == sorted(kept, reverse=True) and kept[0] > kept[3]


@pytest.mark.parametrize("n_inst", [1, 4, 64])
def test_voxel_claim_fleets(dev, n_inst):
    """K10 over fleets of 1, 4 and 64 OS1-128 scans (43,691 lanes, 2^19
    slots: one cluster of 16 blocks an instance) in one launch, each with
    its own cloud and resolution, then one cloud shared by all (a stride
    of 0), twice: every keep-mask is its single launch's and the plain
    version's, to the bit."""
    bits = 19
    cs, smem, active = kernels.voxel_claim_clusters(bits, 43691, n_inst)
    assert (cs, smem) == (16, 128 * 1024) and active >= 1
    assert kernels.voxel_claim_clusters(20, 43691, n_inst) == (0, 0, 0)
    clouds = [_cloud(dev, 43691, seed=70 + s) for s in range(n_inst)]
    xyz = torch.stack([c[0] for c in clouds])
    mask = torch.stack([c[1] for c in clouds])
    res = 0.1 + 0.7 * torch.arange(n_inst, device=dev) / max(n_inst - 1, 1)
    for x in (xyz, xyz[0].expand(n_inst, -1, -1)):
        n = kernels.launch_counts["voxel_claim"]
        got = kernels.voxel_claim_batched(x, mask, res, bits)
        again = kernels.voxel_claim_batched(x, mask, res, bits)
        assert kernels.launch_counts["voxel_claim"] == n + 2
        assert torch.equal(got, again)
        for b in range(n_inst):
            one = kernels.voxel_claim(x[b].contiguous(), mask[b], res[b],
                                      bits)
            plain = voxel.voxel_downsample_scatter_reference(
                x[b], mask[b], res[b], bits)
            assert torch.equal(got[b], one) and torch.equal(one, plain), b


def test_curvature_edges_batched_wraps_within_each_instance(dev):
    """K11a over three instances of 1,024 lanes in one launch, instance b
    on ring b alone, so that a lane that read into a neighbouring
    instance would see another ring: with threshold -1 every lane of
    every instance is an edge, lanes 0..w-1 and N-w..N-1 only through the
    wrap inside their own instance; at the real threshold each instance
    equals its single launch and its plain version to the bit, with its
    own cloud and with one cloud shared (a stride of 0)."""
    n, w = 1024, 5
    clouds = [_cloud(dev, n, seed=60 + b)[0] for b in range(3)]
    xyz = torch.stack(clouds)
    ring = (torch.arange(3, dtype=torch.int32, device=dev)[:, None]
            .expand(3, n).contiguous())
    mask = torch.ones((3, n), dtype=torch.bool, device=dev)
    every = kernels.curvature_edges_batched(xyz, ring, mask, w, -1.0, 0.0)
    assert every.all()
    for x in (xyz, xyz[0].expand(3, -1, -1)):
        before = kernels.launch_counts["curvature_edges"]
        got = kernels.curvature_edges_batched(x, ring, mask, w, 0.2, 0.5)
        assert kernels.launch_counts["curvature_edges"] == before + 1
        for b in range(3):
            one = kernels.curvature_edges(x[b].contiguous(), ring[b],
                                          mask[b], w, 0.2, 0.5)
            plain = frontend.curvature_edge_extraction_reference(
                x[b], ring[b], mask[b], w, 0.2, 0.5)
            assert torch.equal(got[b], one) and torch.equal(one, plain), b
            assert got[b, :w].any() or got[b, -w:].any()


def test_edge_fit_batched_line_res_per_instance(dev):
    """K11b over three instances sharing one set of 512 line
    correspondences (a stride of 0), each with its own line resolution:
    the median row's k-th distance / 3, which puts rows at the distance
    gate's margin, and half and twice that; one launch over the 3 x 512
    rows gives each instance its single launch's bits, the plain
    version's off the gate margins, and no more valid lines at a smaller
    resolution."""
    reg = registration.RegistrationConfig()
    *_, (neigh, sq, nvalid, mask) = _edge_case(dev)
    margin = float(sq[:, -1].median()) / 3.0
    line_res = torch.tensor([0.5 * margin, margin, 2.0 * margin],
                            device=dev)
    knobs = (reg.min_edge_neighbors, reg.edge_max_dist_inlier)
    n = kernels.launch_counts["edge_fit"]
    got = kernels.edge_fit_batched(
        *(x.expand((3,) + x.shape) for x in (neigh, sq, nvalid, mask)),
        line_res, *knobs)
    assert kernels.launch_counts["edge_fit"] == n + 1
    for b in range(3):
        one = kernels.edge_fit(neigh, sq, nvalid, mask, line_res[b], *knobs)
        assert all(_same(g[b], o) for g, o in zip(got, one)), b
        plain = registration.edge_fit_reference(neigh, sq, nvalid, mask,
                                                line_res[b], *knobs)
        near = registration.edge_gate_margin_lanes(neigh, sq, nvalid,
                                                   line_res[b], *knobs)
        assert all(_same(g[b][~near], p[~near])
                   for g, p in zip(got, plain)), b
    valid = got[3].sum(dim=1).tolist()
    assert valid[0] <= valid[1] <= valid[2] and valid[0] < valid[2]


@pytest.mark.parametrize("n", [4, 12, 13, 64])
def test_edge_fit_lanes_a_correspondence_follow_the_launch(dev, n):
    """One set of 512 line correspondences shared by n instances (a stride
    of 0): 2,048 to 32,768 correspondences a launch, on both sides of the
    size where the kernel gives each correspondence 1 lane instead of 16
    (above 6,144); every instance the single launch's bits (16 lanes)."""
    reg = registration.RegistrationConfig()
    knobs = (reg.min_edge_neighbors, reg.edge_max_dist_inlier)
    *_, rows = _edge_case(dev)
    line_res = torch.tensor(0.1, device=dev)
    one = kernels.edge_fit(*rows, line_res, *knobs)
    got = kernels.edge_fit_batched(
        *(x.expand((n,) + x.shape) for x in rows), line_res.expand(n),
        *knobs)
    for b in range(n):
        assert all(_same(g[b], o) for g, o in zip(got, one)), b


def test_edge_fit_batched_odd_group_count(dev):
    """Three instances of 333 line correspondences (999 groups: the last
    group alone in its warp, the instances' boundaries inside warps): each
    instance its single launch's bits and the plain version's off the gate
    margins."""
    reg = registration.RegistrationConfig()
    knobs = (reg.min_edge_neighbors, reg.edge_max_dist_inlier)
    inst = [_edge_case(dev, ne=333, npl=16, seed=s)[-1] for s in (3, 4, 5)]
    stacked = [torch.stack([c[i] for c in inst]).contiguous()
               for i in range(4)]
    line_res = torch.tensor([0.1, 0.05, 0.2], device=dev)
    got = kernels.edge_fit_batched(*stacked, line_res, *knobs)
    for b, c in enumerate(inst):
        one = kernels.edge_fit(*c, line_res[b], *knobs)
        assert all(_same(g[b], o) for g, o in zip(got, one)), b
        plain = registration.edge_fit_reference(*c, line_res[b], *knobs)
        near = registration.edge_gate_margin_lanes(*c[:3], line_res[b],
                                                   *knobs)
        assert all(_same(g[b][~near], p[~near])
                   for g, p in zip(got, plain)), b


def test_a_kernel_under_vmap_without_its_rule_raises(dev):
    """``kernels``' launch functions take no tensor under vmap: only the
    custom operators' rules reach them so."""
    from test_torch_kernel_ops import kernel_instances

    per = [a["octant_lookup"] for a in kernel_instances(dev, 2)]
    keys = torch.stack([p[0] for p in per])
    q = torch.stack([p[1] for p in per])
    n = kernels.launch_counts["octant_lookup"]
    with pytest.raises(RuntimeError, match="without its rule"):
        torch.func.vmap(lambda k, x: kernels.octant_lookup(k, x, 1.0))(keys, q)
    assert kernels.launch_counts["octant_lookup"] == n


def test_batched_replay_matches_single_replays(dev):
    """``parallel.replay_batched`` on the card: two instances on two
    datasets (16 OS1-128 scans each, chunks of 4) give each dataset's
    B = 1 replay to the bit, with K1-K4 launched as often as at B = 1."""
    from superodom_tpu_torch.io.datasets import bench_dataset
    from superodom_tpu_torch.parallel import replay_batched

    cfg = ship_config("os1")
    data = [bench_dataset(16, cfg.sensor.max_points, s) for s in (7, 8)]
    kernels.reset_counts()
    pair = replay_batched(cfg, data, chunk=4, device=dev)
    counts = dict(kernels.launch_counts)
    for b, ds in enumerate(data):
        kernels.reset_counts()
        one = replay_batched(cfg, [ds], chunk=4, device=dev)
        assert dict(kernels.launch_counts) == counts
        np.testing.assert_array_equal(pair.poses_t[:, b], one.poses_t[:, 0])
        np.testing.assert_array_equal(pair.poses_q[:, b], one.poses_q[:, 0])
    assert counts["gn_solve"] == 2 * 17 and np.isfinite(pair.poses_t).all()


def test_mesh_over_every_card(dev):
    """The fleet over a mesh on every card there is
    (``parallel.make_mesh()``): four OS1-128 instances with their maps
    split into M shards (M = 4 where there are four cards, else 2; shard j
    on card j % cards) give the unsplit fleet's poses and final maps to
    the bit, K1 launched M times as often; and two rank processes with
    2-shard maps (rank r's shards on cards 2r, 2r + 1 of four) give its
    poses to the bit.  On one card the shards and ranks share it; only a
    machine with several cards moves the candidate rows and the insert's
    writes between cards."""
    from superodom_tpu_torch.io.datasets import bench_dataset
    from superodom_tpu_torch.parallel import (
        make_mesh,
        replay_batched,
        replay_mesh,
    )
    from superodom_tpu_torch.pipeline import tree_map, unshard_state

    cfg = ship_config("os1")
    data = [bench_dataset(12, cfg.sensor.max_points, s)
            for s in (7, 8, 9, 10)]
    kernels.reset_counts()
    whole = replay_batched(cfg, data, chunk=4, device=dev)
    counts = dict(kernels.launch_counts)
    M = 4 if torch.cuda.device_count() >= 4 else 2
    mesh = make_mesh(data=1, model=M)
    kernels.reset_counts()
    split = replay_batched(cfg, data, chunk=4, device=mesh.devices[0],
                           mesh=mesh)
    assert dict(kernels.launch_counts) == dict(
        counts, octant_lookup=M * counts["octant_lookup"])
    assert [str(sh.keys.device) for sh in split.state.surf_map.shards] == \
        [str(d) for d in mesh.rank_devices(0)]
    np.testing.assert_array_equal(split.poses_t, whole.poses_t)
    np.testing.assert_array_equal(split.poses_q, whole.poses_q)
    host = [tree_map(lambda x: x.cpu(), unshard_state(r.state))
            for r in (split, whole)]
    for m in ("surf_map", "edge_map"):
        for f in ("keys", "pts", "cnt"):
            assert torch.equal(getattr(getattr(host[0], m), f),
                               getattr(getattr(host[1], m), f))
    ranks = replay_mesh(cfg, data, make_mesh(data=2, model=2), chunk=4)
    np.testing.assert_array_equal(ranks.poses_t, whole.poses_t)
    np.testing.assert_array_equal(ranks.poses_q, whole.poses_q)
    assert [r["launches"]["octant_lookup"] for r in ranks.ranks] == \
        [2 * counts["octant_lookup"]] * 2
