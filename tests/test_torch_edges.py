"""The edge path of the PyTorch port against the JAX package, at tiny
sizes: the curvature edge extractor (K11a's plain version) bit for bit
over a ring-major sweep and the replay's all-zero ring (the wrap is live
there), padded tails and a NaN row; the line fit (K11b's plain version) on
a pole lattice; the Gauss-Newton normal system and solve (K4's plain
versions) with edge rows, the hold with edge votes and a pose prior; the
ICP loop with edges, fixed-count and with candidate refresh and early exit;
one full step with edges from a transplanted warm JAX state; and the
runner's full-width scan layout with a ring."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu import frontend as jf  # noqa: E402
from superodom_tpu import geometry as jg  # noqa: E402
from superodom_tpu import mapstate as jm  # noqa: E402
from superodom_tpu import registration as jr  # noqa: E402
from superodom_tpu.io.datasets import BoxWorld, make_dataset  # noqa: E402
from superodom_tpu.runner import OdometryRunner as JRunner  # noqa: E402

from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import convert, frontend, kernels  # noqa: E402
from superodom_tpu_torch import pipeline as tp  # noqa: E402
from superodom_tpu_torch import registration as tr  # noqa: E402
from superodom_tpu_torch.geometry import Pose  # noqa: E402
from superodom_tpu_torch.io.datasets import pole_lattice, ring_sweep  # noqa: E402
from superodom_tpu_torch.runner import OdometryRunner  # noqa: E402

MAP = dict(cell_size=1.0, table_size=1 << 13, cell_capacity=16,
           evict_radius=200.0)
LINE_RES, PLANE_RES = 0.1, 0.2
N_EDGE, N_SURF = 256, 512


def T(a):
    return torch.from_numpy(np.array(a))


def test_curvature_edge_extraction_matches_jax_bit_for_bit():
    """Three inputs: a ring-major sweep with its rings; the same lanes with
    the all-zero ring the replay sends (lanes 0-4 and N-5..N-1 see each
    other through the wrap); a padded tail (mask off, zero points) with a
    NaN row and a too-near point.  Two thresholds."""
    xyz, ring = ring_sweep(8, 96)
    n = len(xyz)
    mask = np.ones(n, bool)
    padded = xyz.copy()
    pmask = mask.copy()
    padded[n - 40:] = 0.0
    pmask[n - 40:] = False
    padded[300] = np.nan
    padded[200] = [0.2, 0.1, 0.0]
    cases = [(xyz, ring, mask), (xyz, np.zeros_like(ring), mask),
             (padded, ring, pmask)]
    out = []
    for x, r, m in cases:
        for thr in (0.2, -1.0):  # -1: every lane whose neighbours pass
            ej = np.asarray(jf.curvature_edge_extraction(
                x, r, m, curvature_threshold=thr, min_range=0.5))
            et = frontend.curvature_edge_extraction(
                T(x), T(r), T(m), curvature_threshold=thr,
                min_range=0.5).numpy()
            np.testing.assert_array_equal(et, ej)
            out.append(ej)
    assert all(o.sum() > 20 for o in out)
    # the wrap: under the zero ring the first and last 5 lanes see each
    # other; with the rings, ring 0's first lanes see ring 7's last
    assert out[3][:5].all() and out[3][-5:].all()
    assert not out[1][:5].any() and not out[1][-5:].any()
    # the NaN row, the near point and the padded tail are never edges
    assert not out[5][[200, 300]].any() and not out[5][n - 45:].any()


def _cu_defines(name):
    """The integer ``#define``s of ``csrc/<name>.cu``."""
    import os
    import re
    path = os.path.join(os.path.dirname(kernels.__file__), "csrc",
                        f"{name}.cu")
    with open(path) as f:
        text = f.read()
    return {k: int(v) for k, v in
            re.findall(r"^#define (\w+) (\d+)\b", text, re.M)}


def _curvature_kernel_rule(xyz, ring, mask, hw, thr, min_range, lanes,
                           threads, max_hw):
    """numpy emulation of csrc/curvature_edges.cu, op for op in float32:
    tiles of lanes * threads lanes staged with a halo of ``hw`` a side
    (int32 offsets; contiguous inside an instance, the wrap only in its
    first and last tile, the exact modulo where N <= 2 hw); the gate
    first, from the lanes + 1 ballot words of each warp (bit l of word j
    of warp w: staged positions s = 32 (lanes w + j) + l and s + 1 live
    and on one ring), a lane's 2 hw window bits taken by a 32-bit funnel
    shift of the two words its window starts in, read from the lanes
    that keep them; thread t owning ``lanes`` consecutive lanes and
    streaming its window of lanes + 2 hw staged points once into their
    select-free sums, each in the plain order -hw..-1, +1..hw; the
    curvature only for live lanes.  Staged positions past the tile's span
    hold NaN (uninitialised shared memory on the card).  Returns the edge
    mask and the live lanes' curvatures (NaN elsewhere)."""
    n = len(xyz)
    tile = lanes * threads
    cap = tile + 2 * max_hw
    every = np.uint64((1 << (2 * hw)) - 1)
    den = np.float32(2.0 * hw)
    f32 = np.float32
    out = np.zeros(n, bool)
    curvs = np.full(n, np.nan, np.float32)
    t = np.arange(threads)
    wb = lanes * (t >> 5)  # each thread's warp's first word
    for base in range(0, n, tile):
        tn = min(tile, n - base)
        span = tn + 2 * hw
        g = np.int32(base - hw) + np.arange(span, dtype=np.int32)
        if g[0] >= 0 and base - hw + span <= n:
            j = g
        elif n > 2 * hw:
            j = np.where(g < 0, g + np.int32(n),
                         np.where(g >= n, g - np.int32(n), g))
        else:
            j = np.fmod(np.fmod(g, np.int32(n)) + np.int32(n), np.int32(n))
        sx = np.full((cap, 3), np.nan, np.float32)
        sr = np.zeros(cap, np.int32)
        sm = np.zeros(cap, bool)
        sx[:span], sr[:span], sm[:span] = xyz[j], ring[j], mask[j]
        # word j of every warp (a word the warps' windows reach: at most
        # tile / 32 + 1 of them, all inside the staged capacity)
        s = np.arange(32 * (tile // 32 + 1))
        assert s[-1] + 1 <= cap
        ok = s + 1 < span
        q = np.zeros(len(s), bool)
        q[ok] = sm[s[ok]] & sm[s[ok] + 1] & (sr[s[ok]] == sr[s[ok] + 1])
        words = (q.reshape(-1, 32).astype(np.uint64)
                 << np.arange(32, dtype=np.uint64)).sum(1)
        t0 = lanes * t
        p, rng, live = [], [], []
        for r in range(lanes):
            a = t0 + r
            i = (a >> 5) - wb  # the lane that keeps the first word
            assert i.min() >= 0 and i.max() + 1 <= lanes
            lo, hi = words[wb + i], words[wb + i + 1]
            bits = ((hi << np.uint64(32)) | lo) >> (a & 31).astype(np.uint64)
            pr = sx[a + hw]
            nr = np.sqrt((pr[:, 0] * pr[:, 0] + pr[:, 1] * pr[:, 1])
                         + pr[:, 2] * pr[:, 2])
            p.append(pr)
            rng.append(nr)
            live.append((a < tn) & ((bits & every) == every)
                        & (nr > min_range))
        acc = [np.zeros((threads, 3), np.float32) for _ in range(lanes)]
        for k in range(lanes + 2 * hw):
            qk = sx[t0 + k]
            for r in range(lanes):
                off = k - r - hw
                if off != 0 and -hw <= off <= hw:
                    acc[r] = acc[r] + (qk - p[r])
        for r in range(lanes):
            a = acc[r]
            curv = np.sqrt((a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1])
                           + a[:, 2] * a[:, 2]) / (
                den * np.where(rng[r] < f32(1e-6), f32(1e-6), rng[r]))
            keep = live[r] & (curv > f32(thr))
            lane = t0 + r
            out[base + lane[lane < tn]] = keep[lane < tn]
            on = (lane < tn) & live[r]
            curvs[base + lane[on]] = curv[on]
    return out, curvs


def _plain_order_curvatures(xyz, hw):
    """Each lane's curvature from rolled arrays, the sum in the plain
    order -hw..-1, +1..hw (every neighbour counted: a lane whose gate
    passes)."""
    acc = np.zeros_like(xyz)
    for off in range(-hw, hw + 1):
        if off:
            acc = acc + (np.roll(xyz, -off, 0) - xyz)
    rng = np.sqrt((xyz[:, 0] * xyz[:, 0] + xyz[:, 1] * xyz[:, 1])
                  + xyz[:, 2] * xyz[:, 2])
    return np.sqrt((acc[:, 0] * acc[:, 0] + acc[:, 1] * acc[:, 1])
                   + acc[:, 2] * acc[:, 2]) / (
        np.float32(2.0 * hw) * np.where(rng < np.float32(1e-6),
                                        np.float32(1e-6), rng))


def test_curvature_kernel_rule_matches_jax():
    """K11a's kernel rule (``_curvature_kernel_rule``, at the tile and the
    lanes a thread that csrc/curvature_edges.cu defines) against the
    port's plain version bit for bit at N of 1, 2, 3, 7, 10, 11 (narrower
    than some stencils: lanes see themselves and neighbours twice), T - 1,
    T, T + 1 and 2T + 5 for the tile T (the wrap in the first and last
    tile only, a short last tile), each at half windows 1, 5 and 16; on a
    ring-major sweep with its rings, the zero ring (the wrap is live) and
    rings of 33 lanes (a boundary at every bit of a 32-lane word) with
    mask holes 2w + 2 apart (windows ending on a hole, and just inside
    one) and NaN / inf rows; at thresholds 0.2 and -1; every live lane's
    curvature bit for bit the sum in the plain order.  JAX's
    ``curvature_edge_extraction`` is held to both at every N with one half
    window each (w = 16 at N = 2, where lanes see themselves; one XLA
    compile a pair, ~0.2-0.7 s each, keeps the test within seconds)."""
    d = _cu_defines("curvature_edges")
    lanes, threads, max_hw = d["CE_R"], d["CE_THREADS"], d["CE_MAX_HW"]
    tile = lanes * threads
    assert (lanes, tile) == (kernels.CURVATURE_LANES, kernels.CURVATURE_TILE)
    assert lanes % 2 == 1  # the stencil's shared reads hit 32 banks
    sweep, sweep_ring = ring_sweep(8, 2 * tile // 8 + 2)
    jax_fn = jax.jit(jf.curvature_edge_extraction, static_argnums=(3,))
    sizes = (1, 2, 3, 7, 10, 11, tile - 1, tile, tile + 1, 2 * tile + 5)
    jax_hw = dict(zip(sizes, (5, 16, 1, 5, 1, 5, 1, 5, 1, 5)))
    edges = held = 0
    for n in sizes:
        xyz = sweep[:n]
        bad = xyz.copy()
        bad[n // 3] = np.nan
        bad[n // 2, 1] = np.inf
        bad[(2 * n) // 3, 2] = -np.inf
        for hw in (1, 5, 16):
            holes = np.ones(n, bool)
            holes[n // 4::2 * hw + 2] = False
            cases = [(xyz, sweep_ring[:n], np.ones(n, bool)),
                     (xyz, np.zeros(n, np.int32), np.ones(n, bool)),
                     (bad, ((np.arange(n) + 1) // 33).astype(np.int32),
                      holes)]
            for x, r, m in cases:
                with np.errstate(all="ignore"):
                    want = _plain_order_curvatures(x, hw)
                for thr in (0.2, -1.0):
                    with np.errstate(all="ignore"):
                        got, curv = _curvature_kernel_rule(
                            x, r, m, hw, thr, 0.5, lanes, threads, max_hw)
                    live = ~np.isnan(curv)
                    np.testing.assert_array_equal(curv[live], want[live])
                    plain = frontend.curvature_edge_extraction_reference(
                        T(x), T(r), T(m), hw, thr, 0.5).numpy()
                    np.testing.assert_array_equal(got, plain,
                                                  f"n={n} w={hw} thr={thr}")
                    if jax_hw[n] == hw:
                        np.testing.assert_array_equal(plain, np.asarray(
                            jax_fn(x, r, m, hw, np.float32(thr),
                                   np.float32(0.5))))
                        held += 1
                    edges += int(plain.sum())
    assert held == len(sizes) * 6 and edges > 10000


@pytest.fixture(scope="module")
def poles():
    """A lattice of vertical poles (edge map) inside a box room (surface
    map), both inserted by the JAX package, and a scan of both seen from a
    known pose: (edge map, surf map, edge body pts, surf body pts, true
    pose (q, t), start pose (q, t))."""
    rng = np.random.default_rng(4)
    pole = pole_lattice(rng)
    walls = []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            p = rng.uniform(-8, 8, (900, 3))
            p[:, axis] = sign * 8.0
            walls.append(p)
    walls = np.concatenate(walls)
    walls = (walls + rng.normal(scale=0.005, size=walls.shape)).astype(
        np.float32)
    cfg = jcfg.MapConfig(**MAP)
    ins = jax.jit(lambda m, x, k, res: jm.insert(m, cfg, x, k, res))
    em = sm = jm.empty_map(cfg)
    for chunk in np.array_split(pole, 2):
        em = ins(em, chunk, np.ones(len(chunk), bool), np.float32(0.03))
    for chunk in np.array_split(walls, 3):
        sm = ins(sm, chunk, np.ones(len(chunk), bool), np.float32(PLANE_RES))
    q_true = np.asarray(jg.quat_from_rpy(np.float32(0.0), np.float32(0.0),
                                         np.float32(0.04)))
    t_true = np.array([0.15, -0.1, 0.05], np.float32)
    rot = np.asarray(jg.quat_to_matrix(q_true), np.float64)
    e_body = ((pole[rng.choice(len(pole), N_EDGE, replace=False)] - t_true)
              @ rot).astype(np.float32)
    s_body = ((walls[rng.choice(len(walls), N_SURF, replace=False)] - t_true)
              @ rot).astype(np.float32)
    dq = np.asarray(jg.so3_exp(np.array([0.003, -0.002, 0.01], np.float32)))
    q0 = np.asarray(jg.quat_mul(dq, q_true), np.float32)
    t0 = (t_true + np.array([0.03, -0.02, 0.01])).astype(np.float32)
    return (jax.device_get(em), jax.device_get(sm), e_body, s_body,
            (q_true, t_true), (q0, t0))


REG = jcfg.RegistrationConfig()


def _corrs_j(poles):
    """The JAX package's plane and line correspondences at the start
    pose, and the line fit's inputs."""
    em, sm, e_body, s_body, _, (q0, t0) = poles
    cfg = jcfg.MapConfig(**MAP)
    e_mask = np.arange(N_EDGE) % 13 != 0

    @jax.jit
    def both(em, sm, pose):
        w = pose.apply(e_body)
        cand, cvalid = jm.gather_candidates(em, cfg, w)
        neigh, sq, nvalid = jm.select_knn(cand, cvalid, w, REG.edge_knn)
        lines = jr._edge_fit(neigh, sq, nvalid, REG, pose, e_body, e_mask,
                             jnp.float32(LINE_RES), w)
        planes = jr.compute_plane_correspondences(
            sm, cfg, REG, pose, s_body, np.ones(N_SURF, bool),
            jnp.float32(PLANE_RES))
        return planes, lines, (neigh, sq, nvalid)

    planes, lines, knn = jax.device_get(both(em, sm, jg.Pose(q0, t0)))
    return planes, lines, (*knn, e_mask)


@pytest.fixture(scope="module")
def corrs(poles):
    return _corrs_j(poles)


def test_edge_fit_reference_matches_jax(corrs):
    """Codes, validity equal off the lanes at a gate margin; endpoints and
    coefficients of the valid lines within 1e-5; most fits valid."""
    _, lj, (neigh, sq, nvalid, e_mask) = corrs
    a, b, coeff, valid, code = tr.edge_fit(
        T(neigh), T(sq), T(nvalid), T(e_mask), torch.tensor(LINE_RES),
        REG.min_edge_neighbors, REG.edge_max_dist_inlier)
    far = ~tr.edge_gate_margin_lanes(
        T(neigh), T(sq), T(nvalid), torch.tensor(LINE_RES),
        REG.min_edge_neighbors, REG.edge_max_dist_inlier).numpy()
    assert far.mean() > 0.9 and lj.valid.mean() > 0.5
    assert (lj.code != 0).sum() > 10  # rejected lines are compared too
    np.testing.assert_array_equal(valid.numpy()[far], lj.valid[far])
    np.testing.assert_array_equal(code.numpy()[far], lj.code[far])
    used = far & lj.valid
    np.testing.assert_allclose(a.numpy()[used], lj.a[used], atol=1e-5)
    np.testing.assert_allclose(b.numpy()[used], lj.b[used], atol=1e-5)
    np.testing.assert_allclose(coeff.numpy()[far], lj.coeff[far], atol=1e-5)
    ab = (lj.a - lj.b)[lj.valid]  # the poles are vertical
    assert np.abs(ab[:, 2] / np.linalg.norm(ab, axis=1)).min() > 0.95


INFO = np.array([40.0, 50.0, 60.0, 10.0, 10.0, 0.0], np.float32)


def _prior(poles, on):
    _, _, _, _, _, (q0, t0) = poles
    return jr.PosePrior(pose=jg.Pose(q0, (t0 + 0.05).astype(np.float32)),
                        information=INFO, enabled=np.asarray(on))


def test_normal_system_with_edges_matches_jax(poles, corrs):
    """H, g and cost of planes and lines at an annealed support with an
    enabled prior, within 1e-4 of their scale; the dispatching wrapper
    takes the plain version on the CPU."""
    planes, lines, _ = corrs
    _, _, _, _, _, (q0, t0) = poles
    rt_j = jcfg.RuntimeParams(np.float32(LINE_RES), np.float32(PLANE_RES))
    Hj, gj, cj = jr._accumulate_normal_system(
        jg.Pose(q0, t0), planes, lines, rt_j, _prior(poles, True),
        use_edges=True, a_mult=0.5)
    Hp, _, _ = jr._accumulate_normal_system(
        jg.Pose(q0, t0), planes, lines, rt_j, None, use_edges=False)
    rt = tcfg.RuntimeParams(torch.tensor(LINE_RES), torch.tensor(PLANE_RES))
    Ht, gt, ct = tr._accumulate_normal_system(
        Pose(T(q0), T(t0)), convert.from_numpy(planes),
        convert.from_numpy(lines), rt, convert.from_numpy(_prior(poles, True)),
        use_edges=True, a_mult=torch.tensor(0.5))
    scale = float(np.abs(Hj).max())
    # the lines carry a real share of the system
    assert np.abs(np.asarray(Hj) - np.asarray(Hp)).max() > 0.05 * scale
    np.testing.assert_allclose(Ht.numpy(), Hj, atol=1e-4 * scale)
    np.testing.assert_allclose(gt.numpy(), gj,
                               atol=1e-4 * float(np.abs(gj).max()))
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)


@pytest.mark.parametrize("case", ["hold_edge_votes", "prior"])
def test_gauss_newton_solve_with_edges_matches_jax(poles, corrs, case):
    """The plain GN solve with edge rows against the JAX solve: with the
    hold armed where only the edges' votes keep x and y free (the planes
    here vote at most 15 times an axis), and with an enabled prior (which
    releases the hold)."""
    planes, lines, _ = corrs
    _, _, _, _, _, (q0, t0) = poles
    on = case == "prior"
    kw = dict(axis_hold_min=60, axis_hold_frac=0.5)
    # planes' votes alone are cut to 15 an axis at most
    keep = np.zeros_like(planes.valid)
    for ax in range(3):
        keep[np.flatnonzero((planes.obs_bins[:, 2] == 6 + ax)
                            & planes.valid)[:15]] = True
    pl = planes._replace(valid=keep, coeff=np.where(keep, planes.coeff, 0.0),
                         obs_bins=np.where(keep[:, None], planes.obs_bins, -1))
    rt_j = jcfg.RuntimeParams(np.float32(LINE_RES), np.float32(PLANE_RES))
    pose_j, small_j = jr.gauss_newton_solve(
        jg.Pose(q0, t0), pl, lines, rt_j, 4, _prior(poles, on),
        use_edges=True, a_mult=1.0, hold_enabled=np.asarray(True), **kw)
    pl_t, li_t = convert.from_numpy(pl), convert.from_numpy(lines)
    prior_t = convert.from_numpy(_prior(poles, on))
    rt = tcfg.RuntimeParams(torch.tensor(LINE_RES), torch.tensor(PLANE_RES))
    pose_t, small_t = tr.gauss_newton_solve(
        Pose(T(q0), T(t0)), pl_t, li_t, rt, 4, prior_t, use_edges=True,
        hold_enabled=torch.tensor(True), **kw)
    held = tr.axis_hold_mask(pl_t, 60, 0.5, prior_t, torch.tensor(True),
                             li_t, T(q0)).numpy()
    held_planes = tr.axis_hold_mask(pl_t, 60, 0.5, prior_t,
                                    torch.tensor(True)).numpy()
    if on:
        assert not held.any()
    else:  # vertical lines vote x and y, never z
        assert held.tolist() == [False, False, True]
        assert held_planes.all()
    np.testing.assert_allclose(pose_t.q.numpy(), pose_j.q, atol=1e-4)
    np.testing.assert_allclose(pose_t.t.numpy(), pose_j.t, atol=1e-4)
    assert bool(small_t) == bool(small_j)


@pytest.mark.parametrize("case", ["fixed_count", "refresh_early_exit"])
def test_icp_register_with_edges_matches_jax(poles, case):
    """The ICP loop with edges: 2 rounds at full width every round
    (fixed-count), and the parity budget (5 rounds, candidate refresh from
    16 lanes, the edges' from 20, early exit).  Pose within 1e-4; the
    round count, the per-round line counts and the line rejection histogram
    equal, the planes' within the lanes at a plane-fit gate margin."""
    em, sm, e_body, s_body, (q_true, t_true), (q0, t0) = poles
    kw = (dict(max_icp_iters=2, icp_early_exit=False, tukey_anneal=0.25)
          if case == "fixed_count" else
          dict(max_icp_iters=5, refresh_width=16, tukey_anneal=0.25))
    e_mask = np.arange(N_EDGE) % 13 != 0
    s_mask = np.ones(N_SURF, bool)
    rt_j = jcfg.RuntimeParams(np.float32(LINE_RES), np.float32(PLANE_RES))
    icp = jax.jit(lambda e, s, p: jr.icp_register(
        e, s, jcfg.MapConfig(**MAP), jcfg.RegistrationConfig(**kw), p,
        e_body, e_mask, s_body, s_mask, rt_j, None, use_edges=True,
        hold_enabled=np.asarray(False)))
    pose_j, st_j = jax.device_get(icp(em, sm, jg.Pose(q0, t0)))
    counts = dict(kernels.launch_counts)
    pose_t, st_t = tr.icp_register(
        convert.voxel_map_from_numpy(em), convert.voxel_map_from_numpy(sm),
        tcfg.MapConfig(**MAP), tcfg.RegistrationConfig(**kw),
        Pose(T(q0), T(t0)), T(e_body), T(e_mask), T(s_body), T(s_mask),
        tcfg.RuntimeParams(torch.tensor(LINE_RES), torch.tensor(PLANE_RES)),
        None, use_edges=True, hold_enabled=torch.tensor(False))
    assert kernels.launch_counts == counts  # the CPU launches no kernel
    np.testing.assert_allclose(pose_t.q.numpy(), pose_j.q, atol=1e-4)
    np.testing.assert_allclose(pose_t.t.numpy(), pose_j.t, atol=1e-4)
    assert np.abs(pose_j.t - t_true).max() < 0.01  # it registered
    n_it = int(st_j.n_iterations)
    assert int(st_t.n_iterations) == n_it and n_it >= 2
    np.testing.assert_array_equal(st_t.iter_edge_num.numpy(),
                                  st_j.iter_edge_num)
    assert (st_j.iter_edge_num[:n_it] > N_EDGE // 2).all()
    np.testing.assert_array_equal(st_t.line_rejection_hist.numpy(),
                                  st_j.line_rejection_hist)
    # a plane-fit lane within 1e-5 of a gate may flip (as in
    # tests/test_torch_icp.py)
    np.testing.assert_allclose(st_t.iter_surf_num.numpy(),
                               st_j.iter_surf_num, atol=3)
    np.testing.assert_allclose(st_t.plane_rejection_hist.numpy(),
                               st_j.plane_rejection_hist, atol=3)
    np.testing.assert_allclose(st_t.iter_trans_norm.numpy(),
                               st_j.iter_trans_norm, atol=1e-4)


STEP_AT = 14  # past static IMU init and the 10-frame startup window


def _tiny_edges(mod):
    """tests/test_torch_paths.py's tiny parity configuration with edges."""
    sensor = mod.SensorProfile(
        name="velodyne", n_scan_lines=16, max_points=4096, min_range=0.2,
        max_range=130.0, filter_point_size=2, max_surface_features=768,
        max_edge_features=64, scan_period=0.1, default_line_res=0.1,
        default_plane_res=0.2, scan_thin_mode="range")
    return mod.PipelineConfig(
        sensor=sensor, map=mod.MapConfig(**MAP),
        registration=mod.RegistrationConfig(max_icp_iters=5, refresh_width=16,
                                            tukey_anneal=0.25),
        imu=mod.ImuConfig(max_imu_per_scan=48, window_size=6,
                          smoother_gn_iters=2),
        auto_voxel_size=False, use_edge_features=True)


def test_one_step_with_edges_matches_jax():
    """One step from the JAX package's warm state of frame 14 (its edge map
    live): pose 1e-4; both maps' keys and counts exact after the step; the
    edge features, the stack and census counts equal."""
    ds = make_dataset(np.random.default_rng(11), n_scans=STEP_AT + 1,
                      points_per_scan=3000, radius=2.0, laps=0.1,
                      world=BoxWorld(half_extent=np.array([8.0, 6.0, 3.0])),
                      static_scans=12)
    runner = JRunner(_tiny_edges(jcfg))
    imu_i = 0
    for i, s in enumerate(ds.scans):
        t_end = s.t_start + float(s.t_rel[-1])
        while imu_i < len(ds.imu.t) and ds.imu.t[imu_i] <= t_end + 0.02:
            runner.add_imu(ds.imu.t[imu_i], ds.imu.acc[imu_i],
                           ds.imu.gyr[imu_i])
            imu_i += 1
        if i < STEP_AT:
            runner.process_scan(s.t_start, s.xyz_body, s.t_rel)
    scan = runner.make_scan(s.t_start, s.xyz_body, s.t_rel)
    win, ok = runner._imu_window(s.t_start, t_end)
    before = jax.device_get(runner.state)
    after_j, out_j = jax.device_get(runner.step_fn(before, scan, win,
                                                   np.asarray(ok)))
    assert ok and int((before.edge_map.keys >= 0).sum()) > 100
    assert scan.xyz.shape[0] == 4096  # the full-width layout
    after_t, out_t = tp.step(_tiny_edges(tcfg),
                             convert.odom_state_from_numpy(before),
                             convert.scan_from_numpy(scan),
                             convert.imu_window_from_numpy(win),
                             torch.tensor(bool(ok)))
    np.testing.assert_allclose(out_t.pose.q.numpy(), out_j.pose.q, atol=1e-4)
    np.testing.assert_allclose(out_t.pose.t.numpy(), out_j.pose.t, atol=1e-4)
    for f in ("surf_stack_num", "edge_stack_num", "surf_map_num",
              "edge_map_num", "prediction_source", "motion_accepted"):
        assert np.asarray(getattr(out_t, f)) == np.asarray(getattr(out_j, f)), f
    assert int(out_j.edge_stack_num) > 20
    assert int(out_t.icp.n_iterations) == int(out_j.icp.n_iterations)
    np.testing.assert_array_equal(out_t.icp.line_rejection_hist.numpy(),
                                  out_j.icp.line_rejection_hist)
    for name in ("surf_map", "edge_map"):
        mt, mj = getattr(after_t, name), getattr(after_j, name)
        np.testing.assert_array_equal(mt.keys.numpy(), mj.keys)
        np.testing.assert_array_equal(mt.cnt.numpy(), mj.cnt)
        np.testing.assert_allclose(mt.pts.numpy(), mj.pts, atol=1e-4)
    assert int(after_j.edge_map.cnt.sum()) > int(before.edge_map.cnt.sum())


def test_make_scan_full_width_layout_with_ring():
    """With edges on the runner ships the full padded cloud with its ring
    (zeros past the points, all zeros without one), as the JAX runner; with
    edges off it decimates on the host."""
    cfg_e = _tiny_edges(tcfg)
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(3000, 3)).astype(np.float32)
    t_rel = np.linspace(0.0, 0.1, 3000, dtype=np.float32)
    ring = (np.arange(3000) // 200).astype(np.int32)
    jrun = JRunner(_tiny_edges(jcfg))
    for r in (ring, None):
        sj = jrun.make_scan(0.5, xyz, t_rel, r)
        st = OdometryRunner(cfg_e, device="cpu").make_scan(0.5, xyz, t_rel, r)
        for f in sj._fields:
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(sj, f)), f)
        assert st.xyz.shape == (4096, 3) and st.ring.dtype == torch.int32
    assert int(st.ring.abs().sum()) == 0
    off = dataclasses.replace(cfg_e, use_edge_features=False)
    dec = OdometryRunner(off, device="cpu").make_scan(0.5, xyz, t_rel, ring)
    assert dec.xyz.shape[0] == frontend.decimated_width(4096, 2)
