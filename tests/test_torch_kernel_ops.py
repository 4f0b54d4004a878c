"""The vmap rules of the kernels' custom operators
(``superodom_tpu_torch.kernel_ops``) on the CPU, where no kernel can run:
``kernels``' launch functions are replaced by their plain versions (each
checking that its tensors are contiguous, and a batched one that it got
one leading instance dimension with every instance contiguous), and each
operator is vmapped over three instances with its first tensor unbatched
(shared by every instance) and the others batched on a dimension other
than 0.  Every instance must get its plain version's outputs from ONE
launch, on the instance-dimension and the flattened route alike.  On the
card the same operators make the real launches:
tests/test_torch_kernels_cuda.py."""

import collections

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from superodom_tpu_torch import frontend, inertial  # noqa: E402
from superodom_tpu_torch import kernel_ops, kernels  # noqa: E402
from superodom_tpu_torch import mapstate, registration  # noqa: E402
from superodom_tpu_torch.config import MapConfig, RuntimeParams  # noqa: E402
from superodom_tpu_torch.geometry import Pose, quat_mul, so3_exp  # noqa: E402
from superodom_tpu_torch.ops import voxel  # noqa: E402

REG = registration.RegistrationConfig()


def smoother_instance(dev, seed, w=6):
    """K12a's two entries' inputs for a window of ``w`` states, in their
    custom operators' argument order: random factor Jacobians and
    residuals, an SPD marginal prior, the prior's gate on, the bias map."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dev)

    m = rnd(15, 15)
    prior = (m @ m.T + 15.0 * torch.eye(15, device=dev)).contiguous()
    return {
        "smoother_gn_step": (rnd(w, 6, 15), rnd(w, 6), rnd(w - 1, 15, 30),
                             rnd(w - 1, 15), prior, rnd(15),
                             torch.tensor(1.0, device=dev),
                             inertial._bias_cumsum_map(w, torch.float32,
                                                       dev)),
        "smoother_marginalize": (rnd(15, 30), rnd(15), rnd(6, 15), rnd(6),
                                 prior, rnd(15)),
    }


def kernel_instances(dev, n, nq=300):
    """``n`` instances' inputs of every counted entry, in its custom
    operator's argument order: each instance its own warm map (clustered
    points inserted by the port), queries, plain K1-K3 and K11b outputs,
    a pose, a cloud, a ring-major sweep and a smoother window."""
    cfg = MapConfig(cell_size=1.0, table_size=1 << 12, cell_capacity=16)
    out = []
    for j in range(n):
        g = torch.Generator(device="cpu").manual_seed(100 + j)
        centers = torch.rand((40, 3), generator=g) * 12.0 - 6.0
        pts = (centers[torch.randint(0, 40, (3000,), generator=g)]
               + 0.4 * torch.randn((3000, 3), generator=g)).to(dev)
        m = mapstate.empty_map(cfg, device=dev)
        for c in torch.split(pts, 1000):
            m = mapstate.insert(m, cfg, c.contiguous(),
                                torch.ones(len(c), dtype=torch.bool,
                                           device=dev),
                                torch.tensor(0.05, device=dev))
        q = (pts[:nq] + 0.1 * torch.randn((nq, 3), generator=g).to(dev)
             ).contiguous()
        slots = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
        neigh, sq, nvalid = (x.contiguous() for x in mapstate.
                             knn_select_reference(m.pts, slots, q, 5)[:3])
        red, _ = mapstate.reduce_candidates_reference(m.pts, slots, q, 16, 5)
        mask = (torch.arange(nq, device=dev) % (5 + j)) != 0
        pose = Pose(quat_mul(so3_exp(torch.tensor([0.01, -0.02, 0.03 * j],
                                                  device=dev)),
                             torch.tensor([1.0, 0, 0, 0], device=dev)),
                    torch.tensor([0.1 * j, -0.05, 0.02], device=dev))
        qu, t = pose.q.contiguous(), pose.t.contiguous()
        res = torch.tensor(0.3 + 0.05 * j, device=dev)
        fit = registration.plane_fit_reference(neigh, sq, nvalid, mask, q, qu,
                                               res)
        p_body = pose.inverse().apply(q).contiguous()
        a_sq = (3.0 * res).contiguous()
        n10, s10, v10 = (x.contiguous() for x in mapstate.
                         knn_select_reference(m.pts, slots, q, 10)[:3])
        line_res = torch.tensor(0.1, device=dev)
        lines = registration.edge_fit_reference(
            n10, s10, v10, mask, line_res, REG.min_edge_neighbors,
            REG.edge_max_dist_inlier)
        edges = (p_body[:64].contiguous(), lines[0][:64].contiguous(),
                 lines[1][:64].contiguous(), lines[2][:64].contiguous(),
                 (lines[3][:64] | (torch.arange(64, device=dev) % 3 == 0)))
        cloud = (torch.rand((4000, 3), generator=g) * 40.0 - 20.0).to(dev)
        ring = (torch.arange(4000, device=dev) // 250).to(torch.int32)
        live = (torch.rand((4000,), generator=g) > 0.1).to(dev)
        out.append({
            "octant_lookup": (m.keys, q, float(cfg.cell_size)),
            "knn_select": (m.pts, slots, q, 5),
            "reduce_candidates": (m.pts, slots, q, 16, 5),
            "select_reduced": (*red, (q + 0.02).contiguous(), 5),
            "plane_fit": (neigh, sq, nvalid, mask, q, qu, res),
            "normal_system": (p_body, *fit[:4], qu, t, a_sq, *edges,
                              (3.0 * line_res).contiguous()),
            "gn_solve": (p_body, *fit[:4], fit[5], qu, t, a_sq, 4, 1e-4,
                         qu, (t + 0.05).contiguous(),
                         torch.tensor([40.0, 50.0, 60.0, 10.0, 10.0, 0.0],
                                      device=dev),
                         torch.tensor(j % 2 == 1, device=dev), 10, 0.005,
                         torch.tensor(True, device=dev)) + (None,) * 6,
            "voxel_claim": (cloud, live, res, 14),
            "curvature_edges": (cloud, ring, live, 5, 0.2, 0.5),
            "edge_fit": (n10, s10, v10, mask, line_res,
                         REG.min_edge_neighbors,
                         float(REG.edge_max_dist_inlier)),
            **smoother_instance(dev, 200 + j),
        })
    return out


def _gn_plain(p_body, normal, d, coeff, valid, obs_bins, q, t, a_sq, n_iters,
              damping, prior_q, prior_t, prior_info, prior_enabled, hold_min,
              hold_frac, hold_enabled, e_p, e_a, e_b, e_coeff, e_valid,
              a_sq_e):
    prior = None if prior_q is None else registration.PosePrior(
        Pose(prior_q, prior_t), prior_info, prior_enabled)
    edges = None if e_p is None else registration.EdgeCorrs(
        e_p, e_a, e_b, e_coeff, e_valid, None)
    rt = RuntimeParams(plane_res=a_sq / 3.0,
                       line_res=(a_sq if a_sq_e is None else a_sq_e) / 3.0)
    pose, small = registration.gauss_newton_solve_reference(
        Pose(q, t), registration.PlaneCorrs(p_body, normal, d, coeff, valid,
                                            None, obs_bins),
        edges, rt, n_iters, prior, damping, edges is not None, 1.0,
        hold_min, hold_frac, hold_enabled)
    return torch.cat([pose.q, pose.t]), small


def _ns_plain(p_body, normal, d, coeff, valid, q, t, a_sq, e_p, e_a, e_b,
              e_coeff, e_valid, a_sq_e):
    H, g, cost = registration.normal_system_reference(
        p_body, normal, d, coeff, valid, q, t, a_sq,
        None if e_p is None else (e_p, e_a, e_b, e_coeff, e_valid), a_sq_e)
    return torch.cat([H.reshape(-1), g, cost[None]])


# each entry's plain version, in its custom operator's argument order
PLAIN = {
    "octant_lookup": mapstate.octant_lookup_reference,
    "knn_select": mapstate.knn_select_reference,
    "reduce_candidates": lambda *a: (lambda red, near: red + near)(
        *mapstate.reduce_candidates_reference(*a)),
    "select_reduced": lambda x, y, z, v, q, k:
        mapstate.select_knn_reduced_reference(
            mapstate.ReducedCandidates(x, y, z, v), q, k),
    "plane_fit": registration.plane_fit_reference,
    "normal_system": _ns_plain,
    "gn_solve": _gn_plain,
    "voxel_claim": voxel.voxel_downsample_scatter_reference,
    "curvature_edges": frontend.curvature_edge_extraction_reference,
    "edge_fit": registration.edge_fit_reference,
    "smoother_gn_step": inertial._gn_step_reference,
    "smoother_marginalize": inertial._marginal_system_reference,
}


def _stack_each(fn, n, args):
    """``fn`` over each instance of ``args`` (tensors and tuples of them
    with a leading instance dimension), outputs stacked."""
    def at(x, i):
        if isinstance(x, tuple):
            return tuple(at(e, i) for e in x)
        return x[i] if isinstance(x, torch.Tensor) else x

    outs = [fn(*(at(a, i) for a in args)) for i in range(n)]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))


@pytest.fixture
def fake_launches(monkeypatch):
    """``kernels``' launch functions replaced by the plain versions; the
    returned Counter counts each function's calls, and a batched one
    checks its instance dimension."""
    calls = collections.Counter()

    def single(name, fn):
        def f(*a):
            calls[name] += 1
            assert all(x.is_contiguous() for x in a
                       if isinstance(x, torch.Tensor))
            return fn(*a)
        monkeypatch.setattr(kernels, name, f)

    def batched(name, fn):
        def f(*a):
            calls[name] += 1
            n = a[0].shape[0]
            for x in a:
                for t in (x if isinstance(x, tuple) else (x,)):
                    if isinstance(t, torch.Tensor):
                        assert t.shape[0] == n and t[0].is_contiguous()
            return _stack_each(fn, n, a)
        monkeypatch.setattr(kernels, name, f)

    for name in ("octant_lookup", "knn_select", "reduce_candidates",
                 "plane_fit", "voxel_claim", "curvature_edges", "edge_fit",
                 "smoother_gn_step", "smoother_marginalize"):
        single(name, PLAIN[name])
        batched(f"{name}_batched", PLAIN[name])
    single("select_reduced", PLAIN["select_reduced"])

    def ns_batched(p, n_, d, c, v, q, t, a, edges=None, a_sq_e=None):
        return _ns_plain(p, n_, d, c, v, q, t, a,
                         *(edges or (None,) * 5), a_sq_e)

    def gn_batched(p, n_, d, c, v, bins, q, t, a, n_iters, damping, prior,
                   hold_min, hold_frac, hold_enabled, edges, a_sq_e):
        return _gn_plain(p, n_, d, c, v, bins, q, t, a, n_iters, damping,
                         *(prior or (None,) * 4), hold_min, hold_frac,
                         hold_enabled, *(edges or (None,) * 5), a_sq_e)

    batched("normal_system_batched", ns_batched)
    batched("gn_solve_batched", gn_batched)
    return calls


def _same(a, b):
    return a.shape == b.shape and bool(
        ((a == b) | ((a != a) & (b != b))).all())


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_vmap_rule_serves_every_instance(name, fake_launches):
    per = [a[name] for a in kernel_instances(torch.device("cpu"), 3)]
    op = getattr(kernel_ops, name)
    tensors = [i for i, x in enumerate(per[0]) if isinstance(x, torch.Tensor)]
    shared = tensors[0]
    # the first tensor unbatched; the others batched on their last
    # dimension + 1 (0-d ones on 0)
    args, dims = [], []
    for i, x in enumerate(per[0]):
        if i not in tensors or i == shared:
            args.append(x)
            dims.append(None)
        else:
            d = x.dim()
            args.append(torch.stack([p[i] for p in per], dim=d))
            dims.append(d)
    fake_launches.clear()
    got = torch.func.vmap(op, in_dims=tuple(dims))(*args)
    assert fake_launches == {
        "instance dimension": {f"{name}_batched": 1},
        "flattened": {name: 1}}[kernel_ops.ROUTE[name]]
    got = got if isinstance(got, tuple) else (got,)
    for b, p in enumerate(per):
        want = PLAIN[name](*(per[0][i] if i == shared else x
                             for i, x in enumerate(p)))
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert _same(g[b], w), (name, b)
    # unbatched: the single launch
    fake_launches.clear()
    one = op(*per[1])
    one = one if isinstance(one, tuple) else (one,)
    want = PLAIN[name](*per[1])
    want = want if isinstance(want, tuple) else (want,)
    assert all(_same(o, w) for o, w in zip(one, want))
    assert sum(fake_launches.values()) == 1


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in ("smoother_gn_step", "smoother_marginalize")
    for fault in ("dtype", "shape", "layout")] + [("smoother_gn_step",
                                                   "window")])
def test_smoother_wrappers_refuse_malformed_inputs(name, fault, monkeypatch):
    """K12a's batched wrappers over two instances, every tensor in turn:
    the wrong dtype, a per-instance shape one lane short, instances that
    are not contiguous, each refused with a ValueError for that fault
    before the library loads, and the well-formed CPU call for its device;
    a window of 16 states, whose system does not fit one block's shared
    memory, refused for its size, and one of 15 states not."""
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(kernels, "load", no_load)
    entry = getattr(kernels, f"{name}_batched")

    def fleet(w):
        one = smoother_instance(torch.device("cpu"), 5, w)[name]
        return [x.expand((2,) + x.shape).contiguous() for x in one]

    if fault == "window":
        with pytest.raises(ValueError, match="shared memory"):
            entry(*fleet(16))
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            entry(*fleet(15))
        return
    tensors = fleet(6)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        entry(*tensors)
    for i, t in enumerate(tensors):
        if fault == "dtype":
            bad, want = t.to(torch.float64), "dtype"
        elif fault == "shape":
            bad = (t[:, :-1] if t.dim() > 1 else t[:, None]).contiguous()
            want = "shape"
        elif t.dim() > 1:  # a 0-d instance is contiguous whatever its stride
            bad, want = torch.stack([t, t], dim=-1)[..., 0], "contiguous"
        else:
            continue
        args = list(tensors)
        args[i] = bad
        with pytest.raises(ValueError, match=want):
            entry(*args)
