"""Many odometry instances in one step (``superodom_tpu_torch.parallel``)
on the CPU, at tiny sizes, where the plain versions carry the kernels and
batch under ``torch.func.vmap`` by themselves:

* the vmapped port step against the port's single step, three instances
  on three datasets (tests/test_torch_pipeline.py's tiny ship
  configuration at fixed count), pose within 1e-5 m;
* against the JAX package's ``make_batched_step`` (one device): two
  instances, each step from JAX's carried batched state, the ICP pose
  within 1e-4 m, the next maps' keys and counts exact;
* the repairs that let vmap through the step (out-of-place writes in the
  insert, the smoother, the voxel thinning; the map cadence decided per
  instance on the device), under tests/test_torch_paths.py's tiny parity,
  VLP-16 and cadence-2 configurations and parity with edges: each
  instance against its single step, the two instances at frame counts
  that differ;
* ``replay_batched`` against each dataset's own replays;
* ``ops.invariant``: each instance gets its single call's bits.

The kernels' vmap rules: tests/test_torch_kernel_ops.py; the batched
kernels on the card: tests/test_torch_kernels_cuda.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from test_torch_paths import _tiny as _tiny_path  # noqa: E402
from test_torch_pipeline import _tiny as _tiny_ship  # noqa: E402

from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu import parallel as jpar  # noqa: E402
from superodom_tpu.runner import OdometryRunner as JRunner  # noqa: E402

from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import convert, kernels, parallel  # noqa: E402
from superodom_tpu_torch import pipeline as tp  # noqa: E402
from superodom_tpu_torch.io.datasets import (  # noqa: E402
    BoxWorld,
    make_dataset,
)
from superodom_tpu_torch.ops import invariant as inv  # noqa: E402
from superodom_tpu_torch.runner import OdometryRunner  # noqa: E402


def _dataset(seed, n_scans):
    """A moving platform from its second scan on (the IMU stream is
    ingested whole before the first window is cut)."""
    return make_dataset(np.random.default_rng(seed), n_scans=n_scans,
                        points_per_scan=3000, radius=2.0, laps=0.1,
                        world=BoxWorld(half_extent=np.array([8.0, 6.0, 3.0])),
                        static_scans=1)


def _inputs(cfg, seeds, n_scans):
    """Each dataset's step inputs (all IMU first), stacked: leaves
    [n_scans, B, ...]; and the configuration the runner steps with."""
    built = []
    for seed in seeds:
        runner = OdometryRunner(cfg, device="cpu")
        stacked, _, _ = runner.stack_chunked_inputs(_dataset(seed, n_scans),
                                                    chunk=n_scans)
        built.append(stacked)
    inputs = tp.tree_map(lambda *xs: torch.from_numpy(
        np.stack([np.array(x[0]) for x in xs], axis=1)), *built)
    return inputs, runner.step_cfg


def _fleet_state(cfg, frames):
    """The initial state of len(frames) instances, instance b at frame
    count frames[b]."""
    state = parallel.batched_init_state(cfg, len(frames), device="cpu")
    return state._replace(frame_count=torch.tensor(frames, dtype=torch.int32))


def _hold_against_single_steps(cfg, seeds, n_scans, frames, atol):
    """Step the fleet and each instance alone; every instance's pose
    within ``atol`` of its own, scan by scan, and its map's keys and
    counts exact.  Returns the fleet's outputs."""
    inputs, step_cfg = _inputs(cfg, seeds, n_scans)
    vstep = parallel.make_batched_step(step_cfg, device="cpu")
    fleet = _fleet_state(step_cfg, frames)
    singles = [tp.tree_map(lambda a: a[b], fleet) for b in range(len(seeds))]
    counts = dict(kernels.launch_counts)
    outs = []
    for i in range(n_scans):
        fleet, out = vstep(fleet, *tp.tree_map(lambda a: a[i], inputs))
        outs.append(out)
        for b in range(len(seeds)):
            singles[b], one = tp.step(
                step_cfg, singles[b], *tp.tree_map(lambda a: a[i, b], inputs))
            np.testing.assert_allclose(out.pose.t[b].numpy(),
                                       one.pose.t.numpy(), atol=atol)
            np.testing.assert_allclose(out.pose.q[b].numpy(),
                                       one.pose.q.numpy(), atol=atol)
            for m in ("surf_map", "edge_map"):
                for f in ("keys", "cnt"):
                    assert torch.equal(getattr(getattr(fleet, m), f)[b],
                                       getattr(getattr(singles[b], m), f))
    assert kernels.launch_counts == counts  # the CPU launches no kernel
    return outs


def test_vmapped_step_matches_single_steps():
    """Three instances on three datasets, 10 scans: each within 1e-5 m of
    its own single step, and the instances really differ."""
    cfg = _tiny_ship(tcfg, early_exit=False)
    outs = _hold_against_single_steps(cfg, (3, 4, 5), 10, (0, 0, 0), 1e-5)
    t = torch.stack([o.pose.t for o in outs])  # [n, B, 3]
    assert float((t[:, 0] - t[:, 1]).abs().max()) > 1e-3
    assert int(outs[-1].surf_map_num.min()) > 1000


@pytest.mark.parametrize("kind,edges", [("parity", False), ("vlp16", False),
                                        ("cadence_2", False),
                                        ("parity", True)],
                         ids=["parity", "vlp16", "cadence_2", "parity_edges"])
def test_vmap_repairs_match_single_steps(kind, edges):
    """4 scans of two instances at frame counts 7 and 8: the map cadence
    (insert while the frame count is below 8 or even, evict when even),
    the startup window and the axis hold part them within one batched
    step."""
    cfg = _tiny_path(tcfg, kind)
    cfg = dataclasses.replace(
        cfg, use_edge_features=edges,
        registration=dataclasses.replace(cfg.registration,
                                         icp_early_exit=False))
    _hold_against_single_steps(cfg, (3, 4), 4, (7, 8), 1e-5)


def test_batched_step_refuses_early_exit():
    """Under vmap the step cannot read the converged flag on the host."""
    cfg = _tiny_ship(tcfg, early_exit=True)
    inputs, step_cfg = _inputs(cfg, (3, 4), 2)
    with pytest.raises(ValueError, match="icp_early_exit"):
        torch.func.vmap(lambda s, sc, im, av: tp.step(step_cfg, s, sc, im,
                                                      av))(
            _fleet_state(step_cfg, (0, 0)),
            *tp.tree_map(lambda a: a[0], inputs))


def test_replay_batched_on_the_cpu():
    """Two instances, 8 scans in chunks of 4 (plus one scan after the
    timed window): each instance's poses equal its own fixed-count
    chunked replay and its B = 1 batched replay."""
    cfg = _tiny_ship(tcfg, early_exit=False)
    data = [_dataset(3, 9), _dataset(4, 9)]
    res = parallel.replay_batched(cfg, data, chunk=4, device="cpu")
    assert res.poses_t.shape == (9, 2, 3) and res.poses_q.shape == (9, 2, 4)
    assert len(res.chunk_ms) == 2 and res.aggregate_scans_per_sec > 0
    assert [len(s) for s in res.stats] == [9, 9]
    for b, ds in enumerate(data):
        one = parallel.replay_batched(cfg, [ds], chunk=4, device="cpu")
        chunked = OdometryRunner(cfg, device="cpu").run_dataset_chunked(
            ds, chunk=4)
        np.testing.assert_array_equal(res.poses_t[:, b], one.poses_t[:, 0])
        np.testing.assert_array_equal(res.poses_t[:, b], chunked.poses_t)
        np.testing.assert_array_equal(res.poses_q[:, b], chunked.poses_q)
        assert [s["n_iterations"] for s in res.stats[b]] == \
            [s["n_iterations"] for s in chunked.stats]
    with pytest.raises(ValueError, match="differ in length"):
        parallel.replay_batched(cfg, [data[0], _dataset(5, 8)], chunk=4,
                                device="cpu")


def test_batched_step_matches_jax():
    """The JAX package's ``make_batched_step`` on a one-device mesh, two
    instances on two datasets, 5 scans: each port step from JAX's carried
    batched state (``convert.from_numpy`` maps the batched trees) gives
    the ICP pose within 1e-4 m and the next maps' keys and counts exact."""
    n = 5
    cfg_j = _tiny_ship(jcfg, early_exit=False)
    cfg_t = _tiny_ship(tcfg, early_exit=False)
    built = []
    for seed in (3, 4):
        host, _ = JRunner(cfg_j).stack_chunked_inputs(_dataset(seed, n),
                                                      chunk=n)
        built.append(host)
    # [n, B, ...] leaves: the JAX package's trees, numpy leaves
    inputs = jax.tree_util.tree_map(
        lambda *xs: np.stack([x[0] for x in xs], axis=1), *built)
    mesh = jpar.make_mesh(jax.devices()[:1], data=1, model=1)
    step_fn, shard_state = jpar.make_batched_step(cfg_j, mesh)
    state_j = shard_state(jpar.batched_init_state(cfg_j, 2))
    vstep = parallel.make_batched_step(cfg_t, device="cpu")
    moved = 0.0
    for i in range(n):
        before = jax.device_get(state_j)
        inp = jax.tree_util.tree_map(lambda a: a[i], inputs)
        state_j, out_j = step_fn(state_j, *inp)
        after_j, out_j = jax.device_get((state_j, out_j))
        after_t, out_t = vstep(convert.from_numpy(before),
                               *(convert.from_numpy(x) for x in inp))
        np.testing.assert_allclose(out_t.pose.t.numpy(), out_j.pose.t,
                                   atol=1e-4)
        np.testing.assert_allclose(out_t.pose.q.numpy(), out_j.pose.q,
                                   atol=1e-4)
        for m in ("surf_map", "edge_map"):
            for f in ("keys", "cnt"):
                np.testing.assert_array_equal(
                    getattr(getattr(after_t, m), f).numpy(),
                    getattr(getattr(after_j, m), f))
        np.testing.assert_array_equal(out_t.icp.n_iterations.numpy(),
                                      out_j.icp.n_iterations)
        moved = max(moved, float(np.abs(out_j.pose.t).max()))
    assert moved > 0.01  # the instances moved


def test_invariant_ops_give_each_instance_its_single_call():
    """``ops.invariant``'s matrix product, einsum, solve and sum: under
    vmap each instance gets the single call's bits (the card's batched
    products and solves would not; on the CPU the loop is what is
    checked), outside vmap they are the plain ops."""
    g = torch.Generator().manual_seed(0)
    A = torch.randn((3, 15, 15), generator=g)
    A = A @ A.transpose(1, 2) + 15 * torch.eye(15)
    b = torch.randn((3, 15), generator=g)
    T = torch.randn((15, 15), generator=g)
    cases = [
        (inv.matmul, torch.matmul, (T, A), (None, 0)),
        (inv.matmul, torch.matmul, (A, b), (0, 0)),
        (lambda x, y: inv.einsum("ij,jk->ik", x, y),
         lambda x, y: torch.einsum("ij,jk->ik", x, y), (A, T), (0, None)),
        (inv.solve, lambda x, y: torch.linalg.solve_ex(x, y)[0],
         (A, b[:, :, None]), (0, 0)),
        (inv.reduce_sum, torch.sum, (b.t(),), (1,)),
        (lambda x: inv.reduce_sum(x, 0), lambda x: torch.sum(x, 0),
         (A.transpose(0, 2),), (2,)),
    ]
    for op, plain, args, dims in cases:
        got = torch.func.vmap(op, in_dims=dims)(*args)
        for i in range(3):
            one = [a if d is None else a.select(d, i)
                   for a, d in zip(args, dims)]
            assert torch.equal(got[i], plain(*one))
            assert torch.equal(op(*one), plain(*one))
