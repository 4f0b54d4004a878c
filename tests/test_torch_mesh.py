"""The fleet over a mesh (``superodom_tpu_torch.parallel.make_mesh``,
``replay_mesh``; ``mapstate.ShardedMap``) on the CPU, at tiny sizes:

* K1's plain version with a shard window: merged over M = 1, 2 and 4
  windows, the whole table's lookup exactly;
* a fleet whose maps are split over M shards against the same fleet
  unsplit, several steps, poses and the whole (``unshard``) maps equal to
  the bit: M = 2 and 4 on tests/test_torch_pipeline.py's tiny ship
  configuration, M = 2 on tests/test_torch_paths.py's tiny parity
  configuration with edges (candidate refresh, the edge map), and M = 2
  with an insert width below the feature count (the global prefix cap,
  shown to bite);
* against the JAX package's ``make_batched_step`` on a data=2 x model=2
  mesh of 4 of the 8 virtual CPU devices: each port step from JAX's
  carried state, the ICP pose within 1e-4 m, the next maps exact;
* two ``gloo`` ranks, each with its maps in two shards, against one
  process, to the bit, every ``torch.distributed`` collective raising
  inside the ranks' timed windows;
* a sharded state's checkpoint loading whole in either package and split
  again, to the same bits; the prior-map insert on a sharded map.

The windowed K1 on the card: tests/test_torch_kernels_cuda.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from test_torch_paths import _tiny as _tiny_path  # noqa: E402
from test_torch_pipeline import _tiny as _tiny_ship  # noqa: E402

from superodom_tpu import checkpoint as jckpt  # noqa: E402
from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu import parallel as jpar  # noqa: E402
from superodom_tpu.runner import OdometryRunner as JRunner  # noqa: E402

from superodom_tpu_torch import checkpoint, convert, mapstate  # noqa: E402
from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import parallel  # noqa: E402
from superodom_tpu_torch import pipeline as tp  # noqa: E402
from superodom_tpu_torch.io.datasets import BoxWorld, make_dataset  # noqa: E402
from superodom_tpu_torch.runner import OdometryRunner  # noqa: E402

CPU = torch.device("cpu")
N_STEPS = 3


def _dataset(seed, n_scans):
    """A moving platform from its second scan on."""
    return make_dataset(np.random.default_rng(seed), n_scans=n_scans,
                        points_per_scan=3000, radius=2.0, laps=0.1,
                        world=BoxWorld(half_extent=np.array([8.0, 6.0, 3.0])),
                        static_scans=1)


def _fixed(cfg):
    return dataclasses.replace(cfg, registration=dataclasses.replace(
        cfg.registration, icp_early_exit=False))


def _inputs(cfg, seeds, n_scans):
    """Each dataset's step inputs, stacked: leaves [n_scans, B, ...]; and
    the configuration the runner steps with."""
    built = []
    for seed in seeds:
        runner = OdometryRunner(cfg, device="cpu")
        stacked, _, _ = runner.stack_chunked_inputs(_dataset(seed, n_scans),
                                                    chunk=n_scans)
        built.append(stacked)
    inputs = tp.tree_map(lambda *xs: torch.from_numpy(
        np.stack([np.array(x[0]) for x in xs], axis=1)), *built)
    return inputs, runner.step_cfg


def _equal_trees(a, b):
    flat_a, flat_b = [], []
    tp.tree_map(flat_a.append, a)
    tp.tree_map(flat_b.append, b)
    return len(flat_a) == len(flat_b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(flat_a, flat_b))


@pytest.mark.parametrize("M", [1, 2, 4])
def test_windowed_octant_lookup_merges_to_the_whole_table(M):
    """K1's plain version over M windows of a warm map, merged by an
    elementwise maximum: the whole table's slots, exactly, every window
    answering only its own buckets."""
    cfg = tcfg.MapConfig(cell_size=1.0, table_size=1 << 12, cell_capacity=16)
    g = np.random.default_rng(5)
    pts = torch.from_numpy(g.uniform(-6, 6, (3000, 3)).astype(np.float32))
    m = mapstate.insert(mapstate.empty_map(cfg), cfg, pts,
                        torch.ones(3000, dtype=torch.bool), 0.05)
    q = (pts[:500] + torch.from_numpy(
        g.normal(0, 0.3, (500, 3)).astype(np.float32))).contiguous()
    whole = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
    sharded = mapstate.shard_map_table(m, [CPU] * M)
    nbl, B = sharded.shards[0].keys.shape
    merged = torch.full_like(whole, -1)
    for j, sh in enumerate(sharded.shards):
        got = mapstate.octant_lookup(sh.keys, q, cfg.cell_size, j * nbl,
                                     nbl * M)
        hit = got >= 0
        assert torch.all(got[hit] // (nbl * B) == j)
        merged = torch.maximum(merged, got)
    assert torch.equal(merged, whole)
    assert int((whole >= 0).sum()) > 1000
    assert _equal_trees(mapstate.unshard(sharded), m)
    view_pts, view_slots = mapstate.candidate_view(sharded, q, cfg.cell_size)
    assert torch.equal(mapstate.knn_select(view_pts, view_slots, q, 5)[0],
                       mapstate.knn_select(m.pts, whole, q, 5)[0])


def _capped(mod):
    """The tiny ship configuration with an insert width of 64, far below
    its 768 features."""
    cfg = _tiny_ship(mod, early_exit=False)
    return dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, insert_width=64))


CONFIGS = {
    "ship": lambda mod: _tiny_ship(mod, early_exit=False),
    "parity_edges": lambda mod: dataclasses.replace(
        _tiny_path(mod, "parity"), use_edge_features=True),
    "capped": _capped,
}


@pytest.mark.parametrize("kind,M", [("ship", 2), ("ship", 4),
                                    ("parity_edges", 2), ("capped", 2)])
def test_sharded_fleet_matches_the_unsharded_one(kind, M):
    """Two instances, N_STEPS steps, the fleet with its maps split over M
    shards and the same fleet unsplit: every output and the whole maps
    (keys, points, counts) equal to the bit, and the maps non-empty."""
    cfg = _fixed(CONFIGS[kind](tcfg))
    inputs, step_cfg = _inputs(cfg, (3, 4), N_STEPS)
    vstep = parallel.make_batched_step(step_cfg, device="cpu")
    whole = parallel.batched_init_state(step_cfg, 2, device="cpu")
    split = tp.shard_state(whole, [CPU] * M)
    assert isinstance(split.surf_map, mapstate.ShardedMap)
    assert len(split.surf_map.shards) == len(split.edge_map.shards) == M
    for i in range(N_STEPS):
        inp = tp.tree_map(lambda a: a[i], inputs)
        whole, out_w = vstep(whole, *inp)
        split, out_s = vstep(split, *inp)
        assert _equal_trees(out_s, out_w), i
        assert _equal_trees(tp.unshard_state(split), whole), i
        if kind == "capped" and i == 0:
            # the first insert into an empty map wrote the capped prefix
            assert [int(mapstate.total_points(tp.tree_map(
                lambda a: a[b], whole.surf_map))) for b in range(2)] == \
                [64, 64]
    assert int(out_w.surf_map_num.min()) > 0
    if kind == "parity_edges":
        assert int(out_w.edge_map_num.min()) > 0


def test_mesh_step_matches_jax_data2_model2():
    """The JAX package's ``make_batched_step`` on a data=2 x model=2 mesh
    (GSPMD, the map tables split over ``model``), two instances on two
    datasets: each port step (its maps in two shards) from JAX's carried
    state gives the ICP pose within 1e-4 m and the next maps' keys and
    counts exact."""
    n = 3
    cfg_j = _tiny_ship(jcfg, early_exit=False)
    cfg_t = _tiny_ship(tcfg, early_exit=False)
    built = []
    for seed in (3, 4):
        host, _ = JRunner(cfg_j).stack_chunked_inputs(_dataset(seed, n),
                                                      chunk=n)
        built.append(host)
    inputs = jax.tree_util.tree_map(
        lambda *xs: np.stack([x[0] for x in xs], axis=1), *built)
    mesh_j = jpar.make_mesh(jax.devices()[:4], data=2, model=2)
    step_fn, shard_j = jpar.make_batched_step(cfg_j, mesh_j)
    state_j = shard_j(jpar.batched_init_state(cfg_j, 2))
    mesh_t = parallel.make_mesh([CPU], data=1, model=2)
    vstep, shard_t = parallel.make_batched_step(cfg_t, "cpu", mesh_t)
    moved = 0.0
    for i in range(n):
        before = jax.device_get(state_j)
        inp = jax.tree_util.tree_map(lambda a: a[i], inputs)
        state_j, out_j = step_fn(state_j, *inp)
        after_j, out_j = jax.device_get((state_j, out_j))
        state_t = shard_t(convert.from_numpy(before))
        assert isinstance(state_t.surf_map, mapstate.ShardedMap)
        after_t, out_t = vstep(state_t, *(convert.from_numpy(x)
                                          for x in inp))
        after_t = tp.unshard_state(after_t)
        np.testing.assert_allclose(out_t.pose.t.numpy(), out_j.pose.t,
                                   atol=1e-4)
        np.testing.assert_allclose(out_t.pose.q.numpy(), out_j.pose.q,
                                   atol=1e-4)
        for m in ("surf_map", "edge_map"):
            for f in ("keys", "cnt"):
                np.testing.assert_array_equal(
                    getattr(getattr(after_t, m), f).numpy(),
                    getattr(getattr(after_j, m), f))
        moved = max(moved, float(np.abs(out_j.pose.t).max()))
    assert moved > 0.01  # the instances moved


def test_two_gloo_ranks_match_one_process():
    """Four instances over two ``gloo`` ranks on the CPU, each rank with
    its maps in two shards (``replay_mesh``, data=2 x model=2), every
    collective raising inside the ranks' timed windows
    (``parallel.no_collectives``, shown here to raise): the poses and the
    ICP round counts of each instance equal one process's unsplit
    ``replay_batched``, to the bit."""
    with parallel.no_collectives():
        for name in ("all_reduce", "barrier", "all_gather_object"):
            with pytest.raises(RuntimeError, match="timed window"):
                getattr(torch.distributed, name)(None)
    assert torch.distributed.barrier.__name__ == "barrier"
    cfg = _tiny_ship(tcfg, early_exit=False)
    data = [_dataset(seed, 4) for seed in (3, 4, 5, 6)]
    one = parallel.replay_batched(cfg, data, chunk=3, device="cpu")
    mesh = parallel.make_mesh([CPU], data=2, model=2)
    assert mesh.placement() == [{"rank": 0, "shards": ["cpu", "cpu"]},
                                {"rank": 1, "shards": ["cpu", "cpu"]}]
    two = parallel.replay_mesh(cfg, data, mesh, chunk=3)
    np.testing.assert_array_equal(two.poses_t, one.poses_t)
    np.testing.assert_array_equal(two.poses_q, one.poses_q)
    assert [[s["n_iterations"] for s in st] for st in two.stats] == \
        [[s["n_iterations"] for s in st] for st in one.stats]
    assert [r["rank"] for r in two.ranks] == [0, 1]
    assert [r["instances"] for r in two.ranks] == [2, 2]
    assert len(two.chunk_ms) == 2 and two.aggregate_scans_per_sec > 0
    assert two.clock[1] > two.clock[0]
    with pytest.raises(ValueError, match="do not split"):
        parallel.replay_mesh(cfg, data[:3], mesh, chunk=3)


def test_sharded_checkpoint_interchanges(tmp_path):
    """A state whose maps are split in two (the surface map filled by the
    uncapped prior-map insert, as the unsplit state's is): saved whole,
    it loads unsplit in the port and in the JAX package with the unsplit
    state's leaves, and through a mesh split again to the same bits."""
    cfg_t = _tiny_ship(tcfg, early_exit=False)
    cfg_j = _tiny_ship(jcfg, early_exit=False)
    g = np.random.default_rng(9)
    xyz = g.uniform(-7, 7, (5000, 3)).astype(np.float32)
    whole = checkpoint.insert_prior_points(cfg_t, tp.init_state(cfg_t), xyz)
    mesh = parallel.make_mesh([CPU], data=1, model=2)
    split = checkpoint.insert_prior_points(
        cfg_t, tp.init_state(cfg_t, shard_devices=mesh.rank_devices(0)), xyz)
    assert _equal_trees(tp.unshard_state(split), whole)
    assert int(mapstate.total_points(split.surf_map)) == \
        int(mapstate.total_points(whole.surf_map)) > 1000
    for a, b in zip(mapstate.extract_points(split.surf_map),
                    mapstate.extract_points(whole.surf_map)):
        assert torch.equal(a, b)
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, split)
    assert _equal_trees(checkpoint.load_state(path, cfg_t, device="cpu"),
                        whole)
    again = checkpoint.load_state(path, cfg_t, device="cpu", mesh=mesh)
    assert isinstance(again.surf_map, mapstate.ShardedMap)
    assert _equal_trees(again, split)
    flat_j = jax.tree_util.tree_leaves(jckpt.load_state(path, cfg_j))
    flat_t = []
    tp.tree_map(flat_t.append, whole)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
