"""Many odometry instances: on one card, and over a mesh (counterpart of
``superodom_tpu.parallel`` and the JAX package's ``bench.bench_batch``).

The fleet is one more axis: every leaf of the state, of the inputs and of
the outputs has a leading instance dimension, and the step is
``torch.func.vmap`` of the whole :func:`pipeline.step`.  Instances are
independent: each has its own map, smoother and data.  Under vmap one
launch of K1-K4 and K9a (an instance dimension) and of K9b (its queries
flattened) serves every instance; K10, K11a and K11b launch once per
instance (``kernel_ops``).  On the CPU the plain versions batch by
themselves.

As in the JAX package, ICP runs a fixed count of rounds (the early exit
would be a host read per round that every instance waits on), and the
map cadence is decided per instance on the device (``pipeline.step``
under vmap).  There is no VIO argument: a ``use_vio_undistortion``
configuration runs as it does without a window.

The mesh (:func:`make_mesh`, the JAX package's ``data`` x ``model``
mesh) spreads the fleet two ways:

* ``data``: one process a rank (``torch.multiprocessing`` spawn, a
  ``gloo`` group), rank r replaying instances ``[r*B/D, (r+1)*B/D)``
  with :func:`replay_batched`.  The group serves a barrier before the
  clock starts and an ``all_gather_object`` of the results after it
  stops, nothing inside the step (:func:`replay_mesh`).  Processes are
  also what gives a fleet more than one host thread of dispatch.
* ``model``: each instance's two maps split into ``model`` shards along
  the bucket axis (``mapstate.ShardedMap``), shard j of rank r on
  ``devices[(r*model + j) % len(devices)]``; K1 looks up each shard's
  window, and the ICP rounds read a candidate table gathered once a scan
  (``mapstate.candidate_view``).

Where there are fewer devices than ``data * model``, ranks and shards
share devices: that is placement, printed as such.  Left to port: the
instance dimension of K10, K11a and K11b (ROADMAP.md, A15b); a mesh over
several cards is exercised only where there are several.

    python -m superodom_tpu_torch.parallel --batch 4 [--scans 40]
        [--data D] [--model M] [--device cuda]

replays ``bench_batch``'s workload — the replay benchmark's world
(``io.datasets.bench_dataset``, seed 7, OS1-128 ship configuration), one
dataset broadcast to every instance — in chunks of :data:`CHUNK` scans
and prints one JSON line with the aggregate scans/s under
``bench_batch``'s name ``aggregate_scans_per_sec_os1_128_x<B>`` (another
``--scans`` another name, :func:`fleet_metric`) and ``vs_baseline``
(against 200 scans/s); with a mesh also ``data``, ``model`` and each
rank's devices and peak memory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing
import queue
import socket
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from superodom_tpu_torch import kernels
from superodom_tpu_torch.config import PipelineConfig
from superodom_tpu_torch.convert import to_numpy
from superodom_tpu_torch.pipeline import (
    OdomState,
    init_state,
    shard_state,
    step,
    tree_map,
    unshard_state,
)
from superodom_tpu_torch.runner import OdometryRunner

CHUNK = 10  # scans a chunk (the JAX package's bench_batch)
BENCH_SCANS = 40  # bench_batch's replay length
BENCH_SEED = 7  # bench_batch's one dataset
BASELINE_SCANS_PER_SEC = 200.0  # bench.py's north-star target
RESULT_WAIT_S = 1.0  # how often replay_mesh looks at its ranks' health


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The JAX package's 2-D mesh of axes ``data`` and ``model`` as a
    placement: rank r's shard j lies on ``devices[(r*model + j) %
    len(devices)]``, and shard 0's device is the rank's home (its
    instances' other state, their inputs and every decision)."""

    devices: Tuple[torch.device, ...]
    data: int
    model: int

    def rank_devices(self, rank: int) -> Tuple[torch.device, ...]:
        n = len(self.devices)
        return tuple(self.devices[(rank * self.model + j) % n]
                     for j in range(self.model))

    def placement(self) -> List[dict]:
        return [{"rank": r, "shards": [str(d) for d in self.rank_devices(r)]}
                for r in range(self.data)]


def make_mesh(devices=None, data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """A ``data`` x ``model`` mesh over ``devices`` (every CUDA device by
    default; ``data`` defaults to as many ranks as the devices hold).
    Fewer devices than ``data * model`` are shared, in turn."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device (pass the devices "
                               "to place a mesh on the CPU)")
    # a card named without its index is the current one: a rank process
    # must be told which
    devices = tuple(torch.device("cuda", torch.cuda.current_device())
                    if torch.device(d) == torch.device("cuda")
                    else torch.device(d) for d in devices)
    if data is None:
        data = max(1, len(devices) // model)
    if data < 1 or model < 1 or model & (model - 1):
        raise ValueError(f"mesh {data} x {model}: need data >= 1 and a "
                         f"power-of-two model")
    return Mesh(devices, data, model)


def batched_init_state(cfg: PipelineConfig, batch: int, dtype=torch.float32,
                       device="cuda") -> OdomState:
    """``batch`` copies of :func:`pipeline.init_state`, each leaf with a
    leading instance dimension."""
    one = init_state(cfg, dtype, torch.device(device))
    return tree_map(lambda x: x[None].expand((batch,) + x.shape).contiguous(),
                    one)


def make_batched_step(cfg: PipelineConfig, device="cuda",
                      mesh: Optional[Mesh] = None, rank: int = 0):
    """``(state, scan, imu, avail) -> (state, output)`` over a fleet: every
    leaf with a leading instance dimension.  ICP early exit is turned off
    (fixed-count rounds, as the JAX package's ``make_batched_step``); on
    the card the kernels are built here.

    With a mesh, returns ``(step_fn, shard_state)`` as the JAX package's
    does: ``shard_state`` puts a fleet's state (rank ``rank``'s instances)
    on the mesh, its maps split over the rank's shard devices and its
    other leaves on ``device``; the step takes either form."""
    cfg = dataclasses.replace(
        cfg, registration=dataclasses.replace(cfg.registration,
                                              icp_early_exit=False))
    devices = [torch.device(device)] + list(
        mesh.rank_devices(rank) if mesh else ())
    if any(d.type == "cuda" for d in devices):
        kernels.load()
    vstep = torch.func.vmap(lambda s, sc, im, av: step(cfg, s, sc, im, av))
    if mesh is None:
        return vstep

    def place(state: OdomState) -> OdomState:
        return shard_state(tree_map(lambda x: x.to(device),
                                    unshard_state(state)),
                           mesh.rank_devices(rank))

    return vstep, place


@dataclasses.dataclass
class BatchedRunResult:
    poses_q: np.ndarray  # [n, B, 4]
    poses_t: np.ndarray  # [n, B, 3]
    stats: List[List[dict]]  # per instance, per scan
    chunk_ms: List[float]  # each timed chunk, ending in a synchronise
    aggregate_scans_per_sec: float  # B x timed scans / the timed window
    # the timed window on the host's monotonic clock (time.perf_counter,
    # one clock for every process of the host)
    clock: Tuple[float, float] = (0.0, 0.0)
    # with a mesh: each rank's devices, instances, timing, peak memory and
    # kernel launches
    ranks: List[dict] = dataclasses.field(default_factory=list)
    # the fleet's state after the last scan (replay_mesh's ranks send
    # their results without it)
    state: Optional[OdomState] = None


def _sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def replay_batched(cfg: PipelineConfig, datasets: Sequence,
                   chunk: int = CHUNK, device="cuda",
                   mesh: Optional[Mesh] = None, rank: int = 0,
                   clock_start: Optional[Callable[[], None]] = None
                   ) -> BatchedRunResult:
    """Replay one dataset per instance (all of one length) through
    :func:`make_batched_step`, as the chunked replay does for one
    (``OdometryRunner.run_dataset_chunked``): each instance's host inputs
    come from its own runner (all IMU ingested first,
    ``stack_chunked_inputs``), stacked on an instance axis and put on the
    device before the clock starts.  One step of scan 0 runs first and is
    discarded; ``clock_start`` (if any) is called next, and the clock runs
    from its return through the chunks to the last synchronise (one after
    each chunk); the outputs are read back after it stops.  The
    ``len % chunk`` remaining scans are stepped after the timed window.
    With a mesh, the state is placed as rank ``rank``'s (its maps split
    over the rank's shard devices, the rest on ``device``)."""
    n_scans = {len(ds.scans) for ds in datasets}
    if len(n_scans) != 1:
        raise ValueError(f"the instances' datasets differ in length: "
                         f"{sorted(n_scans)}")
    # the host inputs of each distinct dataset, built once by a runner of
    # its own (instances that share a dataset share identical inputs)
    host = {}
    for ds in datasets:
        if id(ds) not in host:
            runner = OdometryRunner(cfg, device="cpu")
            host[id(ds)] = runner.stack_chunked_inputs(ds, chunk=chunk)
    built = [host[id(ds)] for ds in datasets]
    n_chunks = built[0][2]
    dev = torch.device(device)
    state = batched_init_state(runner.step_cfg, len(datasets), device=dev)
    # the cards a synchronise waits for: the home and the maps' shards
    cards = {dev}
    if mesh is None:
        vstep = make_batched_step(runner.step_cfg, dev)
    else:
        vstep, place = make_batched_step(runner.step_cfg, dev, mesh, rank)
        state = place(state)
        cards.update(mesh.rank_devices(rank))

    def to_dev(trees, axis):
        # (Scan, ImuWindow, avail): a VIO window is not passed on
        return tree_map(lambda *xs: torch.from_numpy(
            np.stack([np.array(x) for x in xs], axis=axis)).to(dev),
            *(t[:3] for t in trees))

    # [n_chunks, chunk, B, ...] and, per remaining scan, [B, ...]
    stacked = to_dev([b[0] for b in built], 2) if n_chunks else None
    rest = [to_dev([b[1][i] for b in built], 0)
            for i in range(len(built[0][1]))]
    vstep(state, *(tree_map(lambda a: a[0, 0], stacked) if n_chunks
                   else rest[0]))
    _sync(cards)
    if clock_start is not None:
        clock_start()

    outs, chunk_ms = [], []
    t_begin = time.perf_counter()
    for c in range(n_chunks):
        t0 = time.perf_counter()
        for k in range(chunk):
            state, out = vstep(state, *tree_map(lambda a: a[c, k], stacked))
            outs.append(out)
        _sync(cards)
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    t_end = time.perf_counter()
    for inp in rest:
        state, out = vstep(state, *inp)
        outs.append(out)

    outs = to_numpy(tuple(outs))
    n_inst = len(datasets)
    stats = [[OdometryRunner._stats_record(
        tree_map(lambda a: a[b], o), i) for i, o in enumerate(outs)]
        for b in range(n_inst)]
    timed = n_chunks * chunk
    return BatchedRunResult(
        poses_q=np.stack([o.pose.q for o in outs]),
        poses_t=np.stack([o.pose.t for o in outs]),
        stats=stats,
        chunk_ms=chunk_ms,
        aggregate_scans_per_sec=(n_inst * timed / (t_end - t_begin)
                                 if timed else 0.0),
        clock=(t_begin, t_end),
        state=state,
    )


def _rank_replay(cfg, datasets, mesh: Mesh, rank: int, chunk: int,
                 clock_start=None) -> BatchedRunResult:
    """Rank ``rank``'s replay of its instances, with its devices, timing
    and peak device memory (summed over its distinct cards) in
    ``ranks``."""
    devs = mesh.rank_devices(rank)
    cards = sorted({d for d in devs if d.type == "cuda"}, key=str)
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    before = dict(kernels.launch_counts)
    res = replay_batched(cfg, datasets, chunk, devs[0], mesh, rank,
                         clock_start)
    step_ms = np.asarray(res.chunk_ms) / chunk
    res.ranks = [{
        "rank": rank, "instances": len(datasets),
        "shards": [str(d) for d in devs],
        "scans_per_sec": res.aggregate_scans_per_sec,
        "p50_step_ms": float(np.percentile(step_ms, 50)) if len(step_ms)
        else None,
        "peak_mem_mb": sum(torch.cuda.max_memory_allocated(d)
                           for d in cards) / 2 ** 20 if cards else None,
        "launches": {k: v - before[k]
                     for k, v in kernels.launch_counts.items()}}]
    return res


def _merge(parts: Sequence[BatchedRunResult], chunk: int
           ) -> BatchedRunResult:
    """The ranks' results in instance order; the aggregate clock runs from
    the first rank's start to the last rank's last synchronise, and
    ``chunk_ms`` holds every rank's chunks, rank after rank."""
    t0 = min(p.clock[0] for p in parts)
    t1 = max(p.clock[1] for p in parts)
    n_inst = sum(p.poses_t.shape[1] for p in parts)
    timed = len(parts[0].chunk_ms) * chunk
    return BatchedRunResult(
        poses_q=np.concatenate([p.poses_q for p in parts], axis=1),
        poses_t=np.concatenate([p.poses_t for p in parts], axis=1),
        stats=[s for p in parts for s in p.stats],
        chunk_ms=[c for p in parts for c in p.chunk_ms],
        aggregate_scans_per_sec=n_inst * timed / (t1 - t0) if timed else 0.0,
        clock=(t0, t1),
        ranks=[r for p in parts for r in p.ranks])


# torch.distributed's collectives, which no_collectives makes raise
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_object",
               "all_gather_into_tensor", "broadcast", "broadcast_object_list",
               "barrier", "monitored_barrier", "reduce", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
               "gather", "gather_object", "scatter", "scatter_object_list",
               "send", "recv", "isend", "irecv", "batch_isend_irecv")


@contextlib.contextmanager
def no_collectives():
    """Within the block every collective and point-to-point call of
    ``torch.distributed`` raises: the ranks' timed windows run under it,
    so a step that reached the group would fail the run (the counterpart
    of the JAX package's no-collective check of the data-parallel
    step)."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d

    def refuse(*_, **__):
        raise RuntimeError("a torch.distributed call inside a rank's timed "
                           "window: the fleet's step takes no collective")

    saved = [(mod, name, getattr(mod, name))
             for mod in (dist, distributed_c10d) for name in COLLECTIVES
             if hasattr(mod, name)]
    try:
        for mod, name, _ in saved:
            setattr(mod, name, refuse)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _rank_main(rank: int, port: int, threads: int, cfg, datasets, mesh: Mesh,
               chunk: int, results) -> None:
    """One rank's process: join the group, replay, gather; rank 0 sends
    the merged result to the parent.  The group serves a barrier before
    the clock starts and the gather after the replay, nothing between
    (:func:`no_collectives`).  ``threads``: the parent's intra-op thread
    count, so that a rank's CPU arithmetic is the parent's."""
    import torch.distributed as dist

    torch.set_num_threads(threads)
    home = mesh.rank_devices(rank)[0]
    if home.type == "cuda":
        torch.cuda.set_device(home)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=mesh.data, rank=rank)
    try:
        with contextlib.ExitStack() as timed:
            def start():
                dist.barrier()
                timed.enter_context(no_collectives())

            res = _rank_replay(cfg, datasets, mesh, rank, chunk, start)
        parts = [None] * mesh.data
        dist.all_gather_object(parts, dataclasses.replace(res, state=None))
        if rank == 0:
            results.put(_merge(parts, chunk))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def replay_mesh(cfg: PipelineConfig, datasets: Sequence, mesh: Mesh,
                chunk: int = CHUNK) -> BatchedRunResult:
    """Replay a fleet (one dataset per instance) over ``mesh``: rank r,
    one process of ``mesh.data`` (spawned, a ``gloo`` group on the CPU;
    in this process where ``data`` is 1), replays instances
    ``[r*B/D, (r+1)*B/D)`` with :func:`replay_batched`, its maps split
    over its shard devices.  Returns the fleet's result in instance order
    (``ranks``: each rank's placement, timing and peak memory).  A rank
    that fails raises here."""
    n, D = len(datasets), mesh.data
    if n % D:
        raise ValueError(f"{n} instances do not split over {D} ranks")
    per = n // D
    if any(d.type == "cuda" for d in mesh.devices):
        kernels.load()  # built once, before the ranks load it
    if D == 1:
        return _rank_replay(cfg, list(datasets), mesh, 0, chunk)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, name=f"mesh rank {r}", args=(
        r, port, torch.get_num_threads(), cfg,
        list(datasets[r * per:(r + 1) * per]), mesh, chunk, results))
        for r in range(D)]
    for p in procs:
        p.start()
    try:
        merged = None
        while merged is None:
            try:
                merged = results.get(timeout=RESULT_WAIT_S)
            except queue.Empty:
                failed = [f"{p.name} (exit code {p.exitcode})"
                          for p in procs if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError("replay_mesh: " + ", ".join(failed)
                                       + " failed") from None
                if all(p.exitcode == 0 for p in procs):
                    merged = results.get(timeout=RESULT_WAIT_S)
        for p in procs:
            p.join()
            if p.exitcode != 0:
                raise RuntimeError(f"replay_mesh: {p.name} failed (exit "
                                   f"code {p.exitcode})")
        return merged
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()


def fleet_metric(batch: int, scans: int = BENCH_SCANS) -> str:
    """The CLI's metric name.  Its workload is ``bench_batch``'s: one
    seed-7 dataset broadcast to all B instances; at ``bench_batch``'s 40
    scans it carries that function's name,
    ``aggregate_scans_per_sec_os1_128_x<B>``, and another replay length
    adds ``_<n>scans``, so that no name stands for two workloads."""
    name = f"aggregate_scans_per_sec_os1_128_x{batch}"
    return name if scans == BENCH_SCANS else f"{name}_{scans}scans"


def main(argv=None) -> int:
    from superodom_tpu_torch.config import ship_config
    from superodom_tpu_torch.io.datasets import ate_rmse, bench_dataset

    ap = argparse.ArgumentParser(description="Aggregate replay throughput "
                                 "of B odometry instances on one device, or "
                                 "over a data x model mesh.")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--scans", type=int, default=BENCH_SCANS)
    ap.add_argument("--data", type=int, default=1,
                    help="ranks, one process each, splitting the instances")
    ap.add_argument("--model", type=int, default=1,
                    help="shards of each instance's maps")
    ap.add_argument("--device", default="cuda",
                    help="cuda: every card (the mesh's devices); or one "
                         "device")
    args = ap.parse_args(argv)

    cfg = ship_config("os1")
    fleet = [bench_dataset(args.scans, cfg.sensor.max_points,
                           BENCH_SEED)] * args.batch
    dev = torch.device(args.device)
    record = {"metric": fleet_metric(args.batch, args.scans)}
    if args.data == 1 and args.model == 1:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        res = replay_batched(cfg, fleet, CHUNK, dev)
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
    else:
        mesh = make_mesh(None if args.device == "cuda" else [dev],
                         args.data, args.model)
        if len(mesh.devices) < args.data * args.model:
            print(f"placement: {args.data} rank(s) x {args.model} shard(s) "
                  f"share {len(mesh.devices)} device(s): " + "; ".join(
                      f"rank {p['rank']} on {', '.join(p['shards'])}"
                      for p in mesh.placement()), flush=True)
        res = replay_mesh(cfg, fleet, mesh, CHUNK)
        name = ", ".join(sorted({torch.cuda.get_device_name(d)
                                 if d.type == "cuda" else "cpu"
                                 for d in mesh.devices}))
    step_ms = np.asarray(res.chunk_ms) / CHUNK
    ates = [ate_rmse(res.poses_t[:, b], ds.gt_poses_t)
            for b, ds in enumerate(fleet)]
    record.update({
        "value": res.aggregate_scans_per_sec,
        "unit": "scans/s",
        "vs_baseline": res.aggregate_scans_per_sec / BASELINE_SCANS_PER_SEC,
        "device": name,
        "batch": args.batch,
        "scans": args.scans,
        "chunk": CHUNK,
        "p50_step_ms": float(np.percentile(step_ms, 50)),
        "p90_step_ms": float(np.percentile(step_ms, 90)),
        "max_ate_m": max(ates),
    })
    if res.ranks:
        record.update(data=args.data, model=args.model, ranks=res.ranks)
    elif dev.type == "cuda":
        record["peak_mem_mb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
