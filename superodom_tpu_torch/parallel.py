"""Many odometry instances on one card (counterpart of
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

Not ported here: ``make_mesh`` and the JAX package's paths over several
devices (instances over a ``data`` axis of devices; each instance's map
table sharded over a ``model`` axis).  One card holds the fleet;
ROADMAP.md (A15b) queues them.

    python -m superodom_tpu_torch.parallel --batch 4 [--scans 40]
        [--device cuda]

replays the replay benchmark's world (``io.datasets.bench_dataset``,
OS1-128 ship configuration) in chunks of :data:`CHUNK` scans, the
instances taking the datasets of seeds 7-10 in turn, and prints one JSON
line with ``aggregate_scans_per_sec_os1_128_x<B>``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Sequence

import numpy as np
import torch

from superodom_tpu_torch import kernels
from superodom_tpu_torch.config import PipelineConfig
from superodom_tpu_torch.convert import to_numpy
from superodom_tpu_torch.pipeline import OdomState, init_state, step, tree_map
from superodom_tpu_torch.runner import OdometryRunner

CHUNK = 10  # scans a chunk (the JAX package's bench_batch)


def batched_init_state(cfg: PipelineConfig, batch: int, dtype=torch.float32,
                       device="cuda") -> OdomState:
    """``batch`` copies of :func:`pipeline.init_state`, each leaf with a
    leading instance dimension."""
    one = init_state(cfg, dtype, torch.device(device))
    return tree_map(lambda x: x[None].expand((batch,) + x.shape).contiguous(),
                    one)


def make_batched_step(cfg: PipelineConfig, device="cuda"):
    """``(state, scan, imu, avail) -> (state, output)`` over a fleet: every
    leaf with a leading instance dimension.  ICP early exit is turned off
    (fixed-count rounds, as the JAX package's ``make_batched_step``); on
    the card the kernels are built here."""
    cfg = dataclasses.replace(
        cfg, registration=dataclasses.replace(cfg.registration,
                                              icp_early_exit=False))
    if torch.device(device).type == "cuda":
        kernels.load()
    return torch.func.vmap(lambda s, sc, im, av: step(cfg, s, sc, im, av))


@dataclasses.dataclass
class BatchedRunResult:
    poses_q: np.ndarray  # [n, B, 4]
    poses_t: np.ndarray  # [n, B, 3]
    stats: List[List[dict]]  # per instance, per scan
    chunk_ms: List[float]  # each timed chunk, ending in a synchronise
    aggregate_scans_per_sec: float  # B x timed scans / the timed window


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def replay_batched(cfg: PipelineConfig, datasets: Sequence,
                   chunk: int = CHUNK, device="cuda") -> BatchedRunResult:
    """Replay one dataset per instance (all of one length) through
    :func:`make_batched_step`, as the chunked replay does for one
    (``OdometryRunner.run_dataset_chunked``): each instance's host inputs
    come from its own runner (all IMU ingested first,
    ``stack_chunked_inputs``), stacked on an instance axis and put on the
    device before the clock starts.  One step of scan 0 runs first and is
    discarded; the clock runs from the first chunk to the last
    synchronise (one after each chunk), and the outputs are read back
    after it stops.  The ``len % chunk`` remaining scans are stepped after
    the timed window."""
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
    vstep = make_batched_step(runner.step_cfg, dev)

    def to_dev(trees, axis):
        # (Scan, ImuWindow, avail): a VIO window is not passed on
        return tree_map(lambda *xs: torch.from_numpy(
            np.stack([np.array(x) for x in xs], axis=axis)).to(dev),
            *(t[:3] for t in trees))

    # [n_chunks, chunk, B, ...] and, per remaining scan, [B, ...]
    stacked = to_dev([b[0] for b in built], 2) if n_chunks else None
    rest = [to_dev([b[1][i] for b in built], 0)
            for i in range(len(built[0][1]))]
    state = batched_init_state(runner.step_cfg, len(datasets), device=dev)
    vstep(state, *(tree_map(lambda a: a[0, 0], stacked) if n_chunks
                   else rest[0]))
    _sync(dev)

    outs, chunk_ms = [], []
    t_begin = time.perf_counter()
    for c in range(n_chunks):
        t0 = time.perf_counter()
        for k in range(chunk):
            state, out = vstep(state, *tree_map(lambda a: a[c, k], stacked))
            outs.append(out)
        _sync(dev)
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_begin
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
        aggregate_scans_per_sec=n_inst * timed / wall if timed else 0.0,
    )


def main(argv=None) -> int:
    from superodom_tpu_torch.config import ship_config
    from superodom_tpu_torch.io.datasets import ate_rmse, bench_dataset

    ap = argparse.ArgumentParser(description="Aggregate replay throughput "
                                 "of B odometry instances on one device.")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--scans", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ship_config("os1")
    data = [bench_dataset(args.scans, cfg.sensor.max_points, seed)
            for seed in range(7, 7 + min(args.batch, 4))]
    fleet = [data[i % len(data)] for i in range(args.batch)]
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = replay_batched(cfg, fleet, CHUNK, dev)
    step_ms = np.asarray(res.chunk_ms) / CHUNK
    ates = [ate_rmse(res.poses_t[:, b], ds.gt_poses_t)
            for b, ds in enumerate(fleet)]
    record = {
        "metric": f"aggregate_scans_per_sec_os1_128_x{args.batch}",
        "value": res.aggregate_scans_per_sec,
        "unit": "scans/s",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "batch": args.batch,
        "scans": args.scans,
        "chunk": CHUNK,
        "p50_step_ms": float(np.percentile(step_ms, 50)),
        "p90_step_ms": float(np.percentile(step_ms, 90)),
        "max_ate_m": max(ates),
    }
    if dev.type == "cuda":
        record["peak_mem_mb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
