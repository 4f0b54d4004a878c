"""One run of one cell: set-up, the measured window, the traced tail, the
check against the reference, and the result's line.

The fleet replay: every instance b replays trajectory ``b % K`` of the
traffic's K trajectories from its own index into a pool of step inputs on
the device, built by the program's own runner
(``OdometryRunner.stack_chunked_inputs``) from the benchmark's sequences.
Each step hands every instance its scan by one gather on the device and
runs the program's vmapped step (``parallel.make_batched_step``); every
``chunk`` steps end in one synchronise and the chunk's poses are read back.
The first ``warm_chunks`` chunks are set-up; the clock starts after them.
Past the lap's end an index wraps into the lap again, its times shifted by
the lap's period.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from odombench import registry, world
from odombench.ate import ate_report
from odombench.trace import TraceSummary, profiler_events, summarise

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""

    cell: registry.Cell
    instances: int
    steps: int  # whole steps in the window
    window_s: float
    setup_s: float
    peak_window_bytes: int
    trace: Optional[TraceSummary] = None
    # per hand kernel (kernels/<name>.py): the least device microseconds a
    # traced step's launches need, and the measured ones
    kernel_bound_us: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    kernel_us: Dict[str, float] = dataclasses.field(default_factory=dict)


class Fleet:
    """A cell's set-up on ``dev``: trajectories, the pool of step inputs,
    the fleet's state and its vmapped step."""

    def __init__(self, cell: registry.Cell, seed: int, dev: torch.device):
        from superodom_tpu_torch.config import PipelineConfig
        from superodom_tpu_torch.parallel import (batched_init_state,
                                                  make_batched_step)
        from superodom_tpu_torch.pipeline import tree_map
        from superodom_tpu_torch.runner import OdometryRunner

        self.cell, self.dev, self.tree_map = cell, dev, tree_map
        # seconds of each part of the set-up, on the host's clock
        self.setup = {}
        t = time.perf_counter()
        p = self.p = cell.traffic
        cfg = registry.pipeline_config(cell.config, PipelineConfig)
        # the sensor's points a sweep, in the program's buffer of max_points
        n_points = int(cell.config.get("points_per_sweep",
                                       cfg.sensor.max_points))
        if n_points > cfg.sensor.max_points:
            raise ValueError(f"{n_points} points a sweep do not fit the "
                             f"buffer of {cfg.sensor.max_points}")
        self.trajectories = world.make_trajectories(p, n_points, seed, dev)
        t = self._lap("trajectories", t)
        n_scans = p["static_scans"] + p["lap_scans"]
        built = []
        for tr in self.trajectories:
            # the runner's host half: IMU buffer, windows, host decimation
            runner = OdometryRunner(cfg, device="cpu")
            stacked, _, _ = runner.stack_chunked_inputs(tr, chunk=n_scans)
            built.append(stacked)
        self.step_cfg = runner.step_cfg
        t = self._lap("runner_inputs", t)
        # [K, S, ...] on the device
        self.pool = tree_map(lambda *xs: torch.from_numpy(
            np.concatenate([np.asarray(x) for x in xs], 0)).to(dev), *built)
        del built
        self.B = cell.instances
        self.traj = torch.arange(self.B, device=dev) % p["trajectories"]
        self.state = batched_init_state(self.step_cfg, self.B, device=dev)
        _sync(dev)
        t = self._lap("pool_and_state", t)
        self.vstep = make_batched_step(self.step_cfg, dev)
        self._lap("kernels", t)

    def _lap(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.setup[name] = t - t0
        return t

    def inputs(self, s: int):
        """Every instance's (Scan, ImuWindow, avail) of global step ``s``:
        one gather on the device (and the wrapped laps' time shift)."""
        idx, wraps = world.step_index(self.p, s)
        scan, imu, avail = self.tree_map(
            lambda a: a[:, idx].index_select(0, self.traj), self.pool)
        if wraps:
            shift = wraps * world.lap_time(self.p)
            scan = scan._replace(t_start=scan.t_start + shift)
            imu = imu._replace(t=torch.where(imu.mask, imu.t + shift, imu.t))
        return scan, imu, avail

    def step(self, s: int):
        self.state, out = self.vstep(self.state, *self.inputs(s))
        return out

    def instance(self, tree, b: int):
        return self.tree_map(lambda x: x[b].clone(), tree)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_plan(cell: registry.Cell, seed: int) -> Dict[int, List[int]]:
    """Steps to check -> instances, drawn from the seed: step 0 (the start,
    from the reference's own initial state) and ``checks - 1`` steps of
    the window's first ``check_steps``; instance i of the plan from the
    i-th of ``checks`` equal parts of the fleet, so that a fault in any
    half of the fleet meets a check."""
    p = cell.traffic
    n = int(p.get("checks", 4))
    w0 = int(p["chunk"]) * int(p.get("warm_chunks", 1))
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    parts = np.array_split(np.arange(cell.instances), n)
    steps = [0] + sorted(rng.choice(np.arange(w0, w0 + p["check_steps"]),
                                    n - 1, replace=False).tolist())
    plan: Dict[int, List[int]] = {}
    for part, s in zip(parts, steps):
        plan.setdefault(int(s), []).append(int(rng.choice(part)))
    return plan


def rollout_plan(cell: registry.Cell, seed: int):
    """(instance, steps) of the rollout: one instance drawn from the seed,
    stepped by the reference on its own state through the first
    ``rollout_steps`` steps, the rest, the warm-up and the window's
    first."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 1])
    return (int(rng.integers(cell.instances)),
            int(cell.traffic["rollout_steps"]))


def _device_info(dev, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def _kernel_bounds(cell, summary: TraceSummary, data: dict):
    """Each hand kernel's least device microseconds over the traced steps
    (its count file's launches a step, scaled by the fleet) and its
    measured microseconds, by kernel name."""
    bound, measured = {}, {}
    for name, mod in registry.kernel_counts(cell.folder).items():
        us = sum(v for k, v in summary.device_us.items()
                 if k.startswith(mod.DEVICE_NAME))
        if not us:
            continue
        launches = mod.count(cell, data)
        if launches is None:
            continue
        B = cell.instances
        t = sum(max(b * B / HBM_BYTES_PER_S, o * B / F32_OPS_PER_S)
                for b, o in launches) * 1e6
        bound[name] = t * summary.steps
        measured[name] = us
    return bound, measured


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool,
             dev: torch.device, t_process: float, check: bool = True,
             fault=None, control: bool = False) -> dict:
    """One run; returns the result's line as a dict.  ``t_process``: the
    host clock when the process started (set-up counts from there).
    ``fault``: takes the fleet's step and returns a broken one, planted in
    the timed path by the harness's tests.  The window runs whole chunks
    until ``seconds`` have passed and every checked step has run."""
    from odombench import check as checker

    fleet = Fleet(cell, seed, dev)
    if fault is not None:
        fleet.vstep = fault(fleet.vstep)
    p = cell.traffic
    chunk = int(p["chunk"])
    warm_steps = chunk * int(p.get("warm_chunks", 1))
    plan = check_plan(cell, seed) if check else {}
    roll_b, roll_steps = rollout_plan(cell, seed) if check else (0, 0)
    captures = []
    last_check = max(max(plan, default=-1), roll_steps - 1)

    def run_chunk(s: int):
        """Steps s .. s + chunk - 1, the checked ones captured, then one
        synchronise and the chunk's poses read back."""
        chunk_out = []
        for k in range(s, s + chunk):
            pre = {b: fleet.instance(fleet.state, b) if k else None
                   for b in plan.get(k, [])}
            out = fleet.step(k)
            for b, st in pre.items():
                captures.append(checker.Capture(
                    step=k, instance=b, pre=st,
                    post=fleet.instance(fleet.state, b),
                    out=fleet.instance(out, b)))
            chunk_out.append(torch.cat([out.pose.q, out.pose.t], -1))
        _sync(dev)
        return torch.stack(chunk_out).cpu()

    # warm-up: the first chunks (the rest at the trajectories' start, the
    # map seeded) run before the clock, as set-up: they build the kernels'
    # and the allocator's every shape, and the window starts in motion
    t_warm = time.perf_counter()
    poses = [run_chunk(s) for s in range(0, warm_steps, chunk)]
    fleet.setup["warm_up"] = time.perf_counter() - t_warm
    setup_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # set-up's objects leave the collector's generations, so that a full
    # collection in the window does not walk them
    gc.collect()
    gc.freeze()
    t_begin = time.perf_counter()
    cpu_begin = time.process_time()
    setup_s = t_begin - t_process
    s, chunk_s = warm_steps, []
    while True:
        t0 = time.perf_counter()
        poses.append(run_chunk(s))
        s += chunk
        chunk_s.append(time.perf_counter() - t0)
        if time.perf_counter() - t_begin >= seconds and s > last_check:
            break
    window_s = time.perf_counter() - t_begin
    window_cpu_s = time.process_time() - cpu_begin
    gc.unfreeze()
    peak_window = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0

    summary = None
    if trace:
        n_tr = int(p.get("trace_steps", 3))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            _sync(dev)
            with torch.profiler.record_function("window"):
                for k in range(n_tr):
                    fleet.step(s + k)
                _sync(dev)
        events = list(profiler_events(prof))
        win = [(a, b) for name, dev_, a, b in events
               if name == "window" and not dev_]
        events = [e for e in events if e[0] != "window"]
        summary = summarise(events, n_tr, win[0])
        del prof, events
    peak = max(setup_peak, peak_window,
               torch.cuda.max_memory_allocated(dev)
               if dev.type == "cuda" else 0)

    poses = torch.cat(poses, 0)  # [steps, B, 7], the warm-up's first
    window = poses[warm_steps:]
    attempted = int(window.shape[0] * window.shape[1])
    failed = int((~torch.isfinite(window).all(-1)).sum())
    trajectories, setup_parts = fleet.trajectories, fleet.setup
    # each trajectory's first instance against its ground truth
    idx = [world.step_index(p, k)[0] for k in range(poses.shape[0])]
    ate = max((ate_report(poses[:, b, 4:].numpy(),
                          trajectories[b].gt_t[idx])["rmse_m"]
               for b in range(min(len(trajectories), cell.instances))),
              default=0.0)
    # free the program's state before the reference runs
    del fleet
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    verdict = checker.judge(cell, trajectories, captures, dev,
                            rollout=(roll_b, poses[:roll_steps, roll_b]),
                            control=control) if check \
        else checker.Verdict(correct=False, numbers={}, data={})

    record = RunRecord(cell=cell, instances=cell.instances,
                       steps=int(window.shape[0]), window_s=window_s,
                       setup_s=setup_s,
                       peak_window_bytes=int(peak_window), trace=summary)
    if summary is not None:
        record.kernel_bound_us, record.kernel_us = _kernel_bounds(
            cell, summary, verdict.data)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = registry.reader(cell.folder, m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = _device_info(dev, peak)
    # a pose that is not finite is a failed answer, checked or not
    result = {"correct": bool(verdict.correct) and not failed,
              "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if summary is not None:
        device["busy_s"] = summary.busy_us / 1e6
        device["window_s"] = summary.window_us / 1e6
        result["breakdown"] = {"device_ops": summary.device_top(10),
                               "idle_gaps": summary.idle_gaps[:10]}
    result["window"] = {"instances": cell.instances, "steps": record.steps,
                        "seconds": window_s, "setup_s": setup_s,
                        "setup_parts": setup_parts, "ate_rmse_m": ate,
                        "chunk_s": chunk_s, "cpu_s": window_cpu_s,
                        "check_s": time.perf_counter() - t_check}
    if control:
        result["control"] = verdict.control
    result["compared"] = verdict.numbers
    return result
