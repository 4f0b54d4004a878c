"""Whether the timed path's steps are correct: each checked step of the
window against the plain reference (``odombench.reference``).

The reference follows the program step by step: a checked step at index
s > 0 starts from the program's own state before it (the instance's slice
of the fleet's state), and the reference works that step out again from
the raw sequence (its own IMU buffer and host layout) and that state.  The
check at step 0 starts from the reference's own initial state: it checks
the start.  Each number compared is the worst over the checked steps:

* ``pose_gap_m``: the pose the step answers, in metres: the larger of its
  translation gap and its rotation gap times ``REACH_M`` (the world's half
  extent: a rotation moves a point that far away by this much) (frontend,
  prediction, registration, motion gates);
* ``map_point_gap_m``: the distance between a map point of the two sides
  where both hold one in a slot of the same key (the points the step
  stores);
* ``smoother_gap``: the smoother's state, each leaf's largest difference
  over the reference leaf's largest magnitude (at least 1e-6);
* ``map_entries_differ``: map entries (slot key, count, or a lane's
  validity) that differ (which cells the map holds, and how many points:
  the thinning, the compaction and the insert);
* ``rollout_gap_m``: one instance a run, drawn from the seed, that the
  reference steps on its own state from step 0 through the traffic's
  ``rollout_steps`` (into the window): the largest pose gap (as in
  ``pose_gap_m``) between the program's read-back poses and the
  reference's over those steps, so that drift which builds up is seen.

Two controls are put in the program's place (PERF.md): the reference with
TF32 products (the step below the configurations' float32 with TF32 off),
and the reference with the scan's and the map's points held in bfloat16
on entry to registration and the map update (the storage a later change
would be tempted to use).  At the cells' sizes each reads above every
limit (the readings are in PERF.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from odombench import registry
from odombench.world import lap_time, step_index

# limit of each number, set from the readings in PERF.md section 2: above
# the program's worst over its seeds, below the control's least
LIMITS = {
    "pose_gap_m": 1e-4,
    "map_point_gap_m": 1e-3,
    "smoother_gap": 1e-2,
    "map_entries_differ": 64,
    "rollout_gap_m": 4e-3,
}
CONTROLS = ("tf32", "bf16")
REACH_M = 40.0


@dataclasses.dataclass
class Capture:
    step: int
    instance: int
    pre: Optional[object]  # the program's state before the step (None: s 0)
    post: object  # the program's state after it
    out: object  # its StepOutput


@dataclasses.dataclass
class Verdict:
    correct: bool
    numbers: Dict[str, list]  # name -> [value, limit]
    data: dict  # what the reference saw, for the kernel counts
    # with ``control``: each control's numbers (the reference in a lower
    # precision, put in the program's place), by control
    control: Optional[Dict[str, Dict[str, float]]] = None


def _leaves(tree):
    if isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def _rebuild(template, leaves):
    if isinstance(template, tuple):
        parts = [_rebuild(t, leaves) for t in template]
        return type(template)(*parts) if hasattr(template, "_fields") \
            else tuple(parts)
    return next(leaves)


def _as_reference(template, program_tree, dev):
    """The program's tree as the reference's (same leaves in the same
    order: the reference is a copy of the program's plain step)."""
    leaves = [x.to(dev) for x in _leaves(program_tree)]
    want = list(_leaves(template))
    if len(leaves) != len(want) or any(
            a.shape != b.shape for a, b in zip(leaves, want)):
        raise ValueError("the program's state does not have the reference's "
                         "layout")
    return _rebuild(template, iter(leaves))


def _rot_gap(q1, q2):
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 + (v1 * v2).sum(-1, keepdim=True)
    v = w1 * v2 - w2 * v1 - torch.cross(v1, v2, dim=-1)
    return float(2.0 * torch.atan2(torch.linalg.norm(v), w.abs().squeeze()))


def _pose_gap(t1, q1, t2, q2) -> float:
    """Translation gap and rotation gap times ``REACH_M``, the larger."""
    gaps = (float(torch.linalg.norm(t1 - t2)), REACH_M * _rot_gap(q1, q2))
    return max(gaps) if all(map(math.isfinite, gaps)) else math.inf


class VoxelMaps(NamedTuple):
    """The fields of a surface map that the comparison reads."""

    keys: torch.Tensor  # i32[NB, B]
    pts: torch.Tensor  # f32[NB*B, 3*C]
    cnt: torch.Tensor  # i32[NB, B]


def map_numbers(prog, ref):
    """(largest point distance where both hold a point in a slot of the
    same key, entries that differ) of two surface maps (keys, pts, cnt)."""
    same = prog.keys == ref.keys
    keys_d = int((~same).sum())
    cnt_d = int((prog.cnt != ref.cnt).sum())
    C = ref.pts.shape[1] // 3
    pa = prog.pts.reshape(-1, 3, C)
    pb = ref.pts.reshape(-1, 3, C)
    va = pa[:, 0] < 1e29
    vb = pb[:, 0] < 1e29
    both = va & vb & same.reshape(-1, 1)
    gap = torch.linalg.norm(pa - pb, dim=1)
    gap = float(gap[both].max()) if bool(both.any()) else 0.0
    return gap, keys_d + cnt_d + int((va != vb).sum())


def _smoother_gap(prog, ref):
    worst = 0.0
    for a, b in zip(_leaves(prog), _leaves(ref)):
        if not torch.is_floating_point(b):
            if not torch.equal(a, b):
                worst = max(worst, math.inf)
            continue
        scale = max(float(b.abs().max()) if b.numel() else 0.0, 1e-6)
        d = float((a - b).abs().max()) if b.numel() else 0.0
        worst = max(worst, d / scale if math.isfinite(d) else math.inf)
    return worst


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _bf16_map(m):
    return m._replace(pts=_bf16(m.pts))


@contextlib.contextmanager
def _bf16_points():
    """The reference's registration and map update with the scan's and the
    map's points rounded to bfloat16 on entry (computing in float32)."""
    from odombench.reference import pipeline as rp

    icp, insert = rp.icp_register, rp.insert

    def icp_bf16(edge_map, surf_map, map_cfg, reg, pose0, edge_pts,
                 edge_mask, surf_pts, surf_mask, *args, **kw):
        return icp(_bf16_map(edge_map), _bf16_map(surf_map), map_cfg, reg,
                   pose0, _bf16(edge_pts), edge_mask, _bf16(surf_pts),
                   surf_mask, *args, **kw)

    def insert_bf16(m, cfg, pts, *args, **kw):
        return insert(_bf16_map(m), cfg, _bf16(pts), *args, **kw)

    rp.icp_register, rp.insert = icp_bf16, insert_bf16
    try:
        yield
    finally:
        rp.icp_register, rp.insert = icp, insert


@contextlib.contextmanager
def precision(control: Optional[str] = None):
    """The reference's arithmetic: float32 with TF32 off, or one control's
    (``"tf32"``: TF32 products; ``"bf16"``: points held in bfloat16)."""
    tf32 = control == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with (_bf16_points() if control == "bf16"
              else contextlib.nullcontext()):
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Reference:
    """The reference's configuration, IMU buffers and step on ``dev``."""

    def __init__(self, cell: registry.Cell, trajectories, dev):
        import dataclasses as dc

        from odombench.reference import config as rconfig
        from odombench.reference import inputs, pipeline

        self.pipeline, self.inputs = pipeline, inputs
        cfg = registry.pipeline_config(cell.config, rconfig.PipelineConfig)
        # the fleet's step runs fixed-count ICP (parallel.make_batched_step)
        self.cfg = dc.replace(cfg, registration=dc.replace(
            cfg.registration, icp_early_exit=False))
        self.p, self.trajectories, self.dev = cell.traffic, trajectories, dev
        self.buffers = {}

    def step_inputs(self, instance: int, s: int):
        k = instance % self.p["trajectories"]
        tr = self.trajectories[k]
        if k not in self.buffers:
            self.buffers[k] = self.inputs.ingest(
                tr.imu, self.cfg.imu.imu_rate, self.cfg.imu.init_window_sec)
        idx, wraps = step_index(self.p, s)
        scan, imu, avail = self.inputs.step_inputs(
            self.cfg, self.buffers[k], tr.scans[idx])
        to = self.pipeline.tree_map
        scan, imu = to(lambda a: torch.from_numpy(np.array(a)).to(self.dev),
                       (scan, imu))
        avail = torch.from_numpy(np.array(avail)).to(self.dev)
        if wraps:
            shift = wraps * lap_time(self.p)
            scan = scan._replace(t_start=scan.t_start + shift)
            imu = imu._replace(t=torch.where(imu.mask, imu.t + shift, imu.t))
        return scan, imu, avail

    def initial(self):
        return self.pipeline.init_state(self.cfg, torch.float32, self.dev)

    def run(self, cap: Capture, control: Optional[str] = None):
        """The reference's (state, output) of the captured step."""
        template = self.initial()
        state = template if cap.pre is None else _as_reference(
            template, cap.pre, self.dev)
        with precision(control), torch.no_grad():
            return self.pipeline.step(self.cfg, state,
                                      *self.step_inputs(cap.instance,
                                                        cap.step))

    def rollout(self, instance: int, steps: int,
                control: Optional[str] = None):
        """Poses [steps, 7] (q, t) of ``instance`` stepped on the
        reference's own state from its initial state."""
        state, poses = self.initial(), []
        with precision(control), torch.no_grad():
            for s in range(steps):
                state, out = self.pipeline.step(
                    self.cfg, state, *self.step_inputs(instance, s))
                poses.append(torch.cat([out.pose.q, out.pose.t], -1))
        return torch.stack(poses)


def compare(cap: Capture, ref_state, ref_out) -> Dict[str, float]:
    """The numbers of one checked step (program against reference)."""
    dev = ref_out.pose.t.device
    post = _as_reference(ref_state, cap.post, dev)
    out_t = cap.out.pose.t.to(dev)
    out_q = cap.out.pose.q.to(dev)
    gap, differ = map_numbers(post.surf_map, ref_state.surf_map)
    gap = gap if math.isfinite(gap) else math.inf
    return {
        "pose_gap_m": _pose_gap(out_t, out_q, ref_out.pose.t, ref_out.pose.q),
        "map_point_gap_m": gap,
        "smoother_gap": _smoother_gap(post.smoother, ref_state.smoother),
        "map_entries_differ": float(differ),
    }


def rollout_gap(poses: torch.Tensor, ref_poses: torch.Tensor) -> float:
    """The largest pose gap over the steps of two [steps, 7] (q, t)."""
    poses = poses.to(ref_poses.device, ref_poses.dtype)
    return max(_pose_gap(a[4:], a[:4], b[4:], b[:4])
               for a, b in zip(poses, ref_poses))


def _nan_safe_max(a: float, b: float) -> float:
    if math.isnan(a) or math.isnan(b):
        return math.inf
    return max(a, b)


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst over the readings that hold it."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = _nan_safe_max(out.get(k, 0.0), v)
    return out


def judge(cell: registry.Cell, trajectories, captures: List[Capture],
          dev, rollout=None, limits: Optional[dict] = None,
          control: bool = False) -> Verdict:
    """Every capture, and the rollout ``(instance, poses [steps, 7])``,
    against the reference; the worst of each number beside its limit,
    printed last on standard error.  With ``control`` each control's
    readings too: the reference in a lower precision, in the program's
    place, against the reference."""
    from odombench.reference import mapstate as rmap

    limits = dict(LIMITS if limits is None else limits)
    ref = Reference(cell, trajectories, dev)
    seen = []

    def observe(keys, queries, cell_size, slots):
        nb = keys.shape[0]
        cells = rmap.octant_cells(queries, cell_size).reshape(-1)
        found = slots[slots >= 0]
        seen.append({"queries": int(queries.shape[0]),
                     "touched": int(torch.unique(
                         rmap._bucket_of(cells, nb)).numel()),
                     "live": int(torch.unique(found).numel()),
                     "found": int(found.numel())})

    rmap.OBSERVERS.append(observe)
    try:
        readings = []
        controls = {c: [] for c in (CONTROLS if control else ())}
        for cap in captures:
            rs, ro = ref.run(cap)
            readings.append(compare(cap, rs, ro))
            for c, got in controls.items():
                cs, co = ref.run(cap, control=c)
                got.append(compare(
                    Capture(cap.step, cap.instance, None, cs, co), rs, ro))
                del cs, co
            del rs, ro
    finally:
        rmap.OBSERVERS.remove(observe)
    if rollout is not None:
        b, poses = rollout
        ref_poses = ref.rollout(b, poses.shape[0])
        readings.append({"rollout_gap_m": rollout_gap(poses, ref_poses)})
        for c, got in controls.items():
            got.append({"rollout_gap_m": rollout_gap(
                ref.rollout(b, poses.shape[0], control=c), ref_poses)})
    numbers = worst(readings)
    correct = all(k in numbers and numbers[k] <= limits[k] for k in limits)
    shown = {k: [numbers[k], limits[k]] for k in limits if k in numbers}
    print(f"checked {len(captures)} steps "
          f"(instance, step): {[(c.instance, c.step) for c in captures]}; "
          f"rollout (instance, steps): "
          f"{rollout and (rollout[0], rollout[1].shape[0])}",
          file=sys.stderr)
    for k, (v, lim) in shown.items():
        print(f"{k} {v!r} limit {lim!r}", file=sys.stderr)
    data = {}
    if seen:
        data = {k: float(np.mean([s[k] for s in seen])) for k in seen[0]}
    return Verdict(correct=correct, numbers=shown, data=data,
                   control={c: worst(got) for c, got in controls.items()}
                   if control else None)
