"""Whole-estimator checkpoint / resume and the prior map of localization
mode (counterpart of ``superodom_tpu.checkpoint``).

The estimator state is one tree of NamedTuples (``pipeline.OdomState``).
A checkpoint is the JAX package's npz: ``leaf_%04d`` for each leaf in
NamedTuple field order, depth first (the order of JAX's ``tree_flatten``
over the same tree), and a ``superodom_state_meta`` entry with the leaf
count.  A checkpoint written by either package loads in the other.

The prior map is a PCD file of the surface map's stored points; loading it
inserts the points into the surface map in batches of 65,536
(laserMapping.cpp:163-177).
"""

from __future__ import annotations

import json
from typing import List

import numpy as np
import torch

from superodom_tpu_torch.config import PipelineConfig
from superodom_tpu_torch.pipeline import OdomState, init_state, tree_map

_META = "superodom_state_meta"
PRIOR_BATCH = 65536  # points inserted a call by insert_prior_points


def _norm_path(path: str) -> str:
    """np.savez appends '.npz' to a path without the suffix: name the same
    file on both sides."""
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(tree) -> List[torch.Tensor]:
    """The leaves in NamedTuple field order, depth first."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def save_state(path: str, state: OdomState) -> None:
    """Write an OdomState to an npz archive."""
    flat = _flatten(state)
    arrays = {f"leaf_{i:04d}": x.detach().cpu().numpy()
              for i, x in enumerate(flat)}
    arrays[_META] = np.frombuffer(
        json.dumps({"n_leaves": len(flat)}).encode(), dtype=np.uint8)
    np.savez(_norm_path(path), **arrays)


def load_state(path: str, cfg: PipelineConfig, device="cuda",
               dtype=torch.float32) -> OdomState:
    """Read an OdomState onto ``device``.  The tree, and each leaf's dtype
    and shape, come from ``init_state(cfg)``: the configuration must be the
    one the state was saved under."""
    template = init_state(cfg, dtype, torch.device(device))
    ref_leaves = _flatten(template)
    leaves = []
    with np.load(_norm_path(path)) as data:
        meta = json.loads(bytes(data[_META]).decode())
        if meta["n_leaves"] != len(ref_leaves):
            raise ValueError(
                f"checkpoint {path!r} has {meta['n_leaves']} leaves but the "
                f"current config expects {len(ref_leaves)} — saved under an "
                "incompatible config or an older state layout")
        for i, ref in enumerate(ref_leaves):
            arr = data[f"leaf_{i:04d}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint {path!r} leaf {i} has shape "
                    f"{tuple(arr.shape)} but the current config expects "
                    f"{tuple(ref.shape)} — saved under an incompatible "
                    "config or an older state layout (e.g. a different map "
                    "table geometry)")
            leaves.append(torch.from_numpy(np.array(arr)).to(
                device=ref.device, dtype=ref.dtype))
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def save_prior_map(path: str, state: OdomState) -> None:
    """Write the surface map's stored points as a PCD prior for
    localization mode."""
    from superodom_tpu_torch.io.pcd import write_pcd
    from superodom_tpu_torch.mapstate import extract_points

    pts, valid = extract_points(state.surf_map)
    write_pcd(path, pts.cpu().numpy()[valid.cpu().numpy()])


def insert_prior_points(cfg: PipelineConfig, state: OdomState,
                        xyz: np.ndarray) -> OdomState:
    """Insert world-frame points into the surface map at the sensor's
    default plane resolution, in batches of PRIOR_BATCH, each uncapped
    (the in-memory half of the prior-map load,
    laserMapping.cpp:163-171)."""
    from superodom_tpu_torch.mapstate import insert

    surf = state.surf_map
    dev = surf.keys.device
    res = cfg.sensor.default_plane_res
    xyz = np.asarray(xyz, np.float32)
    for i in range(0, len(xyz), PRIOR_BATCH):
        chunk = xyz[i:i + PRIOR_BATCH]
        arr = np.pad(chunk, ((0, PRIOR_BATCH - len(chunk)), (0, 0)))
        mask = np.arange(PRIOR_BATCH) < len(chunk)
        surf = insert(surf, cfg.map, torch.from_numpy(arr).to(dev),
                      torch.from_numpy(mask).to(dev), res,
                      max_writes=PRIOR_BATCH)
    return state._replace(surf_map=surf)


def load_prior_map(path: str, cfg: PipelineConfig, state: OdomState,
                   thin_res: float = 0.0) -> OdomState:
    """Load a prior PCD into the surface map (initializationParam,
    laserMapping.cpp:163-171), voxel-thinned on the host first when
    ``thin_res`` > 0."""
    from superodom_tpu_torch import native
    from superodom_tpu_torch.io.pcd import read_pcd

    xyz = read_pcd(path)
    if thin_res > 0:
        xyz = native.voxel_downsample(xyz, thin_res)
    return insert_prior_points(cfg, state, xyz)
