"""Carry state across the two packages.

The JAX package's state trees are NamedTuples whose leaves ``jax.device_get``
turns into numpy arrays; this package's trees are NamedTuples of the same
names and field names with tensor leaves.  :func:`from_numpy` maps the
first onto the second (by class name and field name, so nothing from the
JAX package is imported) and :func:`to_numpy` maps back, leaf by leaf.
Both sides can then compute from the same map, smoother and IMU window.
"""

from __future__ import annotations

import numpy as np
import torch

from superodom_tpu_torch.config import RuntimeParams
from superodom_tpu_torch.frontend import ImuWindow, Scan
from superodom_tpu_torch.geometry import Pose
from superodom_tpu_torch.inertial import Preintegrated, SmootherState
from superodom_tpu_torch.mapstate import ReducedCandidates, VoxelHashMap
from superodom_tpu_torch.pipeline import (
    HighRateOut,
    OdomState,
    StepOutput,
    tree_map,
)
from superodom_tpu_torch.registration import (
    EdgeCorrs,
    IcpStats,
    PlaneCorrs,
    PosePrior,
    RegistrationError,
)

_TYPES = {cls.__name__: cls for cls in (
    OdomState, StepOutput, Pose, RuntimeParams, VoxelHashMap, SmootherState,
    Preintegrated, ImuWindow, Scan, IcpStats, RegistrationError, PlaneCorrs,
    PosePrior, ReducedCandidates, EdgeCorrs, HighRateOut)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def from_numpy(tree, device=None):
    """A NamedTuple tree with array-like leaves (numpy arrays, numpy or
    Python scalars, JAX arrays) -> the same-named tree of this package with
    tensor leaves on ``device``."""
    if _is_namedtuple(tree):
        cls = _TYPES[type(tree).__name__]
        return cls(*(from_numpy(getattr(tree, f), device)
                     for f in cls._fields))
    return torch.from_numpy(np.array(tree)).to(device)


def to_numpy(tree):
    """A tree of this package (NamedTuples and plain tuples of tensors) ->
    the same tree with numpy leaves."""
    return tree_map(lambda a: a.detach().cpu().numpy()
                    if isinstance(a, torch.Tensor) else np.asarray(a), tree)


def _typed(name):
    def convert(tree, device=None):
        if type(tree).__name__ != name:
            raise TypeError(f"expected a {name}, got {type(tree).__name__}")
        return from_numpy(tree, device)

    convert.__name__ = convert.__qualname__ = name
    convert.__doc__ = f"The JAX package's {name} (numpy leaves) -> ours."
    return convert


odom_state_from_numpy = _typed("OdomState")
voxel_map_from_numpy = _typed("VoxelHashMap")
smoother_state_from_numpy = _typed("SmootherState")
scan_from_numpy = _typed("Scan")
imu_window_from_numpy = _typed("ImuWindow")
odom_state_to_numpy = to_numpy
