"""K10 ``voxel_claim`` (``csrc/voxel_claim.cu``, device names ``vc_*``):
once a step in the voxel thinning mode.  Bytes and operations as
``chip_smoke.py`` counts them: points, mask, the resolution, the keep
mask; ~46 operations a lane."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "odombench_kernel_shapes", pathlib.Path(__file__).with_name("_shapes.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)

DEVICE_NAME = "vc_"


def count(cell, data):
    s = _mod.shapes(cell)
    if s["thin"] != "voxel":
        return None
    n = s["lanes"]
    return [(n * 12 + n + 4 + n, n * 46)]
