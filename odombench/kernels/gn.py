"""K4 (``csrc/normal_system.cu``, device name ``gn_kernel``): the damped
Gauss-Newton solve once a round, and the final normal system once a step
(its n_iters = 0 mode).  Bytes and operations as ``chip_smoke.py`` counts
them: rows once plus the vote column, pose and prior, the pose; per
iteration ~124 operations a row and ~600 for the 6x6 solve; the normal
system's rows, H, g and cost, ~124 operations a row."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "odombench_kernel_shapes", pathlib.Path(__file__).with_name("_shapes.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)

DEVICE_NAME = "gn_kernel"


def count(cell, data):
    s = _mod.shapes(cell)
    if s["edges"]:
        return None
    nq, n_it = s["nq"], s["gn_iters"]
    solve = (nq * 37 + 32 + 53 + 29, n_it * (nq * 124 + 600))
    final = (nq * 33 + 32 + 43 * 4, nq * 124)
    return [solve] * s["rounds"] + [final]
