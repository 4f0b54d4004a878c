"""K3 ``plane_fit`` (``csrc/plane_fit.cu``): once a round.  Bytes and
operations as ``chip_smoke.py`` counts them: neighbourhoods, mask, points,
pose, six outputs; ~450 operations a correspondence."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "odombench_kernel_shapes", pathlib.Path(__file__).with_name("_shapes.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)

DEVICE_NAME = "plane_fit_kernel"


def count(cell, data):
    s = _mod.shapes(cell)
    if s["refresh"] or s["edges"]:
        return None
    nq, k = s["nq"], s["k"]
    return [(nq * k * 17 + nq * 13 + 20 + nq * 37, nq * 450)] * s["rounds"]
