"""K2 ``knn_select`` (``csrc/knn_select.cu``): once a round.  Bytes and
operations as ``chip_smoke.py`` counts them: slot ids, queries, the live
slot rows, the outputs; 8 operations a candidate distance.  The live rows
and the found slots come from the reference's lookups at the checked
steps."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "odombench_kernel_shapes", pathlib.Path(__file__).with_name("_shapes.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)

DEVICE_NAME = "knn_select_kernel"


def count(cell, data):
    if "live" not in data:
        return None
    s = _mod.shapes(cell)
    if s["refresh"] or s["edges"]:
        return None  # other launches a step than these
    nq, k, C = s["nq"], s["k"], s["C"]
    one = (nq * 8 * 4 + nq * 12 + data["live"] * 3 * C * 4
           + nq * k * (12 + 4 + 1 + 8), data["found"] * C * 8)
    return [one] * s["rounds"]
