"""K1 ``octant_lookup`` (``csrc/octant_lookup.cu``): once a step, at the
predicted pose.  Bytes and operations as ``chip_smoke.py`` counts them:
the queries, the touched bucket rows, the slot ids; per query the cell
arithmetic and per octant the hash and a row of key compares.  The touched
rows come from the reference's lookups at the checked steps."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "odombench_kernel_shapes", pathlib.Path(__file__).with_name("_shapes.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)

DEVICE_NAME = "octant_lookup_kernel"


def count(cell, data):
    if "touched" not in data:
        return None
    s = _mod.shapes(cell)
    nq, B = s["nq"], s["bucket"]
    return [(nq * 12 + data["touched"] * B * 4 + nq * 8 * 4,
             nq * (12 + 8 * (15 + B)))]
