"""The controls on the card: the reference with TF32 products, and with
its points held in bfloat16, each put in the program's place, fail the
comparison that the program passes.  At a size
a test run holds (the tiny cell of ``tiny.py``, on the card); the chip
readings at the cells' own sizes come from ``python3 -m
odombench.control`` (PERF.md)."""

import time

import pytest
import torch

from odombench import harness, registry
from odombench.check import CONTROLS, LIMITS
from odombench.tests.tiny import ROOT, tiny_folder


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 11, 12, 13])
def test_control_fails_where_the_program_passes(tmp_path, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 products exist only there")
    folder = tiny_folder(tmp_path)
    cell = registry.cell(ROOT, "os1_128_ship.fleet_replay", folder=folder)
    r = harness.run_cell(cell, seed, 0.1, False, torch.device("cuda"),
                         time.perf_counter(), control=True)
    assert r["correct"] is True
    for c in CONTROLS:
        assert any(r["control"][c][k] > LIMITS[k] for k in LIMITS), c
