"""The control -- the nearest lower precision in the program's place --
fails the cell's limits, at a size a test run holds (the readings the
limits were set from are the card's, at the cells' own sizes:
``lbm_bench.calibrate``, PERF.md). The f32 cells' control is the
program's own bfloat16 path; the bf16 cell's, the reference storing
float8 (e4m3)."""

import time

import pytest

from lbm_bench import calibrate
from lbm_bench.bench import Cell, run_cell
from lbm_bench.tests.support import SMALL, CpuSystem

SEED = 2**31 + 31


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(cell, monkeypatch):
    c = Cell(cell, overrides=SMALL[cell])
    control = c.traffic["control"]
    if "reference_storage" in control:
        monkeypatch.setattr(calibrate, "DEVICE", "cpu")
        numbers = calibrate.reference_control(c, SEED, control["reference_storage"])
        assert any(numbers[k] > float(v) for k, v in c.limits.items())
    else:
        overrides = dict(SMALL[cell], policy=control["policy"])
        result, lines = run_cell(cell, SEED, 0, 0, CpuSystem(), time.perf_counter(), overrides=overrides)
        assert not result["correct"], lines
