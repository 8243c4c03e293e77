"""A whole run on the CPU stand-in (no look for a card), at a small size:
sound, it comes out correct; with the timed path broken underneath --
the state left unchanged, half the domain left out, one answer altered
where the window produces it, and in training omega's gradient of the
wrong sign -- it comes out not correct."""

import time

import pytest

from lbm_bench import faults
from lbm_bench.bench import run_cell
from lbm_bench.tests.support import SMALL, CpuSystem

SEED = 2**31 + 29


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    result, lines = run_cell(cell, SEED, 0, 0, CpuSystem(), time.perf_counter(), overrides=SMALL[cell])
    assert result["correct"], lines
    assert list(result)[-1] == "checks" and result["checks"]


FAULTS = [(cell, fault) for cell in sorted(SMALL) for fault in ("unchanged", "half_domain", "altered")]
FAULTS += [("sphere_open.train.f32", "omega_sign")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_run_is_not_correct(cell, fault):
    system = faults.Planted(CpuSystem(), getattr(faults, fault))
    result, lines = run_cell(cell, SEED, 0, 0, system, time.perf_counter(), overrides=SMALL[cell])
    assert not result["correct"], lines
    assert result["failed"] == 1
    if fault == "omega_sign":  # the signed gaps see the sign: about 2
        assert result["checks"]["grad_gap"]["value"] > 1.5 and result["checks"]["change_gap"]["value"] > 1.5


def test_traced_run_reports_per_layer_metrics():
    cell = "sphere_open.window.f32"
    result, _ = run_cell(cell, SEED, 0, 1, CpuSystem(), time.perf_counter(), overrides=SMALL[cell])
    # no card: the trace has no device operation, so the device metrics read nothing and are left out
    assert set(result["metrics"]) == {"setup.scene_s", "setup.first_window_s", "fwd.host_enqueue_ms"}
    assert "breakdown" in result and result["device"]["window_s"] > 0


def test_a_split_metric_reports_its_quantity():
    # mlups.bf16 is the mix's mlups in the cells it lists
    cell = "cavity512.window.bf16"
    result, _ = run_cell(cell, SEED, 0, 0, CpuSystem(), time.perf_counter(), overrides=SMALL[cell])
    assert set(result["metrics"]) == {"mlups.bf16", "setup_s"} and result["metrics"]["mlups.bf16"]["value"] > 0
