"""The sphere-drag tunnel (``configs/tunnel_d48_576x288x288``) at D = 4
and 6 on the CPU: its masks, shell and link distances against the port's
and a brute-force crossing, its plain reference (``reference/tunnel.py``)
against the port's TORCH tier, a whole run of its cell on the CPU
stand-in -- sound, under the control, and with each planted fault -- and
the port's span and counter of the aux field it adds."""

import importlib
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lbm_bench import faults, inputs
from lbm_bench.bench import ROOT, SPEC, Cell, read_json, run_cell
from lbm_bench.reference import tunnel
from lbm_bench.reference.lbm import C
from lbm_bench.tests.support import CpuSystem

NAME = "tunnel_d48_576x288x288"
CELL = "tunnel_d48.window.f32"
SEED = 2**31 + 37


def small(d):
    """The configuration's keys at diameter ``d``: the script's proportions."""
    return {"shape": [12 * d, 6 * d, 6 * d], "d": d, "sphere": {"center": [7 * d // 2, 3 * d, 3 * d], "radius": d / 2}}


SMALL = dict(small(4), steps=20)


def config(d):
    mod = importlib.import_module(f"lbm_bench.configs.{NAME}")
    return mod, dict(read_json(ROOT / "configs" / f"{NAME}.json"), **small(d))


def scene(d):
    mod, cfg = config(d)
    bnd = mod.boundaries(cfg)
    stepper, bc_mask, missing = mod.program_scene(cfg, bnd, "FP32FP32", "cpu", "TORCH")
    return mod, cfg, bnd, stepper, bc_mask, missing


def test_the_configuration_follows_the_script():
    mod, cfg = config(48)
    raw = read_json(ROOT / "configs" / f"{NAME}.json")
    d = raw["d"]
    assert raw["shape"] == [12 * d, 6 * d, 6 * d] == [576, 288, 288]
    assert raw["sphere"] == {"center": [3.5 * d, 3 * d, 3 * d], "radius": d / 2}
    # sphere_drag_validation.py's omega
    assert mod.omega(raw) == 1.0 / (3.0 * (raw["u_in"] * d / raw["re"]) + 0.5)
    entry = next(c for c in json.loads(SPEC.read_text())["configs"] if c["name"] == NAME)
    assert entry["source"] == raw["source"] and entry["reduced"] == raw["reduced"] == ["d", "sphere"]
    assert set(raw["assumed"]) == {"d", "sphere", "initial_flow"} and raw["hybrid_method"] == "bounceback"
    kinds = [(b["kind"], b.get("normal"), "u" in b, "rho" in b) for b in mod.boundaries(cfg | small(4))]
    assert kinds == [("freeslip", (0, -1, 0), False, False), ("freeslip", (0, 1, 0), False, False),
                     ("freeslip", (0, 0, -1), False, False), ("freeslip", (0, 0, 1), False, False),
                     ("regularized", None, True, False), ("regularized", None, False, True),
                     ("hybrid", None, False, False)]


def test_masks_match_prepare_fields():
    _, cfg, bnd, _, bc_mask, missing = scene(4)
    lat = tunnel.Lattice(cfg["shape"], bnd, "cpu", "D3Q19", "BGK")
    assert torch.equal(lat.ids, bc_mask[0])
    assert torch.equal(lat.missing, missing)


@pytest.mark.parametrize("d", [4, 6])
def test_the_shell_is_the_fluid_part_of_pad_indices(d):
    _, cfg, bnd, stepper, bc_mask, _ = scene(d)
    hybrid = stepper.boundary_conditions[-1]
    pad = hybrid.pad_indices()
    fluid = pad[:, bc_mask[0][tuple(torch.as_tensor(pad))].numpy() != 255]
    key = lambda idx: sorted(map(tuple, np.asarray(idx).T.tolist()))  # noqa: E731
    assert key(bnd[-1]["shell"]) == key(fluid)
    assert (bc_mask[0][tuple(torch.as_tensor(fluid))] == hybrid.id).all()


def brute_crossing(x, c, center, radius, iters=80):
    """The fraction t in [0, 1] at which x + t c first lies in the sphere
    (|.|^2 < r^2), by a fine scan and bisection; inf when x + c is outside."""
    inside = lambda t: ((x + t * c - center) ** 2).sum() < radius**2  # noqa: E731
    if not inside(1.0):
        return np.inf
    if inside(0.0):
        return 0.0
    ts = np.linspace(0.0, 1.0, 2001)
    hi = next(t for t in ts if inside(t))
    lo = hi - ts[1]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        lo, hi = (lo, mid) if inside(mid) else (mid, hi)
    return hi


@pytest.mark.parametrize("d", [4, 6])
def test_link_distances_are_the_segments_crossings(d):
    mod, cfg = config(d)
    center, radius = mod.sphere(cfg)
    shell, dist = mod.link_distances(cfg["shape"], center, radius)
    assert dist.shape == (19, shell.shape[1]) and np.isfinite(dist).any(axis=0).all()
    c0 = np.asarray(center, np.float64)
    for i in range(shell.shape[1]):
        x = shell[:, i].astype(np.float64)
        for l in range(19):
            want = brute_crossing(x, C[:, l].astype(np.float64), c0, radius)
            if np.isinf(want):
                assert np.isinf(dist[l, i])
            else:
                assert abs(dist[l, i] - want) < 1e-9 and 0.0 <= dist[l, i] <= 1.0


def test_window_matches_torch_tier():
    # 30 float32 steps: the two sum and round in other orders, so they agree to float32 rounding
    mod, cfg, bnd, stepper, bc_mask, missing = scene(4)
    f0 = inputs.populations(tunnel, tuple(cfg["shape"]), SEED, 0, cfg["initial_flow"], "cpu")
    want, _ = stepper.build_multi_step(30)(f0.clone(), f0.clone(), bc_mask, missing, mod.omega(cfg))
    got = tunnel.window(tunnel.Lattice(cfg["shape"], bnd, "cpu", "D3Q19", "BGK"), f0, 30, mod.omega(cfg), "f32",
                        planes=5)
    assert float((got - want).abs().max()) < 2e-6
    # the link distances reach both sides: at the halfway fraction everywhere the reference departs
    halfway = [dict(b, distances=np.full_like(b["distances"], np.inf)) if b["kind"] == "hybrid" else b for b in bnd]
    other = tunnel.window(tunnel.Lattice(cfg["shape"], halfway, "cpu", "D3Q19", "BGK"), f0, 30, mod.omega(cfg), "f32")
    assert float((other - want).abs().max()) > 1e-4


def test_the_reference_refuses_what_it_does_not_implement():
    _, cfg = config(4)
    bnd = importlib.import_module(f"lbm_bench.configs.{NAME}").boundaries(cfg)
    with pytest.raises(ValueError, match="D3Q19 BGK"):
        tunnel.Lattice(cfg["shape"], bnd, "cpu", "D3Q27", "BGK")
    with pytest.raises(ValueError, match="bounceback"):
        tunnel.Lattice(cfg["shape"], bnd[:-1] + [dict(bnd[-1], method="bounceback_regularized")], "cpu", "D3Q19",
                       "BGK")
    with pytest.raises(ValueError, match="no boundary kind"):
        tunnel.Lattice(cfg["shape"], [dict(bnd[0], kind="outflow")], "cpu", "D3Q19", "BGK")


def test_sound_run_is_correct():
    result, lines = run_cell(CELL, SEED, 0, 0, CpuSystem(), time.perf_counter(), overrides=SMALL)
    assert result["correct"], lines
    assert set(result["metrics"]) == {"mlups", "setup_s"}


@pytest.mark.parametrize("fault", ["control", "unchanged", "half_domain", "altered"])
def test_control_and_planted_faults_are_not_correct(fault):
    if fault == "control":  # the program's own bfloat16 path
        system, overrides = CpuSystem(), dict(SMALL, policy=Cell(CELL).traffic["control"]["policy"])
    else:
        system, overrides = faults.Planted(CpuSystem(), getattr(faults, fault)), SMALL
    result, lines = run_cell(CELL, SEED, 0, 0, system, time.perf_counter(), overrides=overrides)
    assert not result["correct"], lines


def test_the_reference_imports_neither_jax_nor_the_program():
    code = ("import sys, lbm_bench.reference.tunnel\n"
            "print('TOP', sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = eval(out.stdout.split("TOP", 1)[1])
    assert not {"jax", "jaxlib", "flax", "xlb_tpu", "xlb_tpu_torch"} & set(tops)


def _window(d):
    from xlb_tpu_torch.kernels.fused_step import build_fused_window

    mod, cfg, _, stepper, bc_mask, missing = scene(d)
    f0 = inputs.populations(tunnel, tuple(cfg["shape"]), SEED, 0, cfg["initial_flow"], "cpu")
    return build_fused_window(stepper, 2), (f0, bc_mask, missing, mod.omega(cfg)), int(np.prod(cfg["shape"]))


def test_the_aux_span_is_null_off_a_profiler_and_the_counter_reads_the_fields_bytes(monkeypatch):
    from xlb_tpu_torch.kernels.fused_step import _FusedSweeps
    from xlb_tpu_torch.utils import tracing

    window, (f0, bc_mask, missing, omega), voxels = _window(4)
    before, records = _FusedSweeps.aux_bytes, tracing.records()

    def refuse(*args, **kwargs):
        raise AssertionError("a span with no profiler active reached the profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("xlb.window.aux", torch.device("cpu")) is tracing.span("xlb.window", torch.device("cpu"))
    window(f0, f0, bc_mask, missing, omega)
    # 19 wall-distance channels, float32, over the whole grid; built once per window
    assert _FusedSweeps.aux_bytes - before == 19 * 4 * voxels
    window(f0, f0, bc_mask, missing, omega)
    assert _FusedSweeps.aux_bytes - before == 19 * 4 * voxels
    assert tracing.records() == records


def test_the_aux_span_is_recorded_in_the_first_window_under_a_profiler():
    from xlb_tpu_torch.utils import tracing

    window, (f0, bc_mask, missing, omega), _ = _window(4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        window(f0, f0, bc_mask, missing, omega)
        window(f0, f0, bc_mask, missing, omega)
    recs = tracing.records()
    aux = [r for r in recs if r.name == "xlb.window.aux"]
    assert len(aux) == 1 and aux[0].parent.name == "xlb.window" and aux[0].host_ms > 0


def test_the_aux_field_metric(monkeypatch):
    from xlb_tpu_torch.kernels.fused_step import _FusedSweeps

    reader = Cell(CELL).metric_reader("setup.aux_field_gb")
    monkeypatch.setattr(_FusedSweeps, "aux_bytes", 3_631_000_000)
    on_card = SimpleNamespace(trace=SimpleNamespace(device=[("xlb::kstep_kernel", 0.0, 1.0)]))
    assert reader.read(on_card) == pytest.approx(3.631)
    # no device operation (the CPU), no trace, or a port without the counter: nothing to read
    assert reader.read(SimpleNamespace(trace=SimpleNamespace(device=[]))) is None
    assert reader.read(SimpleNamespace(trace=None)) is None
    monkeypatch.delattr(_FusedSweeps, "aux_bytes")
    assert reader.read(on_card) is None
