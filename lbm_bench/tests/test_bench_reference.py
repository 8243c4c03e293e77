"""The plain reference against the port's TORCH tier (plain torch on the
CPU): the masks, the forward window, the gradients of a 2-step window,
and the bfloat16 deviation-form window against the fused window's plain
kernels."""

import importlib

import numpy as np
import pytest
import torch

from lbm_bench import inputs
from lbm_bench.bench import ROOT, read_json
from lbm_bench.reference import lbm

SCENES = (("cavity512_d3q19_bgk", (16, 16, 16)), ("sphere_open_768x192x192", (48, 24, 24)))
SEED = 2**31 + 11


def config(name, **changes):
    return importlib.import_module(f"lbm_bench.configs.{name}"), dict(read_json(ROOT / "configs" / f"{name}.json"),
                                                                       **changes)


def scene(name, shape, policy="FP32FP32"):
    mod, cfg = config(name, shape=list(shape))
    bnd = mod.boundaries(cfg)
    stepper, bc_mask, missing = mod.program_scene(cfg, bnd, policy, "cpu", "TORCH")
    f0 = inputs.populations(lbm, shape, SEED, 0, cfg["initial_flow"], "cpu")
    return cfg, mod, bnd, stepper, bc_mask, missing, f0


def lattice(shape, bnd):
    return lbm.Lattice(shape, bnd, "cpu", "D3Q19", "BGK")


@pytest.mark.parametrize("name,shape", SCENES)
def test_masks_match_prepare_fields(name, shape):
    _, _, bnd, _, bc_mask, missing, _ = scene(name, shape)
    lat = lattice(shape, bnd)
    assert torch.equal(lat.ids, bc_mask[0])
    assert torch.equal(lat.missing, missing)


@pytest.mark.parametrize("name,shape", SCENES)
def test_window_matches_torch_tier(name, shape):
    # 30 float32 steps: the two sum and round in other orders, so they agree to float32 rounding
    cfg, mod, bnd, stepper, bc_mask, missing, f0 = scene(name, shape)
    want, _ = stepper.build_multi_step(30)(f0.clone(), f0.clone(), bc_mask, missing, mod.omega(cfg))
    got = lbm.window(lattice(shape, bnd), f0, 30, mod.omega(cfg), "f32", planes=5)
    assert float((got - want).abs().max()) < 2e-6


@pytest.mark.parametrize("name,shape", SCENES)
def test_gradients_match_torch_tier(name, shape):
    cfg, mod, bnd, stepper, bc_mask, missing, f0 = scene(name, shape)
    target = inputs.populations(lbm, shape, SEED, 1, {"base_u": [0.0, 0.0, 0.0], "amplitude": 0.01}, "cpu")
    grads = []
    for run in ("torch", "reference"):
        f = f0.clone().requires_grad_(True)
        om = torch.tensor(1.6, requires_grad=True)
        if run == "torch":
            out, _ = stepper.build_multi_step(2)(f, f, bc_mask, missing, om)
        else:
            out = lbm.steps_autograd(lattice(shape, bnd), f, 2, om)
        torch.mean((out - target) ** 2).backward()
        grads.append((f.grad, float(om.grad)))
    # float32 sums in other orders: within 1e-5 of the largest entry, 1e-4 of d omega
    (df_t, dw_t), (df_r, dw_r) = grads
    assert float((df_r - df_t).abs().max()) <= 1e-5 * float(df_t.abs().max())
    assert abs(dw_r - dw_t) <= 1e-4 * abs(dw_t)


@pytest.mark.parametrize("name,shape", SCENES)
def test_bf16_window_matches_the_fused_plain_window(name, shape):
    # both round every step to bfloat16 in deviation form; a rounding that
    # falls the other way on one side moves a population by one ulp of g
    # (|g| < 0.03: 1.2e-4), and such steps add up over 20 steps
    from xlb_tpu_torch.kernels.fused_step import build_fused_window

    cfg, mod, bnd, stepper, bc_mask, missing, f0 = scene(name, shape, "FP32BF16")
    want, _ = build_fused_window(stepper, 20)(f0, None, bc_mask, missing, mod.omega(cfg))
    got = lbm.window(lattice(shape, bnd), f0, 20, mod.omega(cfg), "bf16", planes=7)
    fp8 = lbm.window(lattice(shape, bnd), f0, 20, mod.omega(cfg), "fp8", planes=7)
    assert float((got - want.float()).abs().max()) < 2e-3
    assert float((fp8 - got).abs().max()) > 1e-2


def test_slabs_do_not_change_the_result():
    cfg, mod, bnd, _, _, _, f0 = scene(*SCENES[1])
    lat = lattice(SCENES[1][1], bnd)
    one = lbm.window(lat, f0, 6, mod.omega(cfg), "f32", planes=32)
    # the inlet's small matrix products may sum in another order at another batch: float32 rounding
    assert float((one - lbm.window(lat, f0, 6, mod.omega(cfg), "f32", planes=3)).abs().max()) < 1e-6


def test_seeded_inputs_repeat_and_differ():
    flow = {"base_u": [0.04, 0, 0], "amplitude": 0.01}
    a = inputs.populations(lbm, (8, 6, 4), 2**31 + 3, 0, flow, "cpu")
    assert torch.equal(a, inputs.populations(lbm, (8, 6, 4), 2**31 + 3, 0, flow, "cpu"))
    assert not torch.equal(a, inputs.populations(lbm, (8, 6, 4), 2**31 + 4, 0, flow, "cpu"))
    assert np.isclose(float(a.sum()) / (8 * 6 * 4), 1.0, atol=0.05)


@pytest.mark.parametrize("name", [n for n, _ in SCENES])
def test_the_configured_lattice_and_collision_reach_both_sides(name):
    # the port is built with the configuration's lattice and collision, and
    # the reference refuses a pair it does not implement rather than run D3Q19 BGK
    mod, cfg = config(name, shape=[16, 12, 12], velocity_set="D3Q27", collision="KBC")
    stepper, _, missing = mod.program_scene(cfg, mod.boundaries(cfg), "FP32FP32", "cpu", "TORCH")
    assert stepper.velocity_set.q == 27 and stepper.collision_type == "KBC" and missing.shape[0] == 27
    with pytest.raises(ValueError, match="D3Q19 BGK"):
        lbm.Lattice(cfg["shape"], mod.boundaries(cfg), "cpu", cfg["velocity_set"], cfg["collision"])


def test_the_sphere_follows_upstream():
    # upstream's formulas: centre (nx // 6, ny // 2, nz // 2), radius ny // 12, strictly inside
    mod, cfg = config("sphere_open_768x192x192")
    center, radius = mod.sphere(cfg)
    assert center == [128, 96, 96] and radius == 16
    idx = mod.boundaries(dict(cfg, shape=[48, 24, 24]))[3]["indices"]
    d2 = ((idx - np.array([[8], [12], [12]])) ** 2).sum(axis=0)
    assert (d2 < 4).all() and idx.shape[1] == int(sum(1 for x in range(-2, 3) for y in range(-2, 3)
                                                          for z in range(-2, 3) if x * x + y * y + z * z < 4))
    prof = mod.inlet_profile(24, 24, 0.04)
    assert prof[0, 0, 0, 0] == 0.0 and prof[0, 0, 11, 12] == pytest.approx(0.04 * (1 - (2 * 0.5 / 23) ** 2 * 2))
