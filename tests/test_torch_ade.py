"""The advection-diffusion and Boussinesq models of the port
(``xlb_tpu_torch/models/ade.py``) against ``xlb_tpu``'s jnp tier, at
small sizes:

- the ADE step on the 2D 32^2 scene of ``tests/models/test_ade.py`` with a
  Zou-He pressure wall and a halfway circle obstacle, and on a 12x10x8
  D3Q19 scene with an equilibrium floor and ceiling or with Zou-He,
  regularized and do-nothing faces (the kernels' kExtOpen form), from a
  seeded advecting velocity;
- the thermal coupling of ``examples/cfd/rayleigh_benard_2d.py`` at 32^2,
  with and without its obstacle;
- each through the TORCH tier and through the CUDA tier's steps
  (``build_fused_ade_step`` / ``build_fused_forced_step``), whose kernel
  wrappers run their plain versions on CPU tensors;
- the torch form of ``rayleigh_benard_2d.py`` against its ``run()``.

Tolerance: 5e-6 absolute, the reference's own for its fused ADE and
thermal steps (``tests/models/test_ade.py``). Inputs are made from a seed
with NumPy and carried across with ``utils.interop``. (torch is imported
inside the tests; test_torch_setup.py says why.)
"""

import functools
import importlib

import jax
import numpy as np
import pytest

from tests.test_torch_setup import as_f32, reset_port_state

ATOL = 5e-6
OMEGA = 1.3
STEPS = 3


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def _pkg(pkg_name, vs_name, backend=None):
    """(package, its boundary module, models, grid factory) after a clean
    init of ``pkg_name`` on the CPU."""
    pkg = importlib.import_module(pkg_name)
    importlib.import_module(f"{pkg_name}.boundary.registry").boundary_condition_registry.reset()
    pkg.DefaultConfig.reset()
    stencils = importlib.import_module(f"{pkg_name}.velocity_set")
    backend = backend or ("JAX" if pkg_name == "xlb_tpu" else "TORCH")
    pkg.init(velocity_set=getattr(stencils, vs_name)(), default_backend=pkg.ComputeBackend[backend],
             default_precision_policy=pkg.PrecisionPolicy.FP32FP32)

    def grid(shape):
        if pkg_name == "xlb_tpu":
            return pkg.grid_factory(shape, mesh_shape=(1,) * len(shape), devices=jax.devices()[:1])
        return pkg.grid_factory(shape, device="cpu")

    return pkg, importlib.import_module(f"{pkg_name}.boundary"), importlib.import_module(f"{pkg_name}.models"), grid


def _gaussian_phi(n, sigma, offset=1.0):
    x = np.arange(n) - n / 2
    xx, yy = np.meshgrid(x, x, indexing="ij")
    return (offset + np.exp(-(xx**2 + yy**2) / (2 * sigma**2))).astype(np.float32)


def ade_scene(pkg_name, kind):
    """(ADE stepper, prepare_fields(), u as float32 NumPy) of the scene
    ``kind``: "zouhe_obstacle" (test_ade.py's 32^2 scene), "walls3d" (a
    12x10x8 D3Q19 box with a hot floor and a cold ceiling) or "open3d"
    (Zou-He pressure, regularized pressure and do-nothing faces)."""
    if kind == "zouhe_obstacle":
        _, bnd, models, grid_of = _pkg(pkg_name, "D2Q9")
        n = 32
        grid = grid_of((n, n))
        box_ne = grid.bounding_box_indices(remove_edges=True)
        yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
        circ = np.stack(np.nonzero((xx - n / 2) ** 2 + (yy - n / 2) ** 2 <= 5.0**2))
        bcs = [bnd.ZouHeBC("pressure", prescribed_value=1.5, indices=box_ne["left"]),
               bnd.HalfwayBounceBackBC(indices=circ.tolist())]
        phi0, u_shape, seed = _gaussian_phi(n, 4.0), (2, n, n), 7
    else:
        _, bnd, models, grid_of = _pkg(pkg_name, "D3Q19")
        shape = (12, 10, 8)
        grid = grid_of(shape)
        box_ne = grid.bounding_box_indices(remove_edges=True)
        if kind == "walls3d":
            bcs = [bnd.EquilibriumBC(rho=1.0, u=(0.0, 0.0, 0.0), indices=box_ne["bottom"]),
                   bnd.EquilibriumBC(rho=0.0, u=(0.0, 0.0, 0.0), indices=box_ne["top"])]
        else:
            bcs = [bnd.ZouHeBC("pressure", prescribed_value=1.2, indices=box_ne["left"]),
                   bnd.RegularizedBC("pressure", prescribed_value=0.9, indices=box_ne["right"]),
                   bnd.DoNothingBC(indices=box_ne["front"])]
        rng = np.random.default_rng(3)
        phi0, u_shape, seed = (1.0 + 0.2 * rng.random(shape)).astype(np.float32), (3,) + shape, 5
    stepper = models.AdvectionDiffusionStepper(grid, boundary_conditions=bcs)
    u = (0.02 * np.random.default_rng(seed).standard_normal(u_shape)).astype(np.float32)
    return stepper, stepper.prepare_fields(phi_init=phi0), u


@functools.cache
def jnp_ade(kind):
    """STEPS jnp-tier ADE steps of the scene, and its initial state (NumPy),
    built once per test process."""
    import jax.numpy as jnp

    stepper, fields, u = ade_scene("xlb_tpu", kind)

    @jax.jit  # one compile: op by op takes longer
    def run(g_0, g_1, bm, mm, u):
        for t in range(STEPS):
            g_0, g_1 = stepper(g_0, g_1, bm, mm, OMEGA, u, t)
            g_0, g_1 = g_1, g_0
        return g_0

    return tuple(np.asarray(x) for x in fields), np.asarray(run(*fields, jnp.asarray(u)))


def _torch_ade(kind, fused):
    from xlb_tpu_torch.kernels.fused_step import build_fused_ade_step
    from xlb_tpu_torch.utils import aux_from_numpy, fields_from_numpy

    stepper, _, u = ade_scene("xlb_tpu_torch", kind)
    if fused:
        stepper._fused_step = build_fused_ade_step(stepper)  # the CUDA tier's step: plain versions on the CPU
    ref_fields, ref = jnp_ade(kind)
    g_0, g_1, bm, mm = fields_from_numpy(*ref_fields, device="cpu")
    ut = aux_from_numpy(u, device="cpu")
    for t in range(STEPS):
        g_0, g_1 = stepper(g_0, g_1, bm, mm, OMEGA, ut, t)
        g_0, g_1 = g_1, g_0
    return g_0, ref


@pytest.mark.parametrize("fused", [False, True], ids=["torch_tier", "plain_kernel"])
@pytest.mark.parametrize("kind", ["zouhe_obstacle", "walls3d", "open3d"])
def test_ade_step_matches_jnp_tier(kind, fused):
    """STEPS ADE steps of the TORCH tier, and of the CUDA tier's step
    (K3 / K1's ``ade`` mode, plain versions), against the jnp tier."""
    out, ref = _torch_ade(kind, fused)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(as_f32(out), ref, rtol=0, atol=ATOL)


def test_ade_setup_and_phi_match():
    """prepare_fields (masks and g) bit for bit, and phi, for the 2D scene."""
    import torch

    sj, fj, _ = ade_scene("xlb_tpu", "zouhe_obstacle")
    st, ft, _ = ade_scene("xlb_tpu_torch", "zouhe_obstacle")
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(as_f32(a) if a.dtype != torch.bool else a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(as_f32(st.phi(ft[0])), np.asarray(sj.phi(fj[0])))


def thermal_scene(pkg_name, obstacle, n=32):
    """(ThermalNSEStepper, (f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g,
    miss_g)) of rayleigh_benard_2d.py's scene at n x n: halfway floor and
    ceiling for f, a hot floor and a cold ceiling for g, with the
    obstacle a halfway circle for both."""
    _, bnd, models, grid_of = _pkg(pkg_name, "D2Q9")
    grid = grid_of((n, n))
    box = grid.bounding_box_indices()
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top")], axis=1), axis=1)
    nse_bcs = [bnd.HalfwayBounceBackBC(indices=walls.tolist())]
    ade_bcs = [bnd.EquilibriumBC(rho=1.0, u=(0.0, 0.0), indices=box["bottom"]),
               bnd.EquilibriumBC(rho=0.0, u=(0.0, 0.0), indices=box["top"])]
    if obstacle:
        ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        circ = np.stack(np.nonzero((ii - n / 2) ** 2 + (jj - n / 2) ** 2 <= (n / 8) ** 2))
        nse_bcs.append(bnd.HalfwayBounceBackBC(indices=circ.tolist()))
        ade_bcs.append(bnd.HalfwayBounceBackBC(indices=circ.tolist()))
    nse = models.IncompressibleNavierStokesStepper(grid, boundary_conditions=nse_bcs)
    ade = models.AdvectionDiffusionStepper(grid, boundary_conditions=ade_bcs)
    thermal = models.ThermalNSEStepper(nse, ade, beta=5e-3, gravity=(0.0, -1.0))
    f_0, f_1, bc_f, miss_f = nse.prepare_fields()
    yy = np.broadcast_to((np.arange(n) / (n - 1.0))[None, :], (n, n))
    xx = np.broadcast_to((np.arange(n) / n)[:, None], (n, n))
    phi0 = (1.0 - yy) + 0.05 * np.sin(2 * np.pi * 3 * xx) * np.sin(np.pi * yy)
    g_0, g_1, bc_g, miss_g = ade.prepare_fields(phi_init=phi0.astype(np.float32))
    return thermal, (f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g)


def _coupled(thermal, state, steps):
    f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g = state
    for t in range(steps):
        f_0, f_1, g_0, g_1 = thermal(f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g, OMEGA, OMEGA, t)
        f_0, f_1, g_0, g_1 = f_1, f_0, g_1, g_0
    return f_0, g_0


@functools.cache
def jnp_thermal(obstacle):
    thermal, state = thermal_scene("xlb_tpu", obstacle)
    run = jax.jit(lambda *state: _coupled(thermal, state, STEPS))  # one compile: op by op takes longer
    return tuple(np.asarray(x) for x in state), tuple(np.asarray(x) for x in run(*state))


@pytest.mark.parametrize("fused", [False, True], ids=["torch_tier", "plain_kernels"])
@pytest.mark.parametrize("obstacle", [False, True], ids=["plain", "obstacle"])
def test_thermal_matches_jnp_tier(obstacle, fused):
    """STEPS coupled steps of the TORCH tier, and of the CUDA tier's two
    steps (K3's ``extern_force`` and ``ade`` modes, plain versions), from
    xlb_tpu's initial state, against the jnp tier: f and g."""
    from xlb_tpu_torch.kernels.fused_step import build_fused_ade_step, build_fused_forced_step
    from xlb_tpu_torch.utils import fields_from_numpy

    thermal, _ = thermal_scene("xlb_tpu_torch", obstacle)
    if fused:
        thermal._fused_nse = build_fused_forced_step(thermal.nse)
        thermal.ade._fused_step = build_fused_ade_step(thermal.ade)
    ref_state, (ref_f, ref_g) = jnp_thermal(obstacle)
    f_0, f_1, bc_f, miss_f = fields_from_numpy(ref_state[0], ref_state[1], ref_state[4], ref_state[5], device="cpu")
    g_0, g_1, bc_g, miss_g = fields_from_numpy(ref_state[2], ref_state[3], ref_state[6], ref_state[7], device="cpu")
    f, g = _coupled(thermal, (f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g), STEPS)
    np.testing.assert_allclose(as_f32(f), ref_f, rtol=0, atol=ATOL)
    np.testing.assert_allclose(as_f32(g), ref_g, rtol=0, atol=ATOL)


def test_thermal_window_equals_coupled_steps():
    """build_multi_step(n) is n coupled steps with the buffers swapped."""
    import torch

    thermal, state = thermal_scene("xlb_tpu_torch", False, n=16)
    f, g = _coupled(thermal, state, 2)
    fw, _, gw, _ = thermal.build_multi_step(2)(*state, OMEGA, OMEGA)
    assert torch.equal(f, fw) and torch.equal(g, gw)


def test_rayleigh_benard_script_matches_reference():
    """The torch form of rayleigh_benard_2d.py (TORCH tier) against the
    reference's run() at 32x16, 100 steps: the Nusselt number per window."""
    from examples.cfd import rayleigh_benard_2d as ref_script
    from xlb_tpu_torch.examples.cfd import rayleigh_benard_2d as script

    kw = dict(nx=32, ny=16, rayleigh=5e4, num_steps=100, window=50, obstacle=True)
    ref = ref_script.run(**kw)
    reset_port_state()
    ours = script.run(**kw, backend="torch", device="cpu")
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)
