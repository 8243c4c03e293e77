"""The Shan-Chen multiphase model of the port
(``xlb_tpu_torch/models/multiphase.py``) against ``xlb_tpu``'s jnp tier,
at small sizes:

- the 32^2 droplet with a halfway wall and ``psi_wall`` (D2Q9), a 12^3
  D3Q19 and an 8^3 D3Q27 KBC periodic fluid from a seeded density
  perturbation, and the Schafer-Turek scene at D = 4 (a parabolic inlet
  through the aux field and a hybrid cylinder: the forced kernels'
  kExtHybrid form, the BCs' channels after the force's);
- each through the TORCH tier (``_step_pull(..., force_field)``) and
  through the CUDA tier's forced step (``build_fused_forced_step``, whose
  kernel wrappers run their plain versions on CPU tensors);
- psi, the pressure, the interaction shift and the macroscopics;
- the torch form of ``multiphase_droplet_2d.py`` against its ``run()``.

Tolerance: rtol 2e-6 / atol 2e-7, the reference's own for its fused
Shan-Chen step (``tests/models/test_multiphase.py``). Inputs are made
from a seed with NumPy and carried across with ``utils.interop``. (torch
is imported inside the tests; test_torch_setup.py says why.)
"""

import functools
import importlib

import jax
import numpy as np
import pytest

from tests.test_torch_ade import _pkg
from tests.test_torch_setup import as_f32, reset_port_state

RTOL, ATOL = 2e-6, 2e-7
STEPS = 3
OMEGA = 1.0


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def sc_scene(pkg_name, kind):
    """(Shan-Chen stepper, (f_0, f_1, bc_mask, missing_mask)) of ``kind``:
    "droplet" (32^2, a halfway wall on the bottom row, psi_wall 0.85),
    "d3q19" (12^3), "d3q27_kbc" (8^3, KBC), "hybrid" (the Schafer-Turek
    scene at D = 4, psi_wall 0.5)."""
    vs_name = {"d3q19": "D3Q19", "d3q27_kbc": "D3Q27"}.get(kind, "D2Q9")
    _, bnd, models, grid_of = _pkg(pkg_name, vs_name)
    collision, psi_wall, bcs = "BGK", None, ()
    if kind == "droplet":
        n = 32
        grid = grid_of((n, n))
        bcs = [bnd.HalfwayBounceBackBC(indices=[list(range(n)), [0] * n])]
        x = np.arange(n) - n / 2 + 0.5
        xx, yy = np.meshgrid(x, np.arange(n) - 1.0, indexing="ij")
        rho0 = 0.16 + 0.5 * (1.9 - 0.16) * (1.0 - np.tanh((np.sqrt(xx**2 + yy**2) - 8.0) / 2.0))
        psi_wall = 0.85
    elif kind == "hybrid":
        from xlb_tpu_torch.examples.cfd.cylinder_benchmark_schafer_turek import geometry, schafer_turek_bcs

        distances = importlib.import_module(f"{pkg_name}.geometry.distances")
        nx, ny, _, _ = geometry(4)
        grid = grid_of((nx, ny))
        bcs = schafer_turek_bcs(grid, bnd, distances.implicit_link_distances, 4,
                                hybrid_method="bounceback_regularized")
        rho0 = 1.0 + 0.02 * np.random.default_rng(13).standard_normal((nx, ny))
        psi_wall = 0.5
    else:
        n = 12 if kind == "d3q19" else 8
        grid = grid_of((n, n, n))
        rho0 = 0.7 * (1.0 + 0.02 * np.random.default_rng(11).standard_normal((n, n, n)))
        collision = "BGK" if kind == "d3q19" else "KBC"
    nse = models.IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type=collision)
    sc = models.ShanChenMultiphaseStepper(nse, G=-5.0, psi_wall=psi_wall)
    _, _, bc_mask, missing_mask = nse.prepare_fields()
    w = np.asarray(nse.velocity_set._w, np.float32).reshape((-1,) + (1,) * rho0.ndim)
    f_0 = (w * rho0[None]).astype(np.float32)
    return sc, (f_0, np.zeros_like(f_0), bc_mask, missing_mask)


def _steps(sc, fields, n):
    f_0, f_1, bc_mask, missing_mask = fields
    for t in range(n):
        f_0, f_1 = sc(f_0, f_1, bc_mask, missing_mask, OMEGA, t)
        f_0, f_1 = f_1, f_0
    return f_0


@functools.cache
def jnp_sc(kind):
    """STEPS jnp-tier Shan-Chen steps of the scene and its initial state
    (NumPy), built once per test process."""
    import jax.numpy as jnp

    sc, (f_0, f_1, bm, mm) = sc_scene("xlb_tpu", kind)
    fields = (jnp.asarray(f_0), jnp.asarray(f_1), bm, mm)
    run = jax.jit(lambda *fields: _steps(sc, fields, STEPS))  # one compile: op by op takes longer
    return tuple(np.asarray(x) for x in fields), np.asarray(run(*fields))


def torch_sc(kind, fused):
    from xlb_tpu_torch.kernels.fused_step import build_fused_forced_step
    from xlb_tpu_torch.utils import fields_from_numpy

    sc, _ = sc_scene("xlb_tpu_torch", kind)
    if fused:
        sc._fused_nse = build_fused_forced_step(sc.nse)  # the CUDA tier's step: plain versions on the CPU
    ref_fields, ref = jnp_sc(kind)
    return sc, fields_from_numpy(*ref_fields, device="cpu"), ref


@pytest.mark.parametrize("fused", [False, True], ids=["torch_tier", "plain_kernel"])
@pytest.mark.parametrize("kind", ["droplet", "d3q19", "d3q27_kbc", "hybrid"])
def test_shan_chen_matches_jnp_tier(kind, fused):
    """STEPS steps of the TORCH tier, and of the CUDA tier's forced step
    (K3 / K1's ``extern_force`` mode, plain versions), from xlb_tpu's
    initial state against the jnp tier."""
    sc, fields, ref = torch_sc(kind, fused)
    out = _steps(sc, fields, STEPS)
    np.testing.assert_allclose(as_f32(out), ref, rtol=RTOL, atol=ATOL)


def test_readouts_match():
    """psi, the pressure, the interaction shift (psi_wall on the halfway
    wall) and the macroscopics of the droplet's state, against xlb_tpu's."""
    import jax.numpy as jnp

    sj, (f0, _, bmj, _) = sc_scene("xlb_tpu", "droplet")
    st, (f0t, _, bmt, _) = sc_scene("xlb_tpu_torch", "droplet")
    import torch

    ft = torch.from_numpy(f0t)
    rho_j = jnp.sum(jnp.asarray(f0), axis=0, keepdims=True)
    rho_t = torch.sum(ft, dim=0, keepdim=True)
    for ours, ref in ((st.psi(rho_t), sj.psi(rho_j)), (st.pressure(rho_t), sj.pressure(rho_j)),
                      (st.interaction_du(rho_t, bmt), sj.interaction_du(rho_j, bmj)),
                      (st.macroscopic(ft, bmt)[1], sj.macroscopic(jnp.asarray(f0), bmj)[1])):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert st._wall_ids == sj._wall_ids


def test_window_equals_steps():
    """build_multi_step(n) is n steps with the buffers swapped."""
    import torch

    sc, fields, _ = torch_sc("d3q19", False)
    out, _ = sc.build_multi_step(2)(*fields, OMEGA)
    assert torch.equal(out, _steps(sc, fields, 2))


def test_droplet_script_matches_reference():
    """The torch form of multiphase_droplet_2d.py (TORCH tier) against the
    reference's run() at n = 32, radii 6 and 8, 100 steps: per radius R,
    dp, |u|max and the densities, then sigma."""
    from examples.cfd import multiphase_droplet_2d as ref_script
    from xlb_tpu_torch.examples.cfd import multiphase_droplet_2d as script

    kw = dict(n=32, radii=(6.0, 8.0), num_steps=100)
    sigma_ref, _, rows_ref = ref_script.run(**kw)
    reset_port_state()
    sigma, _, rows = script.run(**kw, backend="torch", device="cpu")
    np.testing.assert_allclose(np.asarray(rows), np.asarray(rows_ref), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sigma, sigma_ref, rtol=1e-4)
