"""Scenes with more BCs than the kernels' old table held, on the CPU.

The CUDA kernels take the prescriptions of the whole id space in their
launch parameters, so the only limit left on a scene's BC count is the
stencil's packed id field, as in ``xlb_tpu``. Here:

- a 16^3 D3Q19 cavity with 15 BCs (ten fullway wall pieces, a lid split
  into three equilibrium pieces of different velocities, two halfway
  blocks): the TORCH tier and the plain fused steps (``kernel="dma"`` and
  ``"blocked"``) against xlb_tpu's jnp tier, 3 steps, rtol 1e-5 and atol
  5e-6 (the bound of the other parity tests);
- ``kernel_params`` packs that scene, and tables as large as the id
  spaces: 253 ids on D3Q19, ids up to 29 on D3Q27, where id 30 raises as
  in ``xlb_tpu``.

(torch is imported inside the tests; test_torch_setup.py says why.)
"""

import importlib

import numpy as np
import pytest

from chip_smoke import many_bcs
from tests.test_torch_collisions import _init, _jnp_steps, _macroscopic_fields, _run_steps
from tests.test_torch_setup import as_f32, reset_port_state

SHAPE = (16, 16, 16)


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def seeded_many_bc_cavity(pkg_name, halfway=True, seed=0):
    """(stepper, fields) of chip_smoke.py's many-BC cavity at SHAPE on the
    CPU, in either package, f_0 the equilibrium of seeded (rho, u) fields."""
    import jax

    pkg = _init(pkg_name, 19)
    if pkg_name == "xlb_tpu":
        grid = pkg.grid_factory(SHAPE, mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    else:
        grid = pkg.grid_factory(SHAPE, device="cpu")
    bcs = many_bcs(grid, importlib.import_module(f"{pkg_name}.boundary"), halfway)
    models = importlib.import_module(f"{pkg_name}.models")
    stepper = models.IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type="BGK")
    _, f_1, bc_mask, missing_mask = stepper.prepare_fields()
    init_mac = importlib.import_module(f"{pkg_name}.helper.initializers").initialize_from_macroscopic
    rho, u = _macroscopic_fields(SHAPE, seed)
    f_0 = init_mac(stepper.grid, stepper.velocity_set, stepper.precision_policy, rho, u)
    return stepper, (f_0, f_1, bc_mask, missing_mask)


def test_many_bc_cavity_tiers_match_jnp_tier():
    from xlb_tpu_torch.kernels.fused_step import build_fused_step

    sj, fj = seeded_many_bc_cavity("xlb_tpu")
    ref = as_f32(_jnp_steps(sj, fj, 3))
    st, ft = seeded_many_bc_cavity("xlb_tpu_torch")
    assert len(st.boundary_conditions) == 15
    assert set(np.unique(as_f32(ft[2])).tolist()) == set(range(16)) | {255}  # fluid, 15 BC ids, the blocks' solids
    for step in (st, build_fused_step(st), build_fused_step(st, kernel="blocked")):
        np.testing.assert_allclose(as_f32(_run_steps(step, ft, 3)), ref, rtol=1e-5, atol=5e-6)


def test_kernel_params_take_the_whole_id_space():
    from xlb_tpu.kernels.collide_stream import kernel_bc_id as jax_kernel_bc_id
    from xlb_tpu_torch.kernels import _cuda
    from xlb_tpu_torch.kernels.collide_stream_dma import BASE_KINDS_3D, ZOO_KINDS_3D, kernel_params
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec
    from xlb_tpu_torch.velocity_set import D3Q19, D3Q27

    for halfway, kinds in ((True, ZOO_KINDS_3D), (False, BASE_KINDS_3D)):
        st, _ = seeded_many_bc_cavity("xlb_tpu_torch", halfway=halfway)
        specs = [bc_to_spec(bc, st.velocity_set) for bc in st.boundary_conditions]
        p = kernel_params(st.velocity_set, specs, has_solids=True, kinds=kinds)
        assert p.n_bc == (15 if halfway else 13)
        assert list(p.bc_id[: p.n_bc]) == [s["id"] for s in specs]
        assert list(p.bc_kind[: p.n_bc]) == [_cuda.BC_KIND[s["kind"]] for s in specs]
        # the lid pieces are BCs 10-12, past the 8 the table held before
        for b, s in enumerate(specs):
            if s["kind"] == "equilibrium":
                assert b >= 8
                np.testing.assert_array_equal(np.array(p.bc[b].vec[:19]), s["feq"])

    def fullway(ids):
        return [{"kind": "fullway", "id": i, "step": "collision"} for i in ids]

    assert kernel_params(D3Q19(), fullway(range(1, 254)), has_solids=True).n_bc == 253
    p = kernel_params(D3Q27(), fullway(range(1, 30)), has_solids=True)
    assert list(p.bc_id[:29]) == [jax_kernel_bc_id(i, 27) for i in range(1, 30)]
    with pytest.raises(ValueError, match="5-bit id space"):
        jax_kernel_bc_id(30, 27)
    with pytest.raises(ValueError, match="5-bit id space"):
        kernel_params(D3Q27(), fullway(range(1, 31)), has_solids=True)
