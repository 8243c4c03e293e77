"""Parity of the port's scene setup with xlb_tpu: the lid-driven cavity's
masks, initial populations, BC specs and packed mask.

``build_cavity`` (used by the other ``test_torch_*`` files) builds the
bench.py cavity -- fullway walls on five faces, an equilibrium lid on
``top`` -- in either package, from a clean global state.

The ``test_torch_*`` files import torch and ``xlb_tpu_torch`` inside the
tests, never at module level: every pytest-xdist worker imports every test
module, and importing late keeps torch, its memory and its thread pool out
of the workers until they reach the port's tests, so the JAX suite runs as
it does without the port.
"""

import importlib

import jax
import numpy as np
import pytest

import xlb_tpu
from xlb_tpu.kernels.fused_step import bc_to_spec as jax_bc_to_spec, pack_masks as jax_pack_masks

LID_U = (0.02, 0.0, 0.0)


def reset_port_state():
    import torch

    from xlb_tpu_torch import DefaultConfig
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry

    DefaultConfig.reset()
    boundary_condition_registry.reset()
    # the port's tests use tiny tensors: one intra-op thread keeps torch's
    # thread pool off the cores that the other test workers share
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def build_cavity(pkg_name, shape, policy="FP32FP32", backend=None, interior_solid=False):
    """(stepper, (f_0, f_1, bc_mask, missing_mask)) of the lid cavity in
    the package ``pkg_name`` ("xlb_tpu" or "xlb_tpu_torch"), on the CPU.
    ``backend`` is a ComputeBackend member name. ``interior_solid`` adds a
    fullway-bounce-back block inside the domain (the masker's interior
    geometry path)."""
    pkg = importlib.import_module(pkg_name)
    reg = importlib.import_module(f"{pkg_name}.boundary.registry").boundary_condition_registry
    bnd = importlib.import_module(f"{pkg_name}.boundary")
    models = importlib.import_module(f"{pkg_name}.models")
    stencils = importlib.import_module(f"{pkg_name}.velocity_set")
    pkg.DefaultConfig.reset()
    reg.reset()
    if backend is None:
        backend = "JAX" if pkg_name == "xlb_tpu" else "TORCH"
    pkg.init(velocity_set=stencils.D3Q19(), default_backend=pkg.ComputeBackend[backend],
             default_precision_policy=pkg.PrecisionPolicy[policy])
    if pkg_name == "xlb_tpu":
        grid = pkg.grid_factory(shape, mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    else:
        grid = pkg.grid_factory(shape, device="cpu")
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1
    )
    bcs = [
        bnd.FullwayBounceBackBC(indices=walls.tolist()),
        bnd.EquilibriumBC(rho=1.0, u=LID_U, indices=box_ne["top"]),
    ]
    if interior_solid:
        block = np.indices((2, 2, 2)).reshape(3, -1) + np.array([[3], [3], [3]])
        bcs.append(bnd.FullwayBounceBackBC(indices=block.tolist()))
    stepper = models.IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type="BGK")
    return stepper, stepper.prepare_fields()


def as_f32(x):
    """float32 NumPy copy of a jax array or torch tensor (bf16 exact)."""
    if hasattr(x, "detach"):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("interior_solid", [False, True])
@pytest.mark.parametrize("policy", ["FP32FP32", "FP32BF16"])
def test_prepare_fields_bit_equal(policy, interior_solid):
    import torch

    import xlb_tpu_torch

    shape = (12, 10, 8)  # non-cubic: axis mix-ups show
    sj, (f0j, f1j, bmj, mmj) = build_cavity("xlb_tpu", shape, policy, interior_solid=interior_solid)
    st, (f0t, f1t, bmt, mmt) = build_cavity("xlb_tpu_torch", shape, policy, interior_solid=interior_solid)
    assert bmt.dtype == torch.uint8 and bmt.shape == (1,) + shape
    assert mmt.dtype == torch.bool and mmt.shape == (19,) + shape
    np.testing.assert_array_equal(bmt.numpy(), np.asarray(bmj))
    np.testing.assert_array_equal(mmt.numpy(), np.asarray(mmj))
    assert f0t.dtype == xlb_tpu_torch.PrecisionPolicy[policy].store_dtype
    np.testing.assert_array_equal(as_f32(f0t), as_f32(f0j))
    np.testing.assert_array_equal(as_f32(f1t), as_f32(f1j))
    assert st.has_solids == sj.has_solids


def test_bc_to_spec_equal():
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec

    sj, _ = build_cavity("xlb_tpu", (12, 10, 8))
    st, _ = build_cavity("xlb_tpu_torch", (12, 10, 8))
    for bj, bt in zip(sj.boundary_conditions, st.boundary_conditions):
        a, b = jax_bc_to_spec(bj, sj.velocity_set), bc_to_spec(bt, st.velocity_set)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(a[key]))
            assert np.asarray(b[key]).dtype == np.asarray(a[key]).dtype


def test_pack_masks_bit_equal():
    import torch

    from xlb_tpu_torch.kernels.fused_step import pack_masks

    _, (_, _, bmj, mmj) = build_cavity("xlb_tpu", (12, 10, 8), interior_solid=True)
    _, (_, _, bmt, mmt) = build_cavity("xlb_tpu_torch", (12, 10, 8), interior_solid=True)
    packed = pack_masks(bmt, mmt)
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack_masks(bmj, mmj)))


def test_overlapping_bcs_raise():
    import xlb_tpu_torch
    from xlb_tpu_torch.boundary import EquilibriumBC, FullwayBounceBackBC
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.velocity_set import D3Q19

    xlb_tpu_torch.init(D3Q19())
    grid = xlb_tpu_torch.grid_factory((6, 6, 6), device="cpu")
    top = grid.bounding_box_indices()["top"]
    bcs = [FullwayBounceBackBC(indices=top), EquilibriumBC(rho=1.0, u=LID_U, indices=top)]
    with pytest.raises(ValueError, match="overlap"):
        IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs).prepare_fields()
