"""Guards of the port: no JAX import in the package, no silent fallback
from the CUDA tier, and kernel wrappers that refuse what the kernels do
not take. (torch is imported inside the tests; test_torch_setup.py says
why.)"""

import ast
import importlib.util
import pathlib

import numpy as np
import pytest

from tests.test_torch_setup import build_cavity, reset_port_state

PACKAGE = pathlib.Path(importlib.util.find_spec("xlb_tpu_torch").origin).parent
SHAPE = (6, 5, 4)


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def test_package_never_imports_jax():
    offenders = []
    for path in sorted(PACKAGE.rglob("*.py")) + [PACKAGE.parent / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            offenders += [f"{path.name}: {n}" for n in names if n == "jax" or n.startswith(("jax.", "xlb_tpu.")) or n == "xlb_tpu"]
    assert not offenders, offenders


def test_grids_default_to_the_card():
    """Without ``device=`` a grid lives on CUDA; where there is no card it
    raises torch's own error when it allocates, never building CPU tensors."""
    import inspect

    import torch

    import xlb_tpu_torch
    from xlb_tpu_torch.helper.nse_fields import create_nse_fields
    from xlb_tpu_torch.utils import fields_from_numpy

    grid = xlb_tpu_torch.grid_factory((4, 4, 4))
    assert grid.device.type == "cuda"
    for fn in (xlb_tpu_torch.grid_factory, xlb_tpu_torch.Grid, create_nse_fields, fields_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            grid.create_field(19, dtype=torch.float32)


def test_cuda_stepper_on_cpu_grid_raises():
    with pytest.raises(ValueError, match="CUDA device"):
        build_cavity("xlb_tpu_torch", SHAPE, backend="CUDA")


def test_unported_pieces_raise():
    import torch

    from xlb_tpu_torch.boundary.base import BoundaryCondition, ImplementationStep
    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.velocity_set import D3Q27

    st, _ = build_cavity("xlb_tpu_torch", SHAPE)

    class SomeOtherBC(BoundaryCondition):
        def __init__(self):
            super().__init__(ImplementationStep.STREAMING, indices=[[0], [0], [0]])

    with pytest.raises(NotImplementedError):
        bc_to_spec(SomeOtherBC(), st.velocity_set)
    with pytest.raises(NotImplementedError):
        IncompressibleNavierStokesStepper(st.grid, collision_type="KBC")
    with pytest.raises(NotImplementedError):
        CollideStreamStep(st.velocity_set, SHAPE, store_dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        CollideStreamStep(D3Q27(), SHAPE)
    with pytest.raises(ValueError):
        CollideStreamKStep(st.velocity_set, SHAPE, steps=1)


def _wrapper_inputs():
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    st, (f_0, _, bc_mask, missing_mask) = build_cavity("xlb_tpu_torch", SHAPE)
    specs = [bc_to_spec(bc, st.velocity_set) for bc in st.boundary_conditions]
    return st.velocity_set, specs, f_0, pack_masks(bc_mask, missing_mask)


@pytest.mark.parametrize("bad", ["dtype", "shape", "mask_dtype", "noncontiguous", "requires_grad"])
@pytest.mark.parametrize("kernel", ["step", "kstep"])
def test_wrappers_reject_bad_inputs(kernel, bad):
    import torch

    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep

    vs, specs, f, mask = _wrapper_inputs()
    fused = (CollideStreamStep if kernel == "step" else CollideStreamKStep)(vs, SHAPE, bc_specs=specs)
    if bad == "dtype":
        f = f.to(torch.bfloat16)
    elif bad == "shape":
        f = f[:, :-1].contiguous()
    elif bad == "mask_dtype":
        mask = mask.to(torch.int64)
    elif bad == "noncontiguous":
        f = torch.empty((19,) + SHAPE[::-1]).permute(0, 3, 2, 1)
    else:
        f = f.clone().requires_grad_(True)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        fused(f, mask, 1.9)
    assert fused(*_wrapper_inputs()[2:], 1.9).shape == (19,) + SHAPE  # good inputs still run


def test_adjoint_wrapper_rejects_bad_inputs():
    """The adjoint kernel's wrapper takes a float32 cotangent of the
    primal's shape that does not require grad, and a primal that does not
    require grad either (it has no double backward)."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint

    vs, specs, f, mask = _wrapper_inputs()
    adjoint = CollideStreamAdjoint(vs, SHAPE, bc_specs=specs)
    g = torch.ones_like(f)
    for bad_f, bad_g in ((f, g[:, :-1].contiguous()), (f, g.to(torch.bfloat16)), (f, g.clone().requires_grad_(True)),
                         (f.clone().requires_grad_(True), g)):
        with pytest.raises((ValueError, RuntimeError)):
            adjoint(bad_f, bad_g, mask, 1.9)
    df, dom = adjoint(f, g, mask, 1.9)
    assert df.shape == f.shape and dom.shape == SHAPE and df.dtype == dom.dtype == torch.float32


def test_every_fused_spec_kind_has_an_adjoint():
    from xlb_tpu_torch.kernels.adjoint_step import adjoint_supported
    from xlb_tpu_torch.kernels.collide_stream_dma import kernel_params

    vs, specs, _, _ = _wrapper_inputs()
    assert {s["kind"] for s in specs} == {"equilibrium", "fullway"}
    kernel_params(vs, specs, has_solids=True)  # every kind the fused forward takes
    assert all(adjoint_supported([s]) for s in specs) and adjoint_supported(specs)


@pytest.mark.parametrize("steps", [1, 3])
def test_cuda_window_differentiates(steps):
    """A CUDA-tier window whose input requires grad runs forward and
    backward (the wrappers' plain versions here): the kernels see detached
    tensors, the adjoint runs once per step, and a direct k-step call on a
    tensor that requires grad still raises (it has no backward of its own)."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.fused_step import build_fused_window

    st, (f_0, f_1, bc_mask, missing_mask) = build_cavity("xlb_tpu_torch", SHAPE)
    f = f_0.clone().requires_grad_(True)
    omega = torch.tensor(1.9, requires_grad=True)
    out, _ = build_fused_window(st, steps)(f, f_1, bc_mask, missing_mask, omega)
    calls = CollideStreamAdjoint.plain_calls
    out.sum().backward()
    assert CollideStreamAdjoint.plain_calls == calls + steps
    assert f.grad.shape == f.shape and omega.grad is not None and bool(torch.isfinite(f.grad).all())
    vs, specs, _, mask = _wrapper_inputs()
    with pytest.raises(RuntimeError, match="no autograd"):
        CollideStreamKStep(vs, SHAPE, bc_specs=specs)(f, mask, 1.9)


def test_kstep_shared_memory_budget():
    """Default tiles fit two blocks per SM; the measured-best tiles at k=2."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream_2step import TILE_BUDGET, default_tile, kstep_smem_bytes

    for store in (torch.float32, torch.bfloat16):
        for steps in (2, 3, 4):
            assert kstep_smem_bytes(steps, default_tile(steps, store), store.itemsize) <= TILE_BUDGET
    assert default_tile(2, torch.bfloat16) == (4, 8, 32)
    assert default_tile(2, torch.float32) == (4, 4, 32)
    assert kstep_smem_bytes(2, (4, 8, 32), 2) == 19 * 6 * 10 * 34 * 2


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    from xlb_tpu_torch.kernels import _cuda

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.find_nvcc()


def test_kernel_params_layout():
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep

    vs, specs, _, _ = _wrapper_inputs()
    p = CollideStreamStep(vs, SHAPE, bc_specs=specs).params
    assert p.n_bc == 2 and list(p.bc_kind[:2]) == [1, 0] and list(p.bc_id[:2]) == [1, 2]
    np.testing.assert_array_equal(np.array(p.w[:]), vs._w.astype(np.float32))
    np.testing.assert_array_equal(np.array(p.bc_feq[1][:]), specs[1]["feq"])
