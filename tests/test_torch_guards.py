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
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
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
    # D3Q27 runs in the single step and its adjoint; 3D Zou-He in both on
    # D3Q19 BGK (the kExtOpen form), in neither on D3Q27 BGK (no such form)
    assert CollideStreamAdjoint(D3Q27(), SHAPE).params.q == 27
    zouhe = {"kind": "zouhe", "id": 1, "step": "streaming", "bc_type": "pressure", "value": 1.0}
    for cls in (CollideStreamStep, CollideStreamAdjoint):
        assert cls(st.velocity_set, SHAPE, bc_specs=[zouhe]).params.walled == 2
        with pytest.raises(NotImplementedError):
            cls(D3Q27(), SHAPE, bc_specs=[zouhe])
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
    """Every column the k-step wrapper picks fits one block's 227 KB of
    shared memory (the table's at k = 2 per form, the budget rule's at k =
    3, 4), and the layout is the three-plane rings of sweeps 1 .. k-1."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream_2step import (COLLISION_TILES, MAX_SHARED, TILE_BUDGET, TILES,
                                                            default_tile, kstep_smem_bytes)

    assert MAX_SHARED == 227 * 1024
    for q in (19, 27):
        for store in (torch.float32, torch.bfloat16):
            for walled in range(4):
                assert (q, store, walled) in TILES
                for steps in (2, 3, 4):
                    tile = default_tile(steps, store, q, walled)
                    assert kstep_smem_bytes(steps, tile, store.itemsize, q) <= MAX_SHARED
                    if steps > 2:
                        assert kstep_smem_bytes(steps, tile, store.itemsize, q) <= TILE_BUDGET
    for (q, collision, store, walled), tile in COLLISION_TILES.items():
        assert default_tile(2, store, q, walled, collision) == tile
        assert kstep_smem_bytes(2, tile, store.itemsize, q) <= MAX_SHARED
    assert default_tile(2, torch.float32, 19, 0, "TRT") != default_tile(2, torch.float32, 19, 0)
    # D3Q19 f32 at 8x32: one ring of depth 1, three planes of (8 + 2) x (32 + 2) voxels
    assert kstep_smem_bytes(2, (8, 32), 4) == 3 * 19 * 10 * 34 * 4
    # k = 3: the rings of depth 2 and 1, each 16-byte aligned (3 x 27 x 6 x 18 x 2 = 17496 -> 17504)
    assert kstep_smem_bytes(3, (4, 16), 2, 27) == 3 * 27 * 8 * 20 * 2 + 17504
    with pytest.raises(ValueError, match="no k-step tile"):
        default_tile(9, torch.float32, 27)


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    from xlb_tpu_torch.kernels import _cuda

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.find_nvcc()


def test_kernel_params_layout():
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep

    vs, specs, _, _ = _wrapper_inputs()
    import ctypes

    from xlb_tpu_torch.kernels import _cuda

    # the C layout: the scalars first, then the kinds, ids and prescriptions
    # (a flag and a q-vector each) of the whole id space, by value, with a
    # kernel's other arguments under the 32,764-byte parameter limit
    P = _cuda.XlbStepParams
    assert P.q.offset == 2 * 4 * _cuda.MAX_Q + 8 and P.bc_kind.offset == P.mrt_rate.offset + 8
    assert P.bc.offset == P.bc_kind.offset + 2 * 4 * _cuda.MAX_BC
    assert ctypes.sizeof(_cuda.XlbBc) == 4 + 4 * _cuda.MAX_Q
    assert ctypes.sizeof(P) == P.bc.offset + _cuda.MAX_BC * ctypes.sizeof(_cuda.XlbBc) and ctypes.sizeof(P) + 256 <= 32764
    p = CollideStreamStep(vs, SHAPE, bc_specs=specs).params
    assert p.n_bc == 2 and list(p.bc_kind[:2]) == [1, 0] and list(p.bc_id[:2]) == [1, 2]
    np.testing.assert_array_equal(np.array(p.w[: vs.q]), vs._w.astype(np.float32))
    np.testing.assert_array_equal(np.array(p.bc[1].vec[: vs.q]), specs[1]["feq"])


def test_no_jax_guard_covers_the_2d_modules():
    scanned = {p.name for p in PACKAGE.rglob("*.py")}
    assert {"collide_stream_2d.py", "bc_zouhe.py", "bc_regularized.py", "force.py", "units.py"} <= scanned


def _wrapper_inputs_2d(kind="cylinder-regularized"):
    from tests.test_torch_2d import build_scene_2d
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    st, (f_0, _, bc_mask, missing_mask), _ = build_scene_2d("xlb_tpu_torch", kind, (16, 12))
    specs = [bc_to_spec(bc, st.velocity_set) for bc in st.boundary_conditions]
    return st.velocity_set, specs, f_0, pack_masks(bc_mask, missing_mask)


@pytest.mark.parametrize("bad", ["dtype", "shape", "mask_dtype", "noncontiguous", "requires_grad"])
@pytest.mark.parametrize("kernel", ["step_2d", "kstep_2d"])
def test_2d_wrappers_reject_bad_inputs(kernel, bad):
    import torch

    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep, CollideStream2DStep

    vs, specs, f, mask = _wrapper_inputs_2d()
    fused = (CollideStream2DStep if kernel == "step_2d" else CollideStream2DKStep)(vs, (16, 12), bc_specs=specs)
    if bad == "dtype":
        f = f.to(torch.bfloat16)
    elif bad == "shape":
        f = f[:, :-1].contiguous()
    elif bad == "mask_dtype":
        mask = mask.to(torch.int64)
    elif bad == "noncontiguous":
        f = torch.empty((9, 12, 16)).permute(0, 2, 1)
    else:
        f = f.clone().requires_grad_(True)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        fused(f, mask, 1.6)
    assert fused(*_wrapper_inputs_2d()[2:], 1.6).shape == (9, 16, 12)  # good inputs still run


def test_2d_kernel_configuration_guards():
    """The 2D kernels take D2Q9 only, 2 <= k <= 8, and the 3D kernels none
    of the 2D-only epilogue kinds, on D3Q19 or on D3Q27."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream_2d import (
        KSTEP_THREADS, KSTEP_VOXELS, TILE, CollideStream2DKStep, CollideStream2DStep, kstep_2d_smem_bytes)
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep, kernel_params
    from xlb_tpu_torch.velocity_set import D3Q19, D3Q27

    vs, specs, _, _ = _wrapper_inputs_2d()
    assert {s["kind"] for s in specs} == {"fullway", "regularized", "halfway"}
    for steps in (1, 9):
        with pytest.raises(ValueError):
            CollideStream2DKStep(vs, (16, 12), bc_specs=specs, steps=steps)
    with pytest.raises(NotImplementedError):
        CollideStream2DStep(D3Q19(), (4, 4, 4))
    with pytest.raises(NotImplementedError):
        CollideStreamStep(vs, (16, 12))
    for kind in ("halfway", "zouhe", "regularized"):
        spec = next(s for s in _wrapper_inputs_2d("cylinder-zouhe")[1] + specs if s["kind"] == kind)
        with pytest.raises(NotImplementedError, match="3D"):
            kernel_params(D3Q19(), [spec], has_solids=True)
    zouhe = next(s for s in _wrapper_inputs_2d("cylinder-zouhe")[1] if s["kind"] == "zouhe")
    with pytest.raises(NotImplementedError, match="3D"):
        kernel_params(D3Q27(), [zouhe], has_solids=False)
    # at every k a sweep's region fits the voxels the block holds, and the tile a block's shared memory
    for steps in range(2, 9):
        assert (TILE[0] + 2 * steps - 2) * (TILE[1] + 2 * steps - 2) <= KSTEP_THREADS * KSTEP_VOXELS
        for store in (torch.float32, torch.bfloat16):
            assert kstep_2d_smem_bytes(steps, TILE, store.itemsize) <= 227 * 1024


def test_2d_kernel_params_layout():
    """The BC table of the 2D kernels: halfway's moving-wall term and flag,
    Zou-He / regularized velocity, density and velocity/pressure flag."""
    from xlb_tpu_torch.kernels import _cuda
    from xlb_tpu_torch.kernels.collide_stream_dma import kernel_params
    from tests.test_torch_2d import build_scene_2d
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec

    st, _, _ = build_scene_2d("xlb_tpu_torch", "halfway_cavity", (16, 12), u_wall=(0.01, 0.0))
    vs = st.velocity_set
    p = kernel_params(vs, [bc_to_spec(b, vs) for b in st.boundary_conditions], has_solids=True)
    table = p.bc
    assert p.n_bc == 2 and p.bc_kind[0] == _cuda.BC_KIND["halfway"] and table[0].flag == 1
    np.testing.assert_array_equal(np.array(table[0].vec[:9]), (6.0 * vs._w * (vs._c.T @ [0.01, 0.0])).astype(np.float32))
    np.testing.assert_array_equal(np.array(p.w[:9]), vs._w.astype(np.float32))
    np.testing.assert_array_equal(np.array(p.w45[:9]), (4.5 * vs._w).astype(np.float32))
    vs, specs, _, _ = _wrapper_inputs_2d("cylinder-zouhe")
    p = kernel_params(vs, specs, has_solids=True)
    table = p.bc
    assert list(p.bc_kind[:4]) == [1, 3, 3, 2] and [b.flag for b in table[:4]] == [0, 0, 1, 0]
    assert list(table[1].vec[:2]) == [np.float32(0.04), 0.0] and table[2].vec[0] == 1.0


def test_spatial_prescriptions_raise():
    """What the 2D kernels (K3, K4) still refuse: the extrapolation
    outflow, free-slip and do-nothing, naming the kind. Prescriptions that
    vary in space ride the aux field, which the 2D kernels' kExtHybrid form
    reads. A Zou-He profile takes no coordinates (as in xlb_tpu): it
    returns the prescribed values."""
    import xlb_tpu_torch
    from xlb_tpu_torch.boundary import (DoNothingBC, ExtrapolationOutflowBC, FreeSlipBC, HalfwayBounceBackBC,
                                        ZouHeBC)
    from xlb_tpu_torch.kernels.collide_stream_2d import EXT_2D_HYBRID, CollideStream2DKStep, CollideStream2DStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec
    from xlb_tpu_torch.velocity_set import D2Q9

    xlb_tpu_torch.init(D2Q9())
    idx = [[0, 1], [3, 3]]
    for bc in (ExtrapolationOutflowBC(indices=idx), FreeSlipBC(indices=idx, normal=(0, -1)), DoNothingBC(indices=idx)):
        spec = bc_to_spec(bc, D2Q9())
        for cls in (CollideStream2DStep, CollideStream2DKStep):
            with pytest.raises(NotImplementedError, match=f"{spec['kind']}.*2D CUDA kernels"):
                cls(D2Q9(), (8, 6), bc_specs=[spec])
    for bc in (HalfwayBounceBackBC(indices=idx, profile=lambda coords: np.zeros_like(coords)),
               ZouHeBC("velocity", profile=lambda: np.zeros((2, 5)), indices=idx)):
        step = CollideStream2DStep(D2Q9(), (8, 6), bc_specs=[bc_to_spec(bc, D2Q9())])
        assert step.ext == EXT_2D_HYBRID and step.aux_channels == 2
    with pytest.raises(ValueError, match="zero-argument"):
        ZouHeBC("pressure", profile=lambda coords: coords[0], indices=idx)


def test_no_jax_guard_covers_the_multires_modules():
    scanned = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert {"models/multires.py", "grid/multires.py", "helper/simulation_manager.py", "kernels/collide_only.py",
            "kernels/collide_then_stream.py", "mres_perf_optimization_type.py", "utils/tiers.py"} <= scanned


def test_multires_routes_notify_and_refuse_as_the_reference():
    """Route choices go through notify_fallback: a finest level with a BC
    the CTS kernel does not take stays on the TORCH tier with a
    RuntimeWarning, as does a middle level with BCs; the fused routes are
    3-D; the CUDA tier never runs the plain versions for CUDA tensors (the
    wrappers dispatch on the tensor's device alone)."""
    import xlb_tpu_torch
    from xlb_tpu_torch.boundary import FullwayBounceBackBC, ZouHeBC
    from xlb_tpu_torch.grid import MultiresGrid
    from xlb_tpu_torch.models.multires import MultiresIncompressibleNavierStokesStepper
    from xlb_tpu_torch.mres_perf_optimization_type import MresPerfOptimizationType
    from xlb_tpu_torch.velocity_set import D2Q9, D3Q19

    fused = MresPerfOptimizationType.FUSION_AT_FINEST
    xlb_tpu_torch.init(D3Q19())
    grid = MultiresGrid((16, 16, 16), boxes=[((4, 4, 4), (8, 8, 8))] * 2, device="cpu")
    zouhe = ZouHeBC("pressure", prescribed_value=1.0, indices=[[0] * 3, [1, 2, 3], [4] * 3])
    with pytest.warns(RuntimeWarning, match="finest level stays on the TORCH tier"):
        st = MultiresIncompressibleNavierStokesStepper(grid, boundary_conditions={0: [zouhe]}, mres_perf_opt=fused)
    assert st._cts is None and st.active_finest_tier == "torch"
    with pytest.warns(RuntimeWarning, match="middle level 1 has BCs"):
        st = MultiresIncompressibleNavierStokesStepper(
            grid, boundary_conditions={1: [FullwayBounceBackBC(indices=[[1], [1], [1]])]}, mres_perf_opt=fused)
    assert st._cts_mid[1] is None and st.active_mid_tiers[1] == "torch" and st._cts is not None
    xlb_tpu_torch.init(D2Q9())
    with pytest.warns(RuntimeWarning, match="3-D"):
        st = MultiresIncompressibleNavierStokesStepper(MultiresGrid((8, 8), boxes=[((2, 2), (4, 4))], device="cpu"),
                                                       mres_perf_opt=fused)
    assert st._cts is None


def test_zoo_refuses_what_it_lacks_and_never_falls_back():
    """KBC on D3Q19 raises on both tiers, as in xlb_tpu. Under autograd a
    kernel="dma" step of the TRT cavity and of the forced D3Q27 KBC channel
    differentiates through the adjoint kernel's wrapper (its plain version
    on CPU tensors), with no notice of another route; its gradients match
    TORCH-tier autograd, as kernel="blocked"'s (the TORCH tier's VJP) do. A
    configuration outside the CUDA instantiation table raises, naming it,
    before any launch and without running the plain version."""
    import warnings

    import torch

    from tests.test_torch_collisions import build_scene
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import build_fused_step
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.velocity_set import D3Q19

    st, (f_0, f_1, bc_mask, missing_mask) = build_scene("xlb_tpu_torch", "cavity", SHAPE, "TRT")
    with pytest.raises(NotImplementedError, match="KBC"):
        IncompressibleNavierStokesStepper(st.grid, collision_type="KBC")
    with pytest.raises(NotImplementedError, match="KBC"):
        CollideStreamStep(D3Q19(), SHAPE, collision="KBC")

    f_ref = f_0.clone().requires_grad_(True)
    st(f_ref, f_1, bc_mask, missing_mask, 1.5)[1].square().sum().backward()
    f = f_0.clone().requires_grad_(True)
    calls = CollideStreamAdjoint.plain_calls
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, out = build_fused_step(st)(f, f_1, bc_mask, missing_mask, 1.5)
        out.square().sum().backward()
    assert CollideStreamAdjoint.plain_calls == calls + 1
    assert not [w for w in caught if issubclass(w.category, RuntimeWarning)]
    torch.testing.assert_close(f.grad, f_ref.grad)
    f = f_0.clone().requires_grad_(True)
    _, out = build_fused_step(st, kernel="blocked")(f, f_1, bc_mask, missing_mask, 1.5)
    out.square().sum().backward()
    torch.testing.assert_close(f.grad, f_ref.grad)

    forced, (g_0, g_1, bm, mm) = build_scene("xlb_tpu_torch", "channel", SHAPE, "KBC", q=27)
    grads = []
    for step in (build_fused_step(forced), forced):
        g = g_0.clone().requires_grad_(True)
        omega = torch.tensor(1.5, requires_grad=True)
        calls = CollideStreamAdjoint.plain_calls
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(g, g_1, bm, mm, omega)[1].square().sum().backward()
        assert CollideStreamAdjoint.plain_calls == calls + (step is not forced)
        assert not [w for w in caught if issubclass(w.category, RuntimeWarning)]
        grads.append((g.grad, omega.grad))
    torch.testing.assert_close(grads[0], grads[1])

    class NoInstantiations:
        @staticmethod
        def xlb_has_instantiation(*args):
            return 0

    step = CollideStreamStep(st.velocity_set, SHAPE, collision="TRT")
    calls = CollideStreamStep.plain_calls
    with pytest.raises(NotImplementedError, match="no CUDA instantiation for D3Q19 TRT"):
        step._require_instantiation(NoInstantiations)
    assert CollideStreamStep.plain_calls == calls


def test_field_mode_gates_refuse():
    """The field modes of K1 and K3 (ade, extern_force) refuse at
    construction what they are not instantiated for -- ADE on D3Q27 or with
    a hybrid BC or a per-voxel prescription, the force on a D3Q19 TRT,
    either shifted, with a constant force, or on another kernel -- and a
    call without the field's aux channels; a form the library refuses
    raises at the launch, with no plain call."""
    import torch

    from xlb_tpu_torch.kernels import _cuda
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep, CollideStream2DStep
    from xlb_tpu_torch.kernels.collide_stream_blocked import CollideStreamBlocked
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.velocity_set import D2Q9, D3Q19, D3Q27

    hybrid = {"kind": "hybrid", "id": 3, "step": "streaming", "method": "bounceback", "use_dist": False, "mw": None}
    spatial = {"kind": "zouhe", "id": 4, "step": "streaming", "bc_type": "velocity", "value": "aux"}
    for make, match in (
        (lambda: CollideStreamStep(D3Q27(), SHAPE, collision="KBC", field="ade"), "instantiated for"),
        (lambda: CollideStreamStep(D3Q19(), SHAPE, collision="TRT", field="extern_force"), "instantiated for"),
        (lambda: CollideStreamStep(D3Q19(), SHAPE, bc_specs=[hybrid], field="ade"), "constant prescriptions"),
        (lambda: CollideStream2DStep(D2Q9(), SHAPE[:2], bc_specs=[spatial], field="ade"), "constant prescriptions"),
        (lambda: CollideStreamStep(D3Q19(), SHAPE, store_dtype=torch.bfloat16, shifted=True, field="ade"),
         "stores unshifted"),
        (lambda: CollideStreamStep(D3Q19(), SHAPE, force_vector=(1e-5, 0, 0), field="extern_force"), "not both"),
    ):
        with pytest.raises(NotImplementedError, match=match):
            make()
    for other in (CollideStream2DKStep, CollideStreamBlocked):  # the field modes are K1's and K3's only
        with pytest.raises(TypeError):
            other(D3Q19(), SHAPE, field="ade")

    step = CollideStreamStep(D3Q19(), SHAPE, field="extern_force")
    assert step.aux_channels == 3 and step.params.walled == 1
    f = torch.ones((19,) + SHAPE)
    mask = torch.zeros(SHAPE, dtype=torch.int32)
    with pytest.raises(ValueError, match="aux field"):
        step(f, mask, 1.0)

    class Refusing:  # a library whose field entry refuses the form (as outside has_field)
        @staticmethod
        def xlb_collide_stream_field_step(*args):
            return 1  # cudaErrorInvalidValue

        @staticmethod
        def xlb_error_string(err):
            return b"invalid argument"

    calls = CollideStreamStep.plain_calls
    aux = torch.zeros((3,) + SHAPE)
    err = step._launch(Refusing, f, mask, torch.empty_like(f), 1.0, None, aux)
    with pytest.raises(RuntimeError, match="invalid argument"):
        _cuda.check(Refusing, err, "CollideStreamStep launch")
    assert CollideStreamStep.plain_calls == calls


def test_ade_models_guards():
    """omega_from_diffusivity and diffusivity_from_omega invert each other;
    the coupled models need the pull scheme; the CUDA tier needs a grid on
    the card; the ADE step takes only the voxel-local BCs."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary import HybridBC
    from xlb_tpu_torch.kernels.fused_step import build_fused_ade_step
    from xlb_tpu_torch.models import (AdvectionDiffusionStepper, IncompressibleNavierStokesStepper,
                                      ShanChenMultiphaseStepper, ThermalNSEStepper, diffusivity_from_omega,
                                      omega_from_diffusivity)
    from xlb_tpu_torch.velocity_set import D2Q9

    for d in (0.02, 0.1, 1.0 / 6.0):
        assert abs(diffusivity_from_omega(omega_from_diffusivity(d)) - d) < 1e-12
    xlb.init(velocity_set=D2Q9(), default_backend=xlb.ComputeBackend.TORCH,
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)
    grid = xlb.grid_factory((8, 6), device="cpu")
    nse = IncompressibleNavierStokesStepper(grid)
    nse.streaming_scheme = "push"
    with pytest.raises(NotImplementedError, match="pull"):
        ThermalNSEStepper(nse, AdvectionDiffusionStepper(grid))
    with pytest.raises(NotImplementedError, match="pull"):
        ShanChenMultiphaseStepper(nse)
    with pytest.raises(ValueError, match="CUDA device"):
        AdvectionDiffusionStepper(grid, compute_backend=xlb.ComputeBackend.CUDA)
    ade = AdvectionDiffusionStepper(grid, [HybridBC(indices=[[3], [3]])])
    with pytest.raises(NotImplementedError, match="constant prescriptions"):
        build_fused_ade_step(ade)


@pytest.mark.parametrize("vs_name, collision, force, match", [("D3Q19", "TRT", None, "instantiated for"),
                                                               ("D3Q19", "MRT", None, "instantiated for"),
                                                               ("D2Q9", "BGK", (1e-5, 0.0), "not both")])
def test_shan_chen_cuda_tier_refuses_what_it_lacks(vs_name, collision, force, match):
    """A CUDA-tier Shan-Chen stepper on a (stencil, collision) pair without
    the forced kernel, or over an NSE stepper with a constant force, raises
    when it is made, as the thermal stepper does: no TORCH-tier step on the
    card's tensors."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch import velocity_set as vsets
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper, ShanChenMultiphaseStepper

    reset_port_state()
    vs = getattr(vsets, vs_name)()
    xlb.init(velocity_set=vs, default_backend=xlb.ComputeBackend.TORCH,
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)
    grid = xlb.grid_factory((8, 6) if vs.d == 2 else (6, 5, 4), device="cpu")
    kwargs = {"collision_type": collision}
    if force is not None:
        kwargs["force_vector"] = force
    nse = IncompressibleNavierStokesStepper(grid, **kwargs)
    nse.compute_backend = xlb.ComputeBackend.CUDA  # the CUDA tier's gate, without a card
    with pytest.raises(NotImplementedError, match=match):
        ShanChenMultiphaseStepper(nse)
