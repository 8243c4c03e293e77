"""The 2D path (D2Q9) of the port against xlb_tpu: the lid cavities of
``examples/performance/mlups_2d.py`` and ``examples/cfd/lid_driven_cavity_2d.py``
and the cylinder of ``examples/cfd/flow_past_cylinder_2d.py``, at small
sizes.

- Setup: the masker's fluid-side shell and solid interior, ``bc_to_spec``
  of the new BCs, ``CustomInitializer``, ``MomentumTransfer`` and
  ``omega_from_reynolds``.
- The TORCH tier against the jnp tier over 20 steps.
- The plain K3 and K4 against xlb_tpu's 2D kernels in Pallas interpret
  mode (as ``tests/kernels/test_fused_2d.py`` runs them), and the
  CUDA-tier window (plain versions here) against xlb_tpu's fused window.
- Gradients of the CUDA-tier ``stepper(...)`` against ``jax.grad`` of the
  jnp tier, and the 2D window refusing autograd.

xlb_tpu's 2D kernels need 8 | X, hence the 40 x 24 and 16 x 16 domains.
All inputs are made from a seed with NumPy. (torch is imported inside the
tests; test_torch_setup.py says why.)
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xlb_tpu.kernels.collide_stream_2d import (
    build_fused_collide_stream_2d as jax_k3,
    build_fused_collide_stream_2d_kstep as jax_k4,
)
from xlb_tpu.kernels.fused_step import (
    bc_to_spec as jax_bc_to_spec,
    build_fused_window as jax_build_fused_window,
    pack_masks as jax_pack_masks,
)
from tests.test_torch_setup import as_f32, reset_port_state

SHAPE = (40, 24)
OMEGA = 1.6
U_LID, U_IN = 0.05, 0.04
SOLID = (slice(12, 18), slice(6, 10))  # cell type 255 block in the cavities
# store dtype: (jnp dtype, torch dtype name, shifted)
STORES = {"f32": (jnp.float32, "float32", False), "bf16-shifted": (jnp.bfloat16, "bfloat16", True)}


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def build_scene_2d(pkg_name, kind, shape=SHAPE, policy="FP32FP32", u_wall=None, initializer=True):
    """(stepper, fields, cylinder BC) of a 2D scene in ``pkg_name``, on the
    CPU. ``kind``: "cavity" (mlups_2d.py: fullway walls), "halfway_cavity"
    (lid_driven_cavity_2d.py: halfway walls, moving at ``u_wall`` when
    given), "cylinder-regularized" or "cylinder-zouhe"
    (flow_past_cylinder_2d.py, started from the uniform inflow unless
    ``initializer`` is false)."""
    pkg = importlib.import_module(pkg_name)
    reg = importlib.import_module(f"{pkg_name}.boundary.registry").boundary_condition_registry
    bnd = importlib.import_module(f"{pkg_name}.boundary")
    models = importlib.import_module(f"{pkg_name}.models")
    stencils = importlib.import_module(f"{pkg_name}.velocity_set")
    inits = importlib.import_module(f"{pkg_name}.helper.initializers")
    pkg.DefaultConfig.reset()
    reg.reset()
    backend = "JAX" if pkg_name == "xlb_tpu" else "TORCH"
    pkg.init(velocity_set=stencils.D2Q9(), default_backend=pkg.ComputeBackend[backend],
             default_precision_policy=pkg.PrecisionPolicy[policy])
    if pkg_name == "xlb_tpu":
        grid = pkg.grid_factory(shape, mesh_shape=(1, 1), devices=jax.devices()[:1])
    else:
        grid = pkg.grid_factory(shape, device="cpu")
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    init, bc_cyl = None, None
    if kind in ("cavity", "halfway_cavity"):
        walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right")], axis=1), axis=1)
        if kind == "cavity":
            wall = bnd.FullwayBounceBackBC(indices=walls.tolist())
        else:
            wall = bnd.HalfwayBounceBackBC(indices=walls.tolist(), prescribed_value=u_wall)
        bcs = [wall, bnd.EquilibriumBC(rho=1.0, u=(U_LID, 0.0), indices=box_ne["top"])]
    else:
        nx, ny = shape
        d = ny // 4
        X, Y = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        cyl = np.array(np.nonzero((X - nx // 4) ** 2 + (Y - (ny // 2 + 1)) ** 2 <= (d / 2) ** 2))
        walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top")], axis=1), axis=1)
        inout = bnd.RegularizedBC if kind == "cylinder-regularized" else bnd.ZouHeBC
        bc_cyl = bnd.HalfwayBounceBackBC(indices=cyl.tolist())
        bcs = [
            bnd.FullwayBounceBackBC(indices=walls.tolist()),
            inout("velocity", prescribed_value=(U_IN, 0.0), indices=box_ne["left"]),
            inout("pressure", prescribed_value=1.0, indices=box_ne["right"]),
            bc_cyl,
        ]
        if initializer:
            init = inits.CustomInitializer(rho_0=1.0, u_0=(U_IN, 0.0))
    stepper = models.IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type="BGK")
    return stepper, stepper.prepare_fields(initializer=init), bc_cyl


def _perturbed(f0, seed, shifted=False, w=None):
    """A seeded perturbation of f0 (float32), or of the rest state in
    deviation form g = 0.02 w N(0, 1) when ``shifted``."""
    rng = np.random.default_rng(seed)
    if shifted:
        return (0.02 * w.reshape(-1, 1, 1) * rng.standard_normal((9,) + SHAPE)).astype(np.float32)
    f = np.asarray(f0).astype(np.float32)
    return (f * (1.0 + 0.05 * rng.standard_normal(f.shape))).astype(np.float32)


def _to_torch(a, dtype="float32"):
    import torch

    return torch.from_numpy(np.array(np.asarray(a).astype(np.float32))).to(getattr(torch, dtype))


def _kernel_inputs(kind, store_key, seed, u_wall=None):
    """A scene's masks (a solid block in the cavities) and a seeded field in
    store form, in both packages. Returns ((jax vs, specs, f, mask),
    (torch vs, specs, f, mask))."""
    import torch

    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    jstore, tstore, shifted = STORES[store_key]
    out = []
    for pkg in ("xlb_tpu", "xlb_tpu_torch"):
        st, (f0, _, bm, mm), _ = build_scene_2d(pkg, kind, u_wall=u_wall)
        vs = st.velocity_set
        bm = np.array(bm)
        if kind.endswith("cavity"):
            bm[(0,) + SOLID] = 255
        f = jnp.asarray(_perturbed(f0, seed, shifted, vs._w), dtype=jstore)  # store-dtype rounding in jax
        if pkg == "xlb_tpu":
            out.append((vs, [jax_bc_to_spec(b, vs) for b in st.boundary_conditions], f, jax_pack_masks(jnp.asarray(bm), mm)))
        else:
            mask = pack_masks(torch.from_numpy(bm), mm)
            out.append((vs, [bc_to_spec(b, vs) for b in st.boundary_conditions], _to_torch(f, tstore), mask))
    return out


def _assert_8ulp(ours, ref, jstore):
    eps = float(jnp.finfo(jstore).eps)
    np.testing.assert_allclose(as_f32(ours), as_f32(ref), rtol=8 * eps, atol=8 * eps * 0.05)


# ---------------------------------------------------------------- setup --


def test_cylinder_masks_bit_equal():
    """The masker tags the cylinder's dilated shell with the halfway BC's
    id and its solid voxels cell type 255, as xlb_tpu's does."""
    import torch

    from xlb_tpu_torch.kernels.fused_step import pack_masks

    sj, (_, _, bmj, mmj), _ = build_scene_2d("xlb_tpu", "cylinder-regularized")
    st, (_, _, bmt, mmt), bc_cyl = build_scene_2d("xlb_tpu_torch", "cylinder-regularized")
    np.testing.assert_array_equal(bmt.numpy(), np.asarray(bmj))
    np.testing.assert_array_equal(mmt.numpy(), np.asarray(mmj))
    np.testing.assert_array_equal(pack_masks(bmt, mmt).numpy(), np.asarray(jax_pack_masks(bmj, mmj)))
    assert bool((bmt == 255).any()) and bool((bmt == bc_cyl.id).any())
    assert st.has_solids and sj.has_solids
    assert pack_masks(bmt, mmt).dtype == torch.int32


@pytest.mark.parametrize("which", ["halfway", "halfway-moving", "halfway-profile", "zouhe-velocity", "zouhe-pressure",
                                   "regularized-velocity", "regularized-pressure"])
def test_bc_to_spec_equal(which):
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec

    specs = []
    for pkg_name in ("xlb_tpu", "xlb_tpu_torch"):
        pkg = importlib.import_module(pkg_name)
        bnd = importlib.import_module(f"{pkg_name}.boundary")
        importlib.import_module(f"{pkg_name}.boundary.registry").boundary_condition_registry.reset()
        pkg.DefaultConfig.reset()
        vs = importlib.import_module(f"{pkg_name}.velocity_set").D2Q9()
        pkg.init(velocity_set=vs)
        idx = [[0, 1, 2], [5, 5, 5]]
        kind, _, variant = which.partition("-")
        if kind == "halfway":
            kw = {"moving": {"prescribed_value": (0.03, -0.01)}, "profile": {"profile": lambda: np.array([0.02, 0.01])}}
            bc = bnd.HalfwayBounceBackBC(indices=idx, **kw.get(variant, {}))
        else:
            cls = bnd.ZouHeBC if kind == "zouhe" else bnd.RegularizedBC
            value = (U_IN, 0.0) if variant == "velocity" else 1.01
            bc = cls(variant, prescribed_value=value, indices=idx)
        specs.append((jax_bc_to_spec if pkg_name == "xlb_tpu" else bc_to_spec)(bc, vs))
    a, b = specs
    assert a.keys() == b.keys()
    for key in a:
        if a[key] is None or isinstance(a[key], str):
            assert b[key] == a[key]
        else:
            np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(a[key]))
            assert np.asarray(b[key]).dtype == np.asarray(a[key]).dtype


def test_custom_initializer_momentum_transfer_and_units():
    """CustomInitializer's populations, MomentumTransfer's force on a
    perturbed cylinder state and omega_from_reynolds against xlb_tpu's
    (rtol 1e-6). The force is a global sum of O(0.1) terms that the two
    packages add in other orders; its lift component cancels to ~0.07, so
    it keeps a few float32 ulps of the terms (atol 1e-6)."""
    from xlb_tpu.ops import MomentumTransfer as JaxMomentumTransfer
    from xlb_tpu.utils import omega_from_reynolds as jax_omega, viscosity_from_omega as jax_nu

    from xlb_tpu_torch.ops import MomentumTransfer
    from xlb_tpu_torch.utils import omega_from_reynolds, viscosity_from_omega

    sj, (f0j, f1j, bmj, mmj), cyl_j = build_scene_2d("xlb_tpu", "cylinder-zouhe")
    st, (f0t, f1t, bmt, mmt), cyl_t = build_scene_2d("xlb_tpu_torch", "cylinder-zouhe")
    np.testing.assert_allclose(as_f32(f0t), as_f32(f0j), rtol=1e-6)
    f = _perturbed(f0j, seed=21)
    force_j = np.asarray(JaxMomentumTransfer(cyl_j)(jnp.asarray(f), jnp.asarray(f), bmj, mmj))
    force_t = MomentumTransfer(cyl_t)(_to_torch(f), _to_torch(f), bmt, mmt).numpy()
    assert force_t.shape == (2,) and abs(force_j[0]) > 0
    np.testing.assert_allclose(force_t, force_j, rtol=1e-6, atol=1e-6)
    for re, u, d in ((100.0, 0.04, 32), (1000.0, 0.1, 256)):
        assert omega_from_reynolds(re, u, d) == pytest.approx(jax_omega(re, u, d), rel=1e-6)
    assert viscosity_from_omega(1.6) == pytest.approx(jax_nu(1.6), rel=1e-6)


# ------------------------------------------------------- the TORCH tier --


@pytest.mark.parametrize("kind", ["halfway_cavity", "cylinder-regularized", "cylinder-zouhe"])
def test_torch_tier_20_steps_matches_jnp_tier(kind):
    """20 TORCH-tier steps against 20 jnp-tier steps from a seeded,
    perturbed state, FP32FP32 (rtol 1e-5, atol 1e-6: float32 reassociation
    over 20 steps)."""
    from xlb_tpu_torch.utils import fields_from_numpy

    u_wall = (0.01, 0.0) if kind == "halfway_cavity" else None
    sj, (f0j, _, bmj, mmj), _ = build_scene_2d("xlb_tpu", kind, u_wall=u_wall)
    st, (_, _, bmt, mmt), _ = build_scene_2d("xlb_tpu_torch", kind, u_wall=u_wall)
    f = _perturbed(f0j, seed=1)
    ref, _ = sj.build_multi_step(20, donate=False)(jnp.asarray(f), jnp.asarray(f), bmj, mmj, OMEGA)
    f_0, f_1, _, _ = fields_from_numpy(f, f, bmj, mmj, device="cpu")
    ours, _ = st.build_multi_step(20)(f_0, f_1, bmt, mmt, OMEGA)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- K3 and K4 --


@pytest.mark.parametrize("kind, store", [("halfway_cavity", "f32"), ("halfway_cavity", "bf16-shifted"),
                                         ("cylinder-zouhe", "f32"), ("cylinder-regularized", "bf16-shifted")])
def test_k3_plain_matches_interpret_mode_kernel(kind, store):
    """One step of K3's plain version against xlb_tpu's interpret-mode 2D
    kernel, with solids (the cylinder's interior, a block in the cavity)
    and a moving halfway wall in the cavity. f32: rtol 1e-6, atol 1e-7;
    bf16-shifted: the 8-ulp bound of test_fused_2d.py."""
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DStep

    jstore, _, shifted = STORES[store]
    (jvs, jspecs, fj, mj), (vs, specs, ft, mt) = _kernel_inputs(kind, store, seed=2, u_wall=(0.01, 0.0))
    ref = jax_k3(jvs, SHAPE, bc_specs=jspecs, store_dtype=jstore, tile_x=8, interpret=True, shifted=shifted,
                 has_solids=True)(fj, mj, OMEGA)
    calls = CollideStream2DStep.plain_calls
    ours = CollideStream2DStep(vs, SHAPE, bc_specs=specs, store_dtype=ft.dtype, shifted=shifted, has_solids=True)(ft, mt, OMEGA)
    assert CollideStream2DStep.plain_calls == calls + 1 and ours.dtype == ft.dtype
    if store == "f32":
        np.testing.assert_allclose(as_f32(ours), as_f32(ref), rtol=1e-6, atol=1e-7)
    else:
        _assert_8ulp(ours, ref, jstore)


@pytest.mark.parametrize("steps, store", [(2, "f32"), (8, "bf16-shifted")])
def test_k4_plain_matches_interpret_mode_kernel(steps, store):
    """K4's plain version (k single plain steps) against xlb_tpu's
    interpret-mode 2D k-step on the regularized cylinder, within the store
    dtype's 8-ulp bound."""
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep

    jstore, _, shifted = STORES[store]
    (jvs, jspecs, fj, mj), (vs, specs, ft, mt) = _kernel_inputs("cylinder-regularized", store, seed=3)
    ref = jax_k4(jvs, SHAPE, bc_specs=jspecs, store_dtype=jstore, tile_x=8, steps=steps, interpret=True,
                 shifted=shifted, has_solids=True)(fj, mj, OMEGA)
    ours = CollideStream2DKStep(vs, SHAPE, bc_specs=specs, store_dtype=ft.dtype, shifted=shifted, has_solids=True,
                                steps=steps)(ft, mt, OMEGA)
    _assert_8ulp(ours, ref, jstore)


def test_cuda_tier_window_fp32bf16_matches_xlb_tpu_window():
    """build_multi_step(16) of the CUDA tier's window (two K4 calls at the
    default k = 8, plain versions here) on the mlups_2d.py cavity under
    FP32BF16 against xlb_tpu's interpret-mode fused window, within the bf16
    8-ulp bound."""
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep
    from xlb_tpu_torch.kernels.fused_step import build_fused_window
    from xlb_tpu_torch.utils import fields_from_numpy

    shape = (16, 16)
    sj, (f0j, _, bmj, mmj), _ = build_scene_2d("xlb_tpu", "cavity", shape, "FP32BF16")
    st, (_, _, bmt, mmt), _ = build_scene_2d("xlb_tpu_torch", "cavity", shape, "FP32BF16")
    rng = np.random.default_rng(4)
    f = (np.asarray(f0j).astype(np.float32) * (1.0 + 0.05 * rng.standard_normal((9,) + shape))).astype(np.float32)
    fj = jnp.asarray(f, dtype=jnp.bfloat16)
    ref, _ = jax_build_fused_window(sj, 16, interpret=True)(fj, fj, bmj, mmj, OMEGA)
    f_0, f_1, _, _ = fields_from_numpy(np.asarray(fj), np.asarray(fj), bmj, mmj, device="cpu")
    calls = CollideStream2DKStep.plain_calls
    ours, _ = build_fused_window(st, 16)(f_0, f_1, bmt, mmt, OMEGA)
    assert CollideStream2DKStep.plain_calls == calls + 2
    _assert_8ulp(ours, ref, jnp.bfloat16)


# ------------------------------------------------------------- gradients --


@pytest.mark.parametrize("kind", ["halfway_cavity", "cylinder-regularized"])
def test_cuda_tier_step_gradient_matches_jax_grad(kind):
    """grad of sum(out**2) through the CUDA tier's 2D stepper(...) (forward
    K3, plain here; backward torch.func.vjp of the TORCH-tier step) against
    jax.grad through xlb_tpu's jnp tier, FP32FP32. omega's cotangent is a
    cancelling sum over every voxel (rtol 2e-2, as test_fused_kernel.py)."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DStep
    from xlb_tpu_torch.kernels.fused_step import build_fused_step

    u_wall = (0.01, 0.0) if kind == "halfway_cavity" else None
    sj, (f0j, _, bmj, mmj), _ = build_scene_2d("xlb_tpu", kind, u_wall=u_wall)
    st, (_, _, bmt, mmt), _ = build_scene_2d("xlb_tpu_torch", kind, u_wall=u_wall)
    f = _perturbed(f0j, seed=5)
    gf_j, go_j = jax.grad(lambda f, om: jnp.sum(sj(f, f, bmj, mmj, om, 0)[1] ** 2), argnums=(0, 1))(
        jnp.asarray(f), jnp.float32(OMEGA))

    step = build_fused_step(st)
    ft = _to_torch(f).requires_grad_(True)
    om = torch.tensor(OMEGA, requires_grad=True)
    calls = CollideStream2DStep.plain_calls
    (step(ft, ft, bmt, mmt, om, 0)[1] ** 2).sum().backward()
    assert CollideStream2DStep.plain_calls == calls + 1  # the forward ran K3
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(gf_j), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(om.grad), float(go_j), rtol=2e-2, atol=1e-5)


def test_cuda_tier_2d_window_refuses_autograd():
    """xlb_tpu's 2D window has no backward; the port's raises under
    autograd and names the TORCH tier, and runs when nothing needs a
    gradient."""
    import torch

    from xlb_tpu_torch.kernels.fused_step import build_fused_window

    st, (f_0, f_1, bm, mm), _ = build_scene_2d("xlb_tpu_torch", "cavity", (16, 16))
    run = build_fused_window(st, 3)
    with pytest.raises(NotImplementedError, match="ComputeBackend.TORCH"):
        run(f_0.clone().requires_grad_(True), f_1, bm, mm, OMEGA)
    with pytest.raises(NotImplementedError, match="ComputeBackend.TORCH"):
        run(f_0, f_1, bm, mm, torch.tensor(OMEGA, requires_grad=True))
    with torch.no_grad():
        out, _ = run(f_0.clone().requires_grad_(True), f_1, bm, mm, OMEGA)
    assert out.shape == f_0.shape and not out.requires_grad
