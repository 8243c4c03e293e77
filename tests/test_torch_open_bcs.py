"""The 3D open-boundary path of the port against xlb_tpu, on the CPU.

Scenes: the BC sets of ``chip_smoke.open_bcs`` at 32x16x16 --
flow_past_sphere_3d.py's (a parabolic regularized inlet through the aux
field, the extrapolation outflow, halfway walls and a halfway mesh sphere;
D3Q19 BGK; also with its uniform inlet), rotating_sphere_3d.py's (an
equilibrium inlet, the outflow, fullway walls, a halfway sphere with a
spatial wall velocity; D3Q27 KBC), and a D3Q19 scene of a Zou-He velocity
inlet, a Zou-He pressure outlet whose density varies over the face,
free-slip walls and a do-nothing piece.

- (a) ``sphere_triangles`` and ``voxelize`` (native and NumPy) give
  xlb_tpu's triangles and solid voxels, and a mesh BC xlb_tpu's masks;
- (b) ``build_aux_field`` equals xlb_tpu's channel for channel (bit for
  bit: both evaluate the same float64 prescriptions and round once);
- (c) 20 TORCH-tier steps against 20 of xlb_tpu's jnp tier, rtol 1e-5,
  atol 1e-6 (``test_torch_nse.py``'s bound), from a seeded perturbed state;
- (d) the plain versions of K1 (``stepper(...)``'s fused step), of the
  window (K2 at k = 2 and K1) and of K0, 3 steps, against the jnp tier,
  rtol 1e-5, atol 5e-6 (``test_torch_many_bcs.py``'s); the bf16-shifted
  window against xlb_tpu's FP32BF16 jnp tier within 8 bf16 ulps;
- (e) the plain step against one interpret-mode call of xlb_tpu's K1 on the
  flow-past-sphere scene, which pins the outflow's staging (5e-6, as
  ``test_torch_collisions.py``'s interpret-mode checks);
- (f) the torch forms of the three scripts at nx=32, nyz=16, 60 steps on
  the TORCH tier against xlb_tpu's ``run()`` (rtol 1e-4: 60 steps of
  float32 roundoff, and the drag a sum over the sphere);
- (g) guards: a mesh HybridBC gets its distances at prepare_fields, and
  autograd through the CUDA tier's step and window differentiates it and
  the open-boundary BCs (test_torch_open_adjoint.py holds the gradients
  against xlb_tpu's); the pairs without a kExtOpen instantiation raise, in
  K1 and K8, and a scene with per-voxel prescriptions needs its aux field;
  the geometry modules stay under the no-JAX guard.
  (``tests/test_torch_gpu.py``, which imports no JAX, holds K1, K2, K0
  and K8 against their plain versions on the open scenes on the card.)

(torch is imported inside the tests; test_torch_setup.py says why.)
"""

import functools
import importlib
import pathlib

import jax
import numpy as np
import pytest

from chip_smoke import OPEN_SCENES, open_bcs
from tests.test_torch_collisions import _init, _macroscopic_fields
from tests.test_torch_setup import as_f32, reset_port_state

SHAPE = (32, 16, 16)
OMEGA = 1.6
KINDS = ("sphere", "sphere-uniform", "rotating", "zouhe")


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def open_scene(pkg_name, kind, shape=SHAPE, policy="FP32FP32", seed=0, perturb=True):
    """(stepper, (f_0, f_1, bc_mask, missing_mask)) of an open_bcs scene on
    the CPU in either package; "sphere-uniform" swaps the parabolic inlet
    for a uniform one. f_0 is the equilibrium of seeded (rho, u) fields
    (``perturb``) or the rest state."""
    base = kind.split("-")[0]
    vs_name, collision = OPEN_SCENES[base]
    pkg = _init(pkg_name, int(vs_name[3:]), policy)
    bnd = importlib.import_module(f"{pkg_name}.boundary")
    geo = importlib.import_module(f"{pkg_name}.geometry")
    models = importlib.import_module(f"{pkg_name}.models")
    if pkg_name == "xlb_tpu":
        grid = pkg.grid_factory(shape, mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    else:
        grid = pkg.grid_factory(shape, device="cpu")
    bcs = open_bcs(base, grid, bnd, geo)
    if kind == "sphere-uniform":
        bcs[1] = bnd.RegularizedBC("velocity", prescribed_value=(0.04, 0.0, 0.0),
                                   indices=grid.bounding_box_indices(remove_edges=True)["left"])
    stepper = models.IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type=collision)
    f_0, f_1, bc_mask, missing_mask = stepper.prepare_fields()
    if perturb:
        init_mac = importlib.import_module(f"{pkg_name}.helper.initializers").initialize_from_macroscopic
        rho, u = _macroscopic_fields(shape, seed)
        f_0 = init_mac(grid, stepper.velocity_set, stepper.precision_policy, rho, u)
    return stepper, (f_0, f_1, bc_mask, missing_mask)


@functools.cache
def cached_scene(pkg_name, kind, shape=SHAPE, policy="FP32FP32"):
    """``open_scene``, built once per test process for the tests that only
    read it."""
    return open_scene(pkg_name, kind, shape, policy)


@functools.cache
def jnp_reference(kind, n, policy="FP32FP32"):
    """n steps of xlb_tpu's jnp tier from the scene's state (one jitted
    window), built once per test process."""
    sj, fj = cached_scene("xlb_tpu", kind, SHAPE, policy)
    return _jnp_window(sj, fj, n)


def _steps(step, fields, n):
    f_0, f_1, bc_mask, missing_mask = fields
    for t in range(n):
        f_0, f_1 = step(f_0, f_1, bc_mask, missing_mask, OMEGA, t)
        f_0, f_1 = f_1, f_0
    return f_0


def _jnp_window(stepper, fields, n):
    return stepper.build_multi_step(n, donate=False)(*fields, OMEGA)[0]


def test_sphere_voxelization_matches_xlb_tpu():
    """(a) The same triangles, the same solid voxels (the native voxelizer
    and the NumPy ray fill), and through a mesh BC the same masks."""
    from xlb_tpu import geometry as jgeo
    from xlb_tpu.geometry.voxelize import _ray_crossings_z as jax_ray
    from xlb_tpu_torch import geometry as tgeo
    from xlb_tpu_torch.geometry.voxelize import _ray_crossings_z

    kw = dict(center=(8.0, 8.0, 8.0), radius=2.0 * 16 / 8, subdivisions=3)
    tris = tgeo.sphere_triangles(**kw)
    np.testing.assert_array_equal(tris, jgeo.sphere_triangles(**kw))
    solid = tgeo.voxelize(tris, SHAPE)
    assert solid.sum() > 0
    np.testing.assert_array_equal(solid, jgeo.voxelize(tris, SHAPE))
    np.testing.assert_array_equal(_ray_crossings_z(tris, SHAPE, np.zeros(3), 1.0),
                                  jax_ray(tris, SHAPE, np.zeros(3), 1.0))
    np.testing.assert_array_equal(tgeo.solid_voxel_indices(solid), jgeo.solid_voxel_indices(solid))
    sj, fj = open_scene("xlb_tpu", "sphere", perturb=False)
    st, ft = open_scene("xlb_tpu_torch", "sphere", perturb=False)
    np.testing.assert_array_equal(np.asarray(st.boundary_conditions[3].indices), np.asarray(sj.boundary_conditions[3].indices))
    for a, b in zip(ft[2:], fj[2:]):
        np.testing.assert_array_equal(as_f32(a), as_f32(b))
    src = pathlib.Path(tgeo.__file__).parent / "native" / "voxelizer.cpp"
    assert src.read_bytes() == (pathlib.Path(jgeo.__file__).parent / "native" / "voxelizer.cpp").read_bytes()


@pytest.mark.parametrize("kind", ["sphere", "zouhe", "rotating"])
def test_aux_field_matches_xlb_tpu(kind):
    """(b) The parabolic inlet's velocities, the spatial pressure outlet's
    densities (1 off the BC), the rotating wall's velocities on its
    dilated shell. The port's plain K1 step from xlb_tpu's state, masks
    and aux field (carried as NumPy arrays) equals its step from its own."""
    from xlb_tpu.kernels.fused_step import build_aux_field as jax_build_aux_field
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, build_aux_field, pack_masks
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.utils import aux_from_numpy, fields_from_numpy

    sj, fj = cached_scene("xlb_tpu", kind)
    st, ft = cached_scene("xlb_tpu_torch", kind)
    ours, ref = build_aux_field(st), jax_build_aux_field(sj)
    assert ours.shape == ref.shape == ((1 if kind == "zouhe" else 3),) + SHAPE
    np.testing.assert_array_equal(ours, ref)
    assert np.count_nonzero(ours - (1.0 if kind == "zouhe" else 0.0)) > 0
    step = CollideStreamStep(st.velocity_set, SHAPE, collision=OPEN_SCENES[kind][1], has_solids=st.has_solids,
                             bc_specs=[bc_to_spec(b, st.velocity_set) for b in st.boundary_conditions])
    f_0, _, bc_mask, missing_mask = fields_from_numpy(*(np.asarray(x) for x in fj), device="cpu")
    carried = step(f_0, pack_masks(bc_mask, missing_mask), OMEGA, aux_from_numpy(ref, device="cpu"))
    own = step(ft[0], pack_masks(ft[2], ft[3]), OMEGA, aux_from_numpy(ours, device="cpu"))
    np.testing.assert_allclose(carried.numpy(), own.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", KINDS)
def test_torch_tier_matches_jnp_tier(kind):
    """(c) 20 TORCH-tier steps of stepper(...) against xlb_tpu's jnp tier."""
    ref = as_f32(jnp_reference(kind, 20))
    st, ft = cached_scene("xlb_tpu_torch", kind)
    np.testing.assert_allclose(as_f32(_steps(st, ft, 20)), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_kernels_match_jnp_tier(kind):
    """(d) The plain K1 step, the plain window (K2 at k = 2, then K1) and
    the plain K0 step, 3 steps each, against the jnp tier; the window's
    launches go through K2 and K1's wrappers."""
    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import build_fused_step, build_fused_window

    ref = as_f32(jnp_reference(kind, 3))
    st, ft = cached_scene("xlb_tpu_torch", kind)
    for step in (build_fused_step(st), build_fused_step(st, kernel="blocked")):
        np.testing.assert_allclose(as_f32(_steps(step, ft, 3)), ref, rtol=1e-5, atol=5e-6)
    calls = (CollideStreamKStep.plain_calls, CollideStreamStep.plain_calls)
    out, _ = build_fused_window(st, 3)(*ft, OMEGA)
    np.testing.assert_allclose(as_f32(out), ref, rtol=1e-5, atol=5e-6)
    assert (CollideStreamKStep.plain_calls, CollideStreamStep.plain_calls) == (calls[0] + 1, calls[1] + 1)


@pytest.mark.parametrize("kind", ["sphere", "rotating"])
def test_bf16_shifted_window_matches_jnp_tier(kind):
    """(d) The window under FP32BF16 (bf16 deviation form; the plain K2 at
    k = 2), 2 steps, against xlb_tpu's FP32BF16 jnp tier within 8 bf16
    ulps."""
    import jax.numpy as jnp

    from xlb_tpu_torch.kernels.fused_step import build_fused_window

    ref = jnp_reference(kind, 2, "FP32BF16")
    st, ft = cached_scene("xlb_tpu_torch", kind, SHAPE, "FP32BF16")
    out, _ = build_fused_window(st, 2)(*ft, OMEGA)
    eps = float(jnp.finfo(jnp.bfloat16).eps)
    np.testing.assert_allclose(as_f32(out), as_f32(ref), rtol=8 * eps, atol=8 * eps * 0.05)


def test_plain_step_matches_interpret_mode_k1_on_an_outflow():
    """(e) One interpret-mode call of xlb_tpu's K1 (its staging reads the
    tangential halo neighbours) on the flow past a sphere at 16x16x128
    (xlb_tpu's K1 takes z extents of 128-multiples)."""
    from xlb_tpu.kernels.fused_step import build_fused_step as jax_build_fused_step
    from xlb_tpu_torch.kernels.fused_step import build_fused_step

    shape = (16, 16, 128)
    sj, fj = open_scene("xlb_tpu", "sphere", shape)
    ref = as_f32(_steps(jax_build_fused_step(sj, interpret=True), fj, 1))
    st, ft = open_scene("xlb_tpu_torch", "sphere", shape)
    out = as_f32(_steps(build_fused_step(st), ft, 1))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=5e-6)


SCRIPTS = [("flow_past_sphere_3d", {}), ("flow_past_sphere_3d", {"inlet": "uniform"}),
           ("windtunnel_3d", {"print_every": 20}), ("rotating_sphere_3d", {})]


@pytest.mark.parametrize("name,extra", SCRIPTS)
def test_script_torch_forms_match_xlb_tpu(name, extra):
    """(f) Each torch form's run() on the TORCH tier against the script's
    own run() (velocity field, drag history or Magnus asymmetry)."""
    kw = dict(nx=32, nyz=16, num_steps=60, **extra)
    ref = np.asarray(importlib.import_module(f"examples.cfd.{name}").run(**kw), dtype=np.float64)
    reset_port_state()
    ours = importlib.import_module(f"xlb_tpu_torch.examples.cfd.{name}").run(backend="torch", device="cpu", **kw)
    ours = np.asarray(ours, dtype=np.float64)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6 if name != "windtunnel_3d" else 0.0)


def test_hybrid_and_mesh_distances_raise():
    """(g) Around the curved walls: the adjoint kernel K8 takes a hybrid BC
    and autograd through a CUDA-tier step (kernel="dma" and "blocked") or
    window with one gives finite gradients, K8 once per step; a BC with
    neither indices nor a mesh raises. A mesh HybridBC gets its wall
    distances at prepare_fields."""
    import xlb_tpu_torch
    from xlb_tpu_torch import boundary
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec

    st, _ = open_scene("xlb_tpu_torch", "sphere", perturb=False)
    bcs = list(st.boundary_conditions)
    bcs[3] = boundary.HybridBC(bc_method="bounceback", mesh_vertices=bcs[3].mesh_vertices)
    stepper = xlb_tpu_torch.models.IncompressibleNavierStokesStepper(st.grid, boundary_conditions=bcs)
    f_0, f_1, bc_mask, missing_mask = stepper.prepare_fields()
    assert bcs[3]._distances is not None and np.isfinite(bcs[3]._distances).any()
    specs = [bc_to_spec(b, stepper.velocity_set) for b in bcs]
    assert CollideStreamAdjoint(stepper.velocity_set, SHAPE, bc_specs=specs).params.walled == 3
    _differentiates(stepper, (f_0, f_1, bc_mask, missing_mask))
    bare = boundary.HalfwayBounceBackBC()
    with pytest.raises(ValueError, match="neither indices nor mesh_vertices"):
        xlb_tpu_torch.models.IncompressibleNavierStokesStepper(st.grid, boundary_conditions=[bare]).prepare_fields()


def _differentiates(stepper, fields):
    """Autograd through the CUDA tier's step (kernel="dma": K8 once;
    "blocked": the TORCH tier's VJP) and its 2-step window (K8 twice) of an
    open or hybrid scene (plain versions here): finite gradients of f_0 and
    omega, nothing raises."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.fused_step import build_fused_step, build_fused_window

    f_0, f_1, bc_mask, missing_mask = fields
    window = build_fused_window(stepper, 2)
    for run, k8 in ((build_fused_step(stepper), 1), (build_fused_step(stepper, kernel="blocked"), 0),
                    (lambda f, f_1, bm, mm, om: (None, window(f, f_1, bm, mm, om)[0]), 2)):
        f = f_0.clone().requires_grad_(True)
        om = torch.tensor(OMEGA, requires_grad=True)
        calls = CollideStreamAdjoint.plain_calls
        (run(f, f_1, bc_mask, missing_mask, om)[1].float() ** 2).sum().backward()
        assert CollideStreamAdjoint.plain_calls == calls + k8
        assert bool(torch.isfinite(f.grad).all()) and f.grad.abs().max() > 0 and bool(torch.isfinite(om.grad))


def test_cuda_tier_refuses_what_it_lacks():
    """(g) Autograd through a fused step or window with open-boundary BCs
    differentiates, for kernel="dma" (K8) and "blocked" (the TORCH tier's
    VJP); what still refuses: a (stencil, collision) pair without a
    kExtOpen instantiation raises at construction, in K1 and K8, and a
    scene with a per-voxel prescription needs its aux field, in K1 and
    K8."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec

    st, fields = cached_scene("xlb_tpu_torch", "sphere")
    _differentiates(st, fields)
    f_0 = fields[0]
    specs = [bc_to_spec(b, st.velocity_set) for b in st.boundary_conditions]
    assert CollideStreamAdjoint(st.velocity_set, SHAPE, bc_specs=specs).params.walled == 2
    for cls in (CollideStreamStep, CollideStreamAdjoint):
        for collision in ("TRT", ("MRT", {"fixed": [], "bulk_rate": None, "ghost_rate": None})):
            with pytest.raises(NotImplementedError, match="D3Q19 BGK and D3Q27 KBC"):
                cls(st.velocity_set, SHAPE, collision=collision, bc_specs=specs)
    mask = torch.zeros(SHAPE, dtype=torch.int32)
    with pytest.raises(ValueError, match="aux field"):
        CollideStreamStep(st.velocity_set, SHAPE, bc_specs=specs)(f_0, mask, OMEGA)
    with pytest.raises(ValueError, match="aux field"):
        CollideStreamAdjoint(st.velocity_set, SHAPE, bc_specs=specs)(f_0, torch.zeros_like(f_0), mask, OMEGA)


def test_no_jax_guard_covers_the_open_boundary_modules():
    from tests.test_torch_guards import PACKAGE

    scanned = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert {"boundary/bc_do_nothing.py", "boundary/bc_free_slip.py", "boundary/bc_extrapolation_outflow.py",
            "geometry/stl.py", "geometry/voxelize.py", "geometry/mesh_masker.py", "geometry/native/__init__.py",
            "examples/cfd/flow_past_sphere_3d.py", "examples/cfd/windtunnel_3d.py",
            "examples/cfd/rotating_sphere_3d.py"} <= scanned
