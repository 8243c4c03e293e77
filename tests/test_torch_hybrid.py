"""The curved-wall (HybridBC) path of the port against xlb_tpu, on the CPU.

Scenes: the tunnels of ``chip_smoke.hybrid_bcs`` at 24x16x16 -- a hybrid
mesh sphere of radius 3.2 in xlb_tpu's tests/kernels/test_fused_hybrid.py
tunnel (fullway walls, equilibrium inlet; D3Q19 BGK) or in
sphere_drag_validation.py's (free-slip walls, regularized inlet and
outlet; D3Q19 BGK and D3Q27 KBC), with and without wall distances, with a static or a
per-voxel (spinning) wall; and the Schafer-Turek benchmark's torch form at
D = 8 (177x34, D2Q9 BGK, the parabolic inlet through the aux field).

- (a) ``geometry.distances`` against xlb_tpu's, exact in float64 (ray
  hits, a sphere's directional distances natively and in NumPy,
  ``implicit_link_distances``); the WINDING voxelization's pruning to
  ``winding_candidates`` gives xlb_tpu's voxels;
- (b) ``HybridBC.__call__`` (four methods) and ``build_aux_field``
  (channel for channel, bit for bit) against xlb_tpu's;
- (c) TORCH-tier steps and the plain K1 step, window (K2 at k = 2, then K1)
  and K0 step against xlb_tpu's jnp tier, rtol 1e-5 / atol 5e-6
  (``test_torch_open_bcs.py``'s bound); the bf16-shifted window within 8
  bf16 ulps; the Schafer-Turek scene's plain K3 steps and K4 window, 50
  steps, the same way;
- (d) guards: K8 takes hybrid (its kExtHybrid form) and the 3D hybrid
  step and window differentiate on the CUDA tier (test_torch_open_adjoint.py
  holds their gradients against xlb_tpu's); a hybrid BC on a (stencil,
  collision) pair without the kExtHybrid instantiation raises, in K1 and
  K8; the 2D kernels refuse the outflow, free-slip and do-nothing.

(torch is imported inside the tests; test_torch_setup.py says why.)
"""

import functools
import importlib

import jax
import numpy as np
import pytest

from chip_smoke import hybrid_bcs
from tests.test_torch_collisions import _init, _macroscopic_fields
from tests.test_torch_setup import as_f32, reset_port_state

SHAPE = (24, 16, 16)
OMEGA = 1.5
RTOL, ATOL = 1e-5, 5e-6


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def hybrid_scene(pkg_name, method, use_dist=True, wall=None, tunnel="closed", q=19, policy="FP32FP32",
                 collision="BGK", seed=0):
    """(stepper, (f_0, f_1, bc_mask, missing_mask)) of a hybrid_bcs tunnel
    on the CPU in either package; f_0 the equilibrium of seeded (rho, u)."""
    pkg = _init(pkg_name, q, policy)
    bnd = importlib.import_module(f"{pkg_name}.boundary")
    geo = importlib.import_module(f"{pkg_name}.geometry")
    models = importlib.import_module(f"{pkg_name}.models")
    if pkg_name == "xlb_tpu":
        grid = pkg.grid_factory(SHAPE, mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    else:
        grid = pkg.grid_factory(SHAPE, device="cpu")
    bcs = hybrid_bcs(grid, bnd, geo, method, use_dist, wall, tunnel)
    stepper = models.IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type=collision)
    f_0, f_1, bc_mask, missing_mask = stepper.prepare_fields()
    init_mac = importlib.import_module(f"{pkg_name}.helper.initializers").initialize_from_macroscopic
    rho, u = _macroscopic_fields(SHAPE, seed)
    f_0 = init_mac(grid, stepper.velocity_set, stepper.precision_policy, rho, 0.5 * u)
    return stepper, (f_0, f_1, bc_mask, missing_mask)


@functools.cache
def cached_scene(pkg_name, method, use_dist=True, wall=None, tunnel="closed", q=19, policy="FP32FP32",
                 collision="BGK"):
    """``hybrid_scene``, built once per test process for the tests that
    only read it."""
    return hybrid_scene(pkg_name, method, use_dist, wall, tunnel, q, policy, collision)


@functools.cache
def jnp_reference(scene, n):
    """n steps of xlb_tpu's jnp tier on a SCENES tunnel from its state (one
    jitted window), built once per test process."""
    method, use_dist, wall, tunnel, q, collision = scene
    sj, fj = cached_scene("xlb_tpu", method, use_dist, wall, tunnel, q, collision=collision)
    return sj.build_multi_step(n, donate=False)(*fj, OMEGA)[0]


def _steps(step, fields, n, omega=OMEGA):
    f_0, f_1, bc_mask, missing_mask = fields
    for t in range(n):
        f_0, f_1 = step(f_0, f_1, bc_mask, missing_mask, omega, t)
        f_0, f_1 = f_1, f_0
    return f_0


# (method, use_dist, wall, tunnel, q, collision)
SCENES = [("bounceback", True, None, "closed", 19, "BGK"),
          ("bounceback_regularized", True, None, "closed", 19, "BGK"),
          ("bounceback_grads", True, None, "closed", 19, "BGK"),
          ("nonequilibrium_regularized", True, None, "closed", 19, "BGK"),
          ("bounceback_regularized", False, "static", "closed", 19, "BGK"),
          ("nonequilibrium_regularized", False, "static", "closed", 19, "BGK"),
          ("bounceback_regularized", True, "spin", "closed", 19, "BGK"),
          ("nonequilibrium_regularized", True, "spin", "open", 27, "KBC"),
          ("bounceback_grads", False, None, "open", 19, "BGK")]
IDS = [f"{m}-{'dist' if d else 'half'}-{w}-{t}-q{q}" for m, d, w, t, q, _ in SCENES]


def test_distances_match_xlb_tpu():
    """(a) Ray hits, a sphere's directional distances (native sweep and
    NumPy) and a circle's implicit link distances, exact in float64; the
    WINDING voxelization over winding_candidates equals xlb_tpu's full one."""
    from xlb_tpu.geometry import distances as jd
    from xlb_tpu.geometry import voxelize as jvox
    from xlb_tpu_torch.geometry import MeshVoxelizationMethod, distances, load_stl, sphere_triangles, transform_mesh
    from xlb_tpu_torch.geometry import voxelize
    from xlb_tpu_torch.geometry.native import directional_distances_native
    from xlb_tpu_torch.velocity_set import D2Q9, D3Q19

    tris = sphere_triangles(center=(8.0, 8.0, 8.0), radius=3.2, subdivisions=2)
    rng = np.random.default_rng(3)
    origins = rng.uniform(3.0, 13.0, (40, 3))
    np.testing.assert_array_equal(distances.ray_triangle_hits(origins, (0.6, 0.0, 0.8), tris),
                                  jd.ray_triangle_hits(origins, (0.6, 0.0, 0.8), tris))
    vox = np.array(np.nonzero(np.ones((16, 16, 16), bool)))[:, ::7].astype(np.float64)
    c = D3Q19()._c
    ref = jd.directional_wall_distances(tris, vox, c)
    np.testing.assert_array_equal(distances.directional_wall_distances(tris, vox, c), ref)
    native = directional_distances_native(tris, vox, c)
    assert native is not None and np.isfinite(ref).any()
    np.testing.assert_array_equal(native, ref)
    numpy_path = np.stack([distances.ray_triangle_hits(vox.T, c[:, l] / max(np.linalg.norm(c[:, l]), 1.0), tris)
                           / max(np.linalg.norm(c[:, l]), 1.0) for l in range(1, c.shape[1])])
    np.testing.assert_allclose(numpy_path, ref[1:], rtol=1e-12)

    def inside(p):
        return (p[:, 0] - 7.3) ** 2 + (p[:, 1] - 6.1) ** 2 <= 9.0

    pts = np.array(np.nonzero(np.ones((14, 12), bool))).astype(np.float64)
    pts = pts[:, ~inside(pts.T)]
    np.testing.assert_array_equal(distances.implicit_link_distances(inside, pts, D2Q9()._c),
                                  jd.implicit_link_distances(inside, pts, D2Q9()._c))

    d = 4
    ball = transform_mesh(load_stl("examples/cfd/data/sphere_nonwatertight.stl"), scale=d / 2.0,
                          translation=np.array([3.5 * d, 3.0 * d, 3.0 * d]))
    shape = (12 * d, 6 * d, 6 * d)
    solid = voxelize(ball, shape, method=MeshVoxelizationMethod.WINDING)
    assert solid.sum() > 0
    np.testing.assert_array_equal(solid, jvox(ball, shape, method=importlib.import_module(
        "xlb_tpu.geometry.voxelize").MeshVoxelizationMethod.WINDING))


@functools.cache
def _spinning_scenes():
    """The closed tunnel with a spinning hybrid sphere in both packages,
    built once for the four methods' calls."""
    return hybrid_scene("xlb_tpu", "bounceback", wall="spin"), hybrid_scene("xlb_tpu_torch", "bounceback", wall="spin")


@pytest.mark.parametrize("method", ["bounceback", "bounceback_regularized", "bounceback_grads",
                                    "nonequilibrium_regularized"])
def test_hybrid_call_matches_xlb_tpu(method):
    """(b) One HybridBC.__call__ (distances and a spinning wall) on seeded
    populations against xlb_tpu's, and the aux field channel for channel."""
    import torch

    from xlb_tpu.kernels.fused_step import build_aux_field as jax_build_aux_field
    from xlb_tpu_torch.kernels.fused_step import build_aux_field

    (sj, fj), (st, ft) = _spinning_scenes()
    for stepper in (sj, st):  # both BCs read their method at the call
        stepper.boundary_conditions[-1].bc_method = method
    rng = np.random.default_rng(5)
    f_pre = (as_f32(fj[0]) * (1.0 + 0.05 * rng.standard_normal(as_f32(fj[0]).shape))).astype(np.float32)
    f_post = (as_f32(fj[0]) * (1.0 + 0.05 * rng.standard_normal(f_pre.shape))).astype(np.float32)
    ref = as_f32(sj.boundary_conditions[-1](jax.numpy.asarray(f_pre), jax.numpy.asarray(f_post), fj[2], fj[3]))
    ours = st.boundary_conditions[-1](torch.from_numpy(f_pre), torch.from_numpy(f_post), ft[2], ft[3])
    np.testing.assert_allclose(as_f32(ours), ref, rtol=RTOL, atol=ATOL)
    assert np.abs(ref - f_post).max() > 1e-4  # the BC acted
    ours, ref = build_aux_field(st), jax_build_aux_field(sj)
    assert ours.shape == ref.shape == (3 + 19,) + SHAPE
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("scene", SCENES, ids=IDS)
def test_torch_tier_and_plain_kernels_match_jnp_tier(scene):
    """(c) 3 steps of the TORCH tier, the plain K1 step (stepper(...)'s
    fused step), the plain window (K2 at k = 2, then K1) and the plain K0
    step against xlb_tpu's jnp tier."""
    from xlb_tpu_torch.kernels.fused_step import build_fused_step, build_fused_window

    method, use_dist, wall, tunnel, q, collision = scene
    ref = as_f32(jnp_reference(scene, 3))
    st, ft = cached_scene("xlb_tpu_torch", method, use_dist, wall, tunnel, q, collision=collision)
    assert (st.boundary_conditions[-1]._distances is not None) == use_dist
    steps = (st, build_fused_step(st)) + ((build_fused_step(st, kernel="blocked"),) if tunnel == "closed" else ())
    for step in steps:  # K0's plain version is K1's: its wrapper on the closed tunnels
        np.testing.assert_allclose(as_f32(_steps(step, ft, 3)), ref, rtol=RTOL, atol=ATOL)
    out, _ = build_fused_window(st, 3)(*ft, OMEGA)
    np.testing.assert_allclose(as_f32(out), ref, rtol=RTOL, atol=ATOL)


def test_bf16_shifted_window_matches_jnp_tier():
    """(c) The window under FP32BF16 (bf16 deviation form through the plain
    K2), 2 steps, against xlb_tpu's FP32BF16 jnp tier within 8 bf16 ulps."""
    import jax.numpy as jnp

    from xlb_tpu_torch.kernels.fused_step import build_fused_window

    sj, fj = hybrid_scene("xlb_tpu", "bounceback_regularized", policy="FP32BF16")
    ref = sj.build_multi_step(2, donate=False)(*fj, OMEGA)[0]
    st, ft = hybrid_scene("xlb_tpu_torch", "bounceback_regularized", policy="FP32BF16")
    out, _ = build_fused_window(st, 2)(*ft, OMEGA)
    eps = float(jnp.finfo(jnp.bfloat16).eps)
    np.testing.assert_allclose(as_f32(out), as_f32(ref), rtol=8 * eps, atol=8 * eps * 0.05)


def schafer_turek_jax(d):
    """(stepper, prepare_fields(), omega) of the benchmark's scene at
    diameter d in xlb_tpu, built by the torch form's package-neutral
    ``schafer_turek_bcs``."""
    import xlb_tpu
    from xlb_tpu import boundary
    from xlb_tpu.geometry.distances import implicit_link_distances
    from xlb_tpu.helper.initializers import CustomInitializer
    from xlb_tpu.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.examples.cfd.cylinder_benchmark_schafer_turek import geometry, schafer_turek_bcs

    _init("xlb_tpu", 9)
    nx, ny, _, _ = geometry(d)
    grid = xlb_tpu.grid_factory((nx, ny), mesh_shape=(1, 1), devices=jax.devices()[:1])
    stepper = IncompressibleNavierStokesStepper(grid, schafer_turek_bcs(grid, boundary, implicit_link_distances, d))
    fields = stepper.prepare_fields(initializer=CustomInitializer(rho_0=1.0, u_0=(0.035, 0.0)))
    return stepper, fields, 1.0 / (3.0 * 0.035 * d / 100.0 + 0.5)


def test_schafer_turek_plain_2d_kernels_match_jnp_tier():
    """(c) The Schafer-Turek torch form's build(d=8): 50 steps of the
    TORCH tier, of the plain K3 step and of the plain window (K4 at k = 8
    and K3), against xlb_tpu's jnp tier; its aux field (the parabolic inlet
    and the cylinder's weights) against xlb_tpu's."""
    from xlb_tpu.kernels.fused_step import build_aux_field as jax_build_aux_field
    from xlb_tpu_torch.examples.cfd.cylinder_benchmark_schafer_turek import build
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep, CollideStream2DStep
    from xlb_tpu_torch.kernels.fused_step import build_aux_field, build_fused_step, build_fused_window

    sj, fj, omega = schafer_turek_jax(8)
    ref = as_f32(sj.build_multi_step(50, donate=False)(*fj, omega)[0])
    reset_port_state()
    st, fields, omega, _ = build(d=8, backend="torch", device="cpu")
    np.testing.assert_array_equal(build_aux_field(st), jax_build_aux_field(sj))
    for step in (st, build_fused_step(st)):
        np.testing.assert_allclose(as_f32(_steps(step, fields, 50, omega)), ref, rtol=RTOL, atol=ATOL)
    calls = (CollideStream2DKStep.plain_calls, CollideStream2DStep.plain_calls)
    out, _ = build_fused_window(st, 50)(*fields, omega)
    np.testing.assert_allclose(as_f32(out), ref, rtol=RTOL, atol=ATOL)
    assert (CollideStream2DKStep.plain_calls, CollideStream2DStep.plain_calls) == (calls[0] + 6, calls[1] + 2)


def test_force_history_of_the_torch_form():
    """(c) The torch form's force_history (stepper(...) and MomentumTransfer
    through the HybridBC after every step) against the same loop in
    xlb_tpu, 10 steps at D = 8."""
    from xlb_tpu.ops import MomentumTransfer as JaxMomentumTransfer
    from xlb_tpu_torch.examples.cfd.cylinder_benchmark_schafer_turek import build, force_history
    from xlb_tpu_torch.ops import MomentumTransfer

    sj, (f_0, f_1, bm, mm), omega = schafer_turek_jax(8)
    mt = JaxMomentumTransfer(sj.boundary_conditions[-1])

    @jax.jit
    def step_and_force(f_0, f_1):  # one compiled step, as the reference script's scan body
        a, b = sj(f_0, f_1, bm, mm, omega, 0)
        return b, a, mt(b, a, bm, mm)

    ref = []
    for _ in range(10):
        f_0, f_1, force = step_and_force(f_0, f_1)
        ref.append(np.asarray(force, dtype=np.float64))
    reset_port_state()
    st, fields, omega, bc_cyl = build(d=8, backend="torch", device="cpu")
    _, forces = force_history(st, fields, omega, MomentumTransfer(bc_cyl), 10)
    ref = np.stack(ref)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(forces, ref, rtol=1e-4, atol=1e-6)


def test_guards():
    """(d) K8 takes hybrid (the kExtHybrid form); a hybrid BC on a pair
    without the kExtHybrid instantiation raises at construction, in K1 and
    K8; the 2D kernels refuse the outflow, free-slip and do-nothing;
    autograd through a 3D hybrid step or window on the CUDA tier has its
    backward: K8 for "dma", the TORCH tier's VJP for "blocked"."""
    import torch

    from xlb_tpu_torch import boundary
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep, CollideStream2DStep
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import _FusedSweeps, bc_to_spec
    from xlb_tpu_torch.velocity_set import D2Q9

    st, ft = hybrid_scene("xlb_tpu_torch", "bounceback")
    vs = st.velocity_set
    specs = [bc_to_spec(b, vs) for b in st.boundary_conditions]
    assert CollideStreamAdjoint(vs, SHAPE, bc_specs=specs).params.walled == 3
    for cls in (CollideStreamStep, CollideStreamAdjoint):
        with pytest.raises(NotImplementedError, match="D3Q19 BGK and D3Q27 KBC only, got D3Q19 TRT"):
            cls(vs, SHAPE, collision=("TRT", {"magic": 0.25}), bc_specs=specs)
    for sweeps, backward in ((_FusedSweeps(st, 1, shifted=False), "adjoint"),
                             (_FusedSweeps(st, 4, shifted=False), "adjoint"),
                             (_FusedSweeps(st, 1, shifted=False, kernel="blocked"), "torch")):
        f = ft[0].clone().requires_grad_(True)
        sweeps.check_backward(f, OMEGA)
        assert sweeps.backward == backward and sweeps.no_backward is None
    reset_port_state()
    _init("xlb_tpu_torch", 9)
    idx = [[0, 1], [3, 3]]
    for bc in (boundary.ExtrapolationOutflowBC(indices=idx), boundary.FreeSlipBC(indices=idx, normal=(0, -1)),
               boundary.DoNothingBC(indices=idx)):
        spec = bc_to_spec(bc, D2Q9())
        for cls in (CollideStream2DStep, CollideStream2DKStep):
            with pytest.raises(NotImplementedError, match=f"{spec['kind']}.*2D CUDA kernels"):
                cls(D2Q9(), (8, 6), bc_specs=[spec])
    assert torch.is_grad_enabled()
    from tests.test_torch_guards import PACKAGE

    scanned = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert {"boundary/bc_hybrid.py", "geometry/distances.py", "examples/cfd/cylinder_benchmark_schafer_turek.py",
            "examples/cfd/sphere_drag_validation.py"} <= scanned  # under test_package_never_imports_jax
