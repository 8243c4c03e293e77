"""The 3D collision zoo and D3Q27 of the port against xlb_tpu, on the CPU.

- each collision operator (and ForcedCollision) against
  ``xlb_tpu.ops.collision`` on seeded populations, D3Q19 and D3Q27 (KBC on
  D3Q27, and its D2Q9 form), rtol 1e-6;
- the MRT projectors, the D3Q27 derived constants (atol 1e-12) and the
  projector table of the CUDA kernels;
- ``pack_masks`` on a D3Q27 cavity with solids, bit for bit;
- the TORCH-tier stepper and the plain fused step (``kernel="dma"`` and
  ``"blocked"``) against xlb_tpu's jnp tier, 3 steps from a seeded
  perturbed equilibrium, within 5e-6 (xlb_tpu's own fused-vs-jnp bound):
  the 16^3 cavity of ``tests/kernels/test_fused_kernel.py`` for every
  collision, its forced halfway channel, and a forced D3Q27 KBC channel;
- the plain step against two interpret-mode calls of xlb_tpu's
  block-mapped kernel (K0), one step each, within 5e-6;
- the bf16-shifted window (D3Q27 KBC, 2 steps) against the jnp tier
  within the 8-ulp bound of bf16.

(torch is imported inside the tests; test_torch_setup.py says why.)
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_setup import as_f32, reset_port_state

OMEGA = 1.5
COLLISIONS = ["BGK", "KBC", "SmagorinskyLESBGK", "TRT", "MRT", "PowerLawBGK"]
PARAMS = {"PowerLawBGK": {"consistency": 0.05, "power_index": 0.8}}
FORCE = (1e-4, 0.0, 0.0)


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def _stencil(pkg_name, q):
    return getattr(importlib.import_module(f"{pkg_name}.velocity_set"), "D2Q9" if q == 9 else f"D3Q{q}")()


def _init(pkg_name, q, policy="FP32FP32"):
    pkg = importlib.import_module(pkg_name)
    pkg.DefaultConfig.reset()
    importlib.import_module(f"{pkg_name}.boundary.registry").boundary_condition_registry.reset()
    backend = "JAX" if pkg_name == "xlb_tpu" else "TORCH"
    pkg.init(velocity_set=_stencil(pkg_name, q), default_backend=pkg.ComputeBackend[backend],
             default_precision_policy=pkg.PrecisionPolicy[policy])
    return pkg


def _macroscopic_fields(shape, seed):
    """Seeded (rho, u) of a perturbed flow: rho 1 +- 1%, u ~ 0.02."""
    rng = np.random.default_rng(seed)
    rho = (1.0 + 0.01 * rng.standard_normal((1,) + shape)).astype(np.float32)
    u = (0.02 * rng.standard_normal((3,) + shape)).astype(np.float32)
    return rho, u


def build_scene(pkg_name, kind, shape, collision="BGK", q=19, policy="FP32FP32", seed=0, solid_block=False):
    """(stepper, (f_0, f_1, bc_mask, missing_mask)) on the CPU in either
    package. "cavity": the lid cavity of test_fused_kernel.py (fullway
    walls, equilibrium lid u = 0.03); "channel": halfway walls in z and the
    body force FORCE. ``solid_block`` adds a halfway block (cell type 255
    inside). f_0 is the equilibrium of seeded (rho, u) fields."""
    pkg = _init(pkg_name, q, policy)
    bnd = importlib.import_module(f"{pkg_name}.boundary")
    models = importlib.import_module(f"{pkg_name}.models")
    init_mac = importlib.import_module(f"{pkg_name}.helper.initializers").initialize_from_macroscopic
    if pkg_name == "xlb_tpu":
        grid = pkg.grid_factory(shape, mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    else:
        grid = pkg.grid_factory(shape, device="cpu")
    box = grid.bounding_box_indices()
    kw = dict(collision_type=collision, collision_params=PARAMS.get(collision))
    if kind == "cavity":
        walls = np.unique(
            np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1)
        bcs = [bnd.FullwayBounceBackBC(indices=walls.tolist()),
               bnd.EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=grid.bounding_box_indices(remove_edges=True)["top"])]
    else:
        walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top")], axis=1), axis=1)
        bcs = [bnd.HalfwayBounceBackBC(indices=walls.tolist())]
        kw["force_vector"] = np.array(FORCE)
    if solid_block:
        block = np.indices((3, 2, 2)).reshape(3, -1) + np.array([[3], [3], [3]])
        bcs.append(bnd.HalfwayBounceBackBC(indices=block.tolist()))
    stepper = models.IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, **kw)
    _, f_1, bc_mask, missing_mask = stepper.prepare_fields()
    rho, u = _macroscopic_fields(shape, seed)
    f_0 = init_mac(grid, stepper.velocity_set, stepper.precision_policy, rho, u)
    return stepper, (f_0, f_1, bc_mask, missing_mask)


def _jnp_steps(stepper, fields, n):
    """n steps of xlb_tpu's jnp tier (one jitted window)."""
    return stepper.build_multi_step(n, donate=False)(*fields, OMEGA)[0]


def _run_steps(step, fields, n):
    f_0, f_1, bc_mask, missing_mask = fields
    for t in range(n):
        f_0, f_1 = step(f_0, f_1, bc_mask, missing_mask, OMEGA, t)
        f_0, f_1 = f_1, f_0
    return f_0


def _operator(pkg_name, name, vs, forced):
    ops = importlib.import_module(f"{pkg_name}.ops.collision")
    op = getattr(ops, name)(velocity_set=vs, **PARAMS.get(name, {}))
    return ops.ForcedCollision(op, force_vector=np.array(FORCE[: vs.d])) if forced else op


OPERATOR_CASES = [(name, q, False) for q in (19, 27) for name in COLLISIONS if name != "KBC" or q == 27]
OPERATOR_CASES += [("BGK", 19, True), ("BGK", 27, True), ("KBC", 27, True), ("KBC", 9, False)]


@pytest.mark.parametrize("name,q,forced", OPERATOR_CASES)
def test_collision_operator_matches_xlb_tpu(name, q, forced):
    import torch

    _init("xlb_tpu", q)
    vj = _stencil("xlb_tpu", q)
    _init("xlb_tpu_torch", q)
    vt = _stencil("xlb_tpu_torch", q)
    rng = np.random.default_rng(q)
    w = vt._w.reshape((q,) + (1,) * vt.d)
    feq = (w * (1.0 + 0.02 * rng.standard_normal((q,) + (4, 5, 6)[: vt.d]))).astype(np.float32)
    f = (feq * (1.0 + 0.05 * rng.standard_normal(feq.shape))).astype(np.float32)
    ref = _operator("xlb_tpu", name, vj, forced)(jnp.asarray(f), jnp.asarray(feq), OMEGA)
    ours = _operator("xlb_tpu_torch", name, vt, forced)(torch.from_numpy(f), torch.from_numpy(feq), OMEGA)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-9)


def test_mrt_projectors_and_d3q27_constants_match_xlb_tpu():
    from xlb_tpu.ops.collision import mrt_fixed_projectors as jax_fixed, mrt_projectors as jax_proj
    from xlb_tpu_torch.kernels import _cuda
    from xlb_tpu_torch.ops.collision import mrt_fixed_projectors, mrt_projectors

    for q in (19, 27):
        vj, vt = _stencil("xlb_tpu", q), _stencil("xlb_tpu_torch", q)
        pj, pt = jax_proj(vj), mrt_projectors(vt)
        assert pj.keys() == pt.keys()
        for g in pj:
            np.testing.assert_allclose(pt[g], pj[g], rtol=0, atol=1e-12)
        for (sj, mj), (st, mt) in zip(jax_fixed(vj, 0.8, 1.2), mrt_fixed_projectors(vt, 0.8, 1.2)):
            assert sj == st
            np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-12)
    vj, vt = _stencil("xlb_tpu", 27), _stencil("xlb_tpu_torch", 27)
    for attr in ("_c", "_w", "_cc", "_opp_indices", "_qi", "main_indices", "right_indices", "left_indices"):
        np.testing.assert_allclose(np.asarray(getattr(vt, attr), np.float64), np.asarray(getattr(vj, attr), np.float64),
                                   rtol=0, atol=1e-12)
    # the kernels' compile-time projector table is the one these give
    assert _cuda.MRT_TABLE.read_text() == _cuda.mrt_table_header()


def test_pack_masks_d3q27_bit_equal():
    from xlb_tpu.kernels.fused_step import pack_masks as jax_pack_masks
    from xlb_tpu_torch.kernels.collide_stream import kernel_solid_id, unpack_bc_id
    from xlb_tpu_torch.kernels.fused_step import pack_masks

    sj, (_, _, bmj, mmj) = build_scene("xlb_tpu", "cavity", (10, 9, 8), q=27, solid_block=True)
    st, (_, _, bmt, mmt) = build_scene("xlb_tpu_torch", "cavity", (10, 9, 8), q=27, solid_block=True)
    assert st.has_solids and sj.has_solids
    packed = pack_masks(bmt, mmt)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack_masks(bmj, mmj)))
    assert int((unpack_bc_id(packed, 27) == kernel_solid_id(27)).sum()) == 12


def _plain_fused(st, kernel="dma"):
    from xlb_tpu_torch.kernels.fused_step import build_fused_step

    return build_fused_step(st, kernel=kernel)


@pytest.mark.parametrize("collision", COLLISIONS)
def test_cavity_tiers_match_jnp_tier(collision):
    """3 steps of the TORCH tier and of the plain fused step (both kernel
    choices for BGK and KBC) against xlb_tpu's jnp tier on the 16^3
    cavity."""
    q = 27 if collision == "KBC" else 19
    sj, fj = build_scene("xlb_tpu", "cavity", (16, 16, 16), collision, q)
    ref = _jnp_steps(sj, fj, 3)
    st, ft = build_scene("xlb_tpu_torch", "cavity", (16, 16, 16), collision, q)
    kernels = ("dma", "blocked") if collision in ("BGK", "KBC") else ("dma",)
    for step in [st] + [_plain_fused(st, k) for k in kernels]:
        diff = float(np.abs(as_f32(_run_steps(step, ft, 3)) - as_f32(ref)).max())
        assert diff < 5e-6, f"{collision}: {diff}"


@pytest.mark.parametrize("collision,q,shape", [("BGK", 19, (16, 16, 16)), ("KBC", 27, (16, 8, 8))])
def test_forced_halfway_channel_matches_jnp_tier(collision, q, shape):
    """The forced halfway channel of test_fused_kernel.py (D3Q19 BGK) and
    the turbulent channel's configuration (D3Q27 KBC), 3 steps."""
    import torch

    sj, fj = build_scene("xlb_tpu", "channel", shape, collision, q)
    ref = _jnp_steps(sj, fj, 3)
    st, ft = build_scene("xlb_tpu_torch", "channel", shape, collision, q)
    for step in (st, _plain_fused(st), _plain_fused(st, "blocked")):
        out = _run_steps(step, ft, 3)
        diff = float(np.abs(as_f32(out) - as_f32(ref)).max())
        assert diff < 5e-6, f"{collision}: {diff}"
    # the force accelerates the flow along x against the unforced step
    unforced = st.collision.collision_operator
    st.collision = unforced
    mean_ux = lambda f: float((torch.stack([f[l] * float(st.velocity_set._c[0, l]) for l in range(q)]).sum(0)).mean())
    assert mean_ux(out) - mean_ux(_run_steps(st, ft, 3)) > 2e-4


@pytest.mark.parametrize("collision,q,kind,shape", [("KBC", 27, "channel", (16, 8, 8)), ("MRT", 19, "cavity", (8, 8, 8))])
def test_plain_step_matches_interpret_mode_blocked_kernel(collision, q, kind, shape):
    """xlb_tpu's block-mapped kernel K0 in interpret mode, one step, tile
    (8, 8): D3Q27 KBC with the force and halfway walls, D3Q19 MRT."""
    from xlb_tpu.kernels.fused_step import build_fused_step as jax_build_fused_step

    sj, fj = build_scene("xlb_tpu", kind, shape, collision, q)
    ref = _run_steps(jax_build_fused_step(sj, tile=(8, 8), interpret=True, kernel="blocked"), fj, 1)
    st, ft = build_scene("xlb_tpu_torch", kind, shape, collision, q)
    diff = float(np.abs(as_f32(_run_steps(_plain_fused(st, "blocked"), ft, 1)) - as_f32(ref)).max())
    assert diff < 5e-6, f"{collision}: {diff}"


def test_bf16_shifted_window_matches_jnp_tier():
    """The window under FP32BF16 (bf16 deviation-form storage; the plain
    k-step here) on the D3Q27 KBC channel, 2 steps, against the jnp tier
    within the 8-ulp bound of bf16."""
    from xlb_tpu_torch.kernels.fused_step import build_fused_window

    sj, fj = build_scene("xlb_tpu", "channel", (16, 8, 8), "KBC", 27, policy="FP32BF16")
    ref = _jnp_steps(sj, fj, 2)
    st, (f_0, f_1, bc_mask, missing_mask) = build_scene("xlb_tpu_torch", "channel", (16, 8, 8), "KBC", 27,
                                                        policy="FP32BF16")
    out, _ = build_fused_window(st, 2)(f_0, f_1, bc_mask, missing_mask, OMEGA)
    eps = float(jnp.finfo(jnp.bfloat16).eps)
    np.testing.assert_allclose(as_f32(out), as_f32(ref), rtol=8 * eps, atol=8 * eps * 0.05)
