"""The differentiable cavity: the port's fused adjoint and its autograd
paths against xlb_tpu.

- The adjoint's plain version against xlb_tpu's fused adjoint kernel, run
  in Pallas interpret mode (as xlb_tpu's own kernel tests run it), on a
  cavity with a solid block, f32 and bf16-shifted primal; and beyond BGK,
  on the TRT cavity and the forced Smagorinsky channel with halfway walls.
- A torch transcription of the hand-derived Jacobian-transpose of the
  CUDA adjoint kernel (``csrc/adjoint_step.cuh::bgk_vjp``), term by term, against
  the plain version -- the derivation is checked before the card sees it.
- ``torch.autograd`` through the port's fused step and window (their
  wrappers run the plain versions on CPU tensors; the collision zoo, the
  force and halfway walls included) and through the TORCH tier, against
  ``jax.grad`` through xlb_tpu.

All inputs are made from a seed with NumPy. (torch is imported inside the
tests; test_torch_setup.py says why.)
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xlb_tpu.kernels.adjoint_step import build_fused_adjoint_3d as jax_adjoint
from xlb_tpu.kernels.fused_step import (
    bc_to_spec as jax_bc_to_spec,
    build_fused_window as jax_build_fused_window,
    pack_masks as jax_pack_masks,
)
from tests.test_torch_setup import build_cavity, reset_port_state

SHAPE = (8, 8, 128)  # xlb_tpu's fused adjoint needs a 128-multiple z extent
SOLID = (slice(2, 5), slice(3, 6), slice(40, 60))  # cell type 255 block
OMEGA = 1.5
# store dtype: (jnp dtype, torch dtype name, shifted)
STORES = {"f32": (jnp.float32, "float32", False), "bf16-shifted": (jnp.bfloat16, "bfloat16", True)}
# adjoint outputs (test_fused_kernel.py's strict elementwise check)
DF_TOL = dict(rtol=1e-4, atol=1e-7)
DOM_TOL = dict(rtol=1e-4, atol=1e-8)


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def _perturbed(f0, seed):
    f = np.asarray(f0).astype(np.float32)
    return (f * (1.0 + 0.05 * np.random.default_rng(seed).standard_normal(f.shape))).astype(np.float32)


@functools.cache
def _adjoint_scene(store_key, seed, package="both", solid=True):
    """The cavity at SHAPE with a solid block, a seeded perturbed primal in
    store form and a seeded float32 cotangent of magnitude ~w. Returns
    {package: (velocity set, bc specs, primal, g, packed mask)} and the
    store dtype key's entry of STORES; built once per test process (the
    tests only read it)."""
    import torch

    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks
    from xlb_tpu_torch.utils import cotangent_from_numpy

    jstore, tstore, shifted = STORES[store_key]
    rng = np.random.default_rng(seed)
    q = 19
    noise = rng.standard_normal((q,) + SHAPE)
    g = rng.standard_normal((q,) + SHAPE)
    out = {}
    packages = ("xlb_tpu", "xlb_tpu_torch") if package == "both" else (package,)
    for pkg in packages:
        stepper, (_, _, bm, mm) = build_cavity(pkg, SHAPE)
        vs = stepper.velocity_set
        w = vs._w.reshape(-1, 1, 1, 1)
        f = (0.02 * noise * w if shifted else w * (1.0 + 0.05 * noise)).astype(np.float32)
        gw = (w * g).astype(np.float32)
        bm = np.array(bm)
        if solid:
            bm[(0,) + SOLID] = 255
        if pkg == "xlb_tpu":
            specs = [jax_bc_to_spec(b, vs) for b in stepper.boundary_conditions]
            mask = jax_pack_masks(jnp.asarray(bm), mm)
            out[pkg] = (vs, specs, jnp.asarray(f, dtype=jstore), jnp.asarray(gw), mask)
        else:
            specs = [bc_to_spec(b, vs) for b in stepper.boundary_conditions]
            mask = pack_masks(torch.from_numpy(bm), mm)
            primal = torch.from_numpy(np.array(jnp.asarray(f, dtype=jstore).astype(jnp.float32))).to(getattr(torch, tstore))
            out[pkg] = (vs, specs, primal, cotangent_from_numpy(gw, device="cpu"), mask)
    return out, STORES[store_key]


@pytest.mark.parametrize("store", list(STORES))
def test_adjoint_plain_matches_xlb_tpu_adjoint_kernel(store):
    """K8's plain version against xlb_tpu's interpret-mode K8, with solids."""
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.utils import gradients_to_numpy

    scene, (jstore, tstore, shifted) = _adjoint_scene(store, seed=1)
    jvs, jspecs, fj, gj, mj = scene["xlb_tpu"]
    vs, specs, ft, gt, mt = scene["xlb_tpu_torch"]
    bwd = jax_adjoint(jvs, SHAPE, bc_specs=jspecs, compute_dtype=jnp.float32, store_dtype=jstore, tile=(8, 8),
                      interpret=True, has_solids=True, shifted=shifted)
    df_ref, dom_ref = bwd(fj, gj, mj, OMEGA)

    adjoint = CollideStreamAdjoint(vs, SHAPE, bc_specs=specs, store_dtype=ft.dtype, shifted=shifted, has_solids=True)
    calls = CollideStreamAdjoint.plain_calls
    df, dom = gradients_to_numpy(*adjoint(ft, gt, mt, OMEGA))
    assert CollideStreamAdjoint.plain_calls == calls + 1
    assert df.shape == (19,) + SHAPE and dom.shape == SHAPE
    np.testing.assert_allclose(df, np.asarray(df_ref), **DF_TOL)
    np.testing.assert_allclose(dom, np.asarray(dom_ref), **DOM_TOL)


@pytest.mark.parametrize("collision,q,kind", [("TRT", 19, "cavity"), ("SmagorinskyLESBGK", 19, "channel")])
def test_zoo_adjoint_plain_matches_xlb_tpu_adjoint_kernel(collision, q, kind):
    """K8's plain version against xlb_tpu's interpret-mode K8 beyond BGK:
    the TRT cavity (equilibrium, fullway) and the forced Smagorinsky
    channel (halfway walls, the body force), seeded perturbed primal and
    cotangent, f32. df as the BGK test; dom_field's per-voxel sums of
    cancelling O(0.1) terms within one float32 ulp of them (atol 1e-7,
    as test_adjoint_dom_field_matches_torch_tier_per_voxel_omega)."""
    import torch

    from tests.test_torch_collisions import build_scene
    from xlb_tpu.kernels.collide_stream import kernel_collision_spec as jax_collision_spec
    from xlb_tpu.kernels.fused_step import stepper_force_vector as jax_force_vector
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream import kernel_collision_spec
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks, stepper_force_vector

    sj, (f0j, _, bmj, mmj) = build_scene("xlb_tpu", kind, SHAPE, collision, q)
    st, (_, _, bmt, mmt) = build_scene("xlb_tpu_torch", kind, SHAPE, collision, q)
    f = _perturbed(f0j, seed=9)
    g = (sj.velocity_set._w.reshape(-1, 1, 1, 1) * np.random.default_rng(10).standard_normal(f.shape)).astype(np.float32)
    jvs = sj.velocity_set
    bwd = jax_adjoint(jvs, SHAPE, collision=jax_collision_spec(sj), bc_specs=[jax_bc_to_spec(b, jvs) for b in
                                                                              sj.boundary_conditions],
                      tile=(8, 8), interpret=True, has_solids=sj.has_solids, force_vector=jax_force_vector(sj))
    df_ref, dom_ref = bwd(jnp.asarray(f), jnp.asarray(g), jax_pack_masks(bmj, mmj), OMEGA)

    vs = st.velocity_set
    adjoint = CollideStreamAdjoint(vs, SHAPE, collision=kernel_collision_spec(st), has_solids=st.has_solids,
                                   bc_specs=[bc_to_spec(b, vs) for b in st.boundary_conditions],
                                   force_vector=stepper_force_vector(st))
    df, dom = adjoint(torch.from_numpy(f), torch.from_numpy(g), pack_masks(bmt, mmt), OMEGA)
    np.testing.assert_allclose(df.numpy(), np.asarray(df_ref), **DF_TOL)
    np.testing.assert_allclose(dom.numpy(), np.asarray(dom_ref), rtol=1e-4, atol=1e-7)


def hand_adjoint(vs, bc_specs, f_primal, g, mask_i32, omega, shifted, has_solids):
    """Torch transcription of csrc/adjoint_step.cuh's bgk_vjp and
    adjoint_kernel, term by term: the hand-derived per-voxel
    Jacobian-transpose of the BGK step and its
    epilogues, then the push df_m[y - c_m] = h_m(y) plus the solid term."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream import _equilibrium, _moments, f32_weights, kernel_solid_id, unpack_bc_id

    q, c, opp = vs.q, vs._c, vs._opp_indices
    w = f32_weights(vs)
    fc = f_primal.float()
    fs = [torch.roll(fc[l], shifts=tuple(int(s) for s in c[:, l]), dims=(0, 1, 2)) for l in range(q)]
    if shifted:
        fs = [fs[l] + w[l] for l in range(q)]
    bc = unpack_bc_id(mask_i32, q)
    fixed = torch.zeros_like(bc, dtype=torch.bool)
    fullway = torch.zeros_like(fixed)
    for spec in bc_specs:
        on = bc == spec["id"]
        if spec["kind"] == "equilibrium":
            fs = [torch.where(on, float(spec["feq"][l]), fs[l]) for l in range(q)]
            fixed |= on
        else:
            fullway |= on
    solid = (bc == kernel_solid_id(q)) & has_solids

    # the forward's moments and pair-shared equilibrium (moments_equilibrium)
    rho, u = _moments(fs, c, q, 3)
    feq = _equilibrium(rho, u, c, w, opp, q, 3)
    cu = [sum(int(c[a, l]) * u[a] for a in range(3)) for l in range(q)]
    inv_rho = 1.0 / rho
    G = sum(g[l] * feq[l] for l in range(q))
    gw = sum(g[l] * w[l] for l in range(q))
    P = [sum(int(c[a, l]) * g[l] * w[l] * (3.0 + 9.0 * cu[l]) for l in range(q)) for a in range(3)]
    B = [P[a] - 3.0 * u[a] * gw for a in range(3)]
    A = G * inv_rho - (B[0] * u[0] + B[1] * u[1] + B[2] * u[2])
    h = [(1.0 - omega) * g[m] + omega * (A + sum(int(c[a, m]) * B[a] for a in range(3))) for m in range(q)]
    dom = sum(g[l] * (feq[l] - fs[l]) for l in range(q))

    h = [torch.where(fullway, g[opp[m]], h[m]) for m in range(q)]
    h = [torch.where(solid | fixed, 0.0, h[m]) for m in range(q)]
    dom = torch.where(fullway | solid, 0.0, dom)
    df = [torch.roll(h[m], shifts=tuple(-int(s) for s in c[:, m]), dims=(0, 1, 2)) for m in range(q)]
    df = [torch.where(solid, df[m] + g[m], df[m]) for m in range(q)]
    return torch.stack(df), dom


@pytest.mark.parametrize("solid", [True, False])
@pytest.mark.parametrize("store", list(STORES))
def test_hand_derivation_matches_plain_adjoint(store, solid):
    """The CUDA kernel's Jacobian-transpose, transcribed to torch, against
    torch.func.vjp of the plain step."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import collide_stream_adjoint_plain

    scene, (_, _, shifted) = _adjoint_scene(store, seed=2, package="xlb_tpu_torch", solid=solid)
    vs, specs, f, g, mask = scene["xlb_tpu_torch"]
    df_ref, dom_ref = collide_stream_adjoint_plain(vs, specs, f, g, mask, OMEGA, shifted, has_solids=solid)
    df, dom = hand_adjoint(vs, specs, f, g, mask, OMEGA, shifted, has_solids=solid)
    torch.testing.assert_close(df, df_ref, **DF_TOL)
    torch.testing.assert_close(dom, dom_ref, **DOM_TOL)
    assert float(dom_ref.abs().max()) > 0 and float(df_ref.abs().max()) > 0


def _grads_jax(loss, f, omega, jit=False):
    """jax.grad of loss(f, omega); ``jit``: compiled whole, which pays on
    the BGK cavity (the zoo's forced and entropic steps compile for longer
    than they run op by op)."""
    grad = jax.grad(loss, argnums=(0, 1))
    gf, go = (jax.jit(grad) if jit else grad)(f, jnp.float32(omega))
    return np.asarray(jnp.asarray(gf).astype(jnp.float32)), float(go)


def _grads_torch(loss, f, omega):
    import torch

    ft = torch.from_numpy(np.array(jnp.asarray(f).astype(jnp.float32))).to(
        torch.bfloat16 if f.dtype == jnp.bfloat16 else torch.float32
    ).requires_grad_(True)
    om = torch.tensor(omega, dtype=torch.float32, requires_grad=True)
    loss(ft, om).backward()
    assert ft.grad.dtype == ft.dtype and om.grad.shape == ()
    return ft.grad.float().numpy(), float(om.grad)


def _sum_sq(x):
    return (x.float() ** 2).sum()


def _jnp_rollout_sum_sq(stepper, f, bc_mask, missing_mask, omega, steps):
    """sum(f**2) after ``steps`` jnp-tier steps of xlb_tpu's stepper(...)."""

    def body(t, carry):
        a, b = stepper(*carry, bc_mask, missing_mask, omega, t)
        return b, a

    a, _ = jax.lax.fori_loop(0, steps, body, (f, f))
    return jnp.sum(a**2)


def test_fused_step_autograd_matches_jnp_tier():
    """grad of sum(out**2) through the port's fused step (forward K1,
    backward K8; plain versions here) against jax.grad through xlb_tpu's
    jnp-tier stepper(...). omega's cotangent is a sum of cancelling f32
    terms over every voxel (rtol 2e-2, as test_fused_kernel.py)."""
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.fused_step import build_fused_step

    shape = (16, 12, 10)
    sj, (f0j, _, bmj, mmj) = build_cavity("xlb_tpu", shape)
    st, (_, _, bmt, mmt) = build_cavity("xlb_tpu_torch", shape)
    f = jnp.asarray(_perturbed(f0j, seed=3))
    gf_j, go_j = _grads_jax(lambda f, om: jnp.sum(sj(f, f, bmj, mmj, om, 0)[1] ** 2), f, OMEGA, jit=True)

    step = build_fused_step(st)
    calls = CollideStreamAdjoint.plain_calls
    gf_t, go_t = _grads_torch(lambda f, om: _sum_sq(step(f, f, bmt, mmt, om, 0)[1]), f, OMEGA)
    assert CollideStreamAdjoint.plain_calls == calls + 1
    np.testing.assert_allclose(gf_t, gf_j, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(go_t, go_j, rtol=2e-2, atol=1e-5)


def test_fused_window_fp32_autograd_matches_jnp_rollout():
    """3-step FP32FP32 window (one k=2 group and one single step; the
    backward replays three single steps and runs three adjoints) against
    jax.grad of xlb_tpu's jnp-tier 3-step rollout (test_autodiff.py's
    tolerances)."""
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.fused_step import build_fused_window

    shape, steps = (16, 12, 10), 3
    sj, (f0j, _, bmj, mmj) = build_cavity("xlb_tpu", shape)
    st, (_, _, bmt, mmt) = build_cavity("xlb_tpu_torch", shape)
    f = jnp.asarray(_perturbed(f0j, seed=4))

    gf_j, go_j = _grads_jax(lambda f, om: _jnp_rollout_sum_sq(sj, f, bmj, mmj, om, steps), f, OMEGA, jit=True)
    run = build_fused_window(st, steps)
    calls = CollideStreamAdjoint.plain_calls
    gf_t, go_t = _grads_torch(lambda f, om: _sum_sq(run(f, f, bmt, mmt, om)[0]), f, OMEGA)
    assert CollideStreamAdjoint.plain_calls == calls + steps
    np.testing.assert_allclose(gf_t, gf_j, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(go_t, go_j, rtol=2e-3)


def test_fused_window_bf16_autograd_matches_xlb_tpu_window():
    """2-step FP32BF16 window (bf16 deviation-form storage): the port's
    gradients against jax.grad through xlb_tpu's interpret-mode fused
    window (K1 replay, K8 reverse sweep). The f_0 gradient comes back in
    bf16 on both sides. Tolerance: 2 bf16 ulps (rtol 2 * 2^-7) plus an
    atol of 1e-6 for entries that cancel to near zero -- the two packages
    round the replayed bf16 states and the final cast at different places;
    omega's cotangent is a sum over every voxel of both steps, rtol 2e-3."""
    from xlb_tpu_torch.kernels.fused_step import build_fused_window

    steps = 2
    sj, (f0j, _, bmj, mmj) = build_cavity("xlb_tpu", SHAPE, "FP32BF16")
    st, (_, _, bmt, mmt) = build_cavity("xlb_tpu_torch", SHAPE, "FP32BF16")
    f = jnp.asarray(_perturbed(f0j, seed=5), dtype=jnp.bfloat16)
    run_j = jax_build_fused_window(sj, steps, tile=(8, 8), interpret=True, temporal_steps=2)
    gf_j, go_j = _grads_jax(lambda f, om: jnp.sum(run_j(f, f, bmj, mmj, om)[0].astype(jnp.float32) ** 2), f, OMEGA)

    run = build_fused_window(st, steps)
    gf_t, go_t = _grads_torch(lambda f, om: _sum_sq(run(f, f, bmt, mmt, om)[0]), f, OMEGA)
    eps = float(jnp.finfo(jnp.bfloat16).eps)
    np.testing.assert_allclose(gf_t, gf_j, rtol=2 * eps, atol=1e-6)
    np.testing.assert_allclose(go_t, go_j, rtol=2e-3)


def test_torch_tier_autograd_matches_jnp_tier():
    """The oracle tier: torch.autograd through the TORCH tier's
    build_multi_step(5) against jax.grad through xlb_tpu's jnp tier,
    FP32FP32. The f_0 gradient's entries are O(1), where one float32 ulp
    is 1.2e-7: the two tiers sum in different orders, so entries that
    cancel to near zero keep a difference of about one such ulp (atol
    2e-7); omega's cotangent is a cancelling sum over every voxel of 5
    steps (rtol 2e-3, as xlb_tpu's own window test)."""
    shape, steps = (16, 12, 10), 5
    sj, (f0j, _, bmj, mmj) = build_cavity("xlb_tpu", shape)
    st, (_, _, bmt, mmt) = build_cavity("xlb_tpu_torch", shape)
    f = jnp.asarray(_perturbed(f0j, seed=6))
    gf_j, go_j = _grads_jax(lambda f, om: _jnp_rollout_sum_sq(sj, f, bmj, mmj, om, steps), f, OMEGA, jit=True)
    run = st.build_multi_step(steps)
    gf_t, go_t = _grads_torch(lambda f, om: _sum_sq(run(f, f, bmt, mmt, om)[0]), f, OMEGA)
    np.testing.assert_allclose(gf_t, gf_j, rtol=1e-5, atol=2e-7)
    np.testing.assert_allclose(go_t, go_j, rtol=2e-3)


def test_adjoint_dom_field_matches_torch_tier_per_voxel_omega():
    """The plain adjoint's per-voxel omega cotangent and df against
    torch.autograd through the TORCH tier's step with omega as a per-voxel
    field (xlb_tpu's strict elementwise check of its fused adjoint against
    its jnp tier), FP32FP32, no solids. The TORCH tier forms feq without
    the kernels' pair sharing, so dom's cancelling sum of O(0.1) terms
    differs by about one float32 ulp of them (atol 1e-7)."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import collide_stream_adjoint_plain
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    shape = (16, 12, 10)
    st, (f0, _, bm, mm) = build_cavity("xlb_tpu_torch", shape)
    f = torch.from_numpy(_perturbed(f0.numpy(), seed=7))
    om = torch.full(shape, OMEGA, requires_grad=True)
    fv = f.clone().requires_grad_(True)
    out = st(fv, fv, bm, mm, om, 0)[1]
    g = 2.0 * out.detach()
    df_ref, dom_ref = torch.autograd.grad(out, (fv, om), g)
    specs = [bc_to_spec(b, st.velocity_set) for b in st.boundary_conditions]
    df, dom = collide_stream_adjoint_plain(st.velocity_set, specs, f, g, pack_masks(bm, mm), OMEGA, has_solids=False)
    torch.testing.assert_close(df, df_ref, **DF_TOL)
    torch.testing.assert_close(dom, dom_ref, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("collision,q,kind", [("TRT", 19, "cavity"), ("MRT", 19, "cavity"),
                                              ("SmagorinskyLESBGK", 19, "channel"), ("BGK", 19, "channel"),
                                              ("KBC", 27, "channel")])
def test_zoo_step_autograd_matches_jnp_tier(collision, q, kind):
    """grad of sum(out**2) through the port's kernel="dma" step of the
    collision zoo (forward K1, backward K8; plain versions here) against
    jax.grad through xlb_tpu's jnp-tier stepper(...) on the same seeded
    scene: the TRT and MRT cavities, and the forced channels with halfway
    walls (Smagorinsky and BGK on D3Q19, KBC on D3Q27). Tolerances as the
    BGK window's (rtol 2e-4, atol 1e-6; omega rtol 2e-3)."""
    from tests.test_torch_collisions import build_scene
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.fused_step import build_fused_step

    shape = (10, 8, 6)
    sj, (f0j, _, bmj, mmj) = build_scene("xlb_tpu", kind, shape, collision, q)
    st, (_, _, bmt, mmt) = build_scene("xlb_tpu_torch", kind, shape, collision, q)
    f = jnp.asarray(_perturbed(f0j, seed=8))
    gf_j, go_j = _grads_jax(lambda f, om: jnp.sum(sj(f, f, bmj, mmj, om, 0)[1] ** 2), f, OMEGA)
    step = build_fused_step(st)
    calls = CollideStreamAdjoint.plain_calls
    gf_t, go_t = _grads_torch(lambda f, om: _sum_sq(step(f, f, bmt, mmt, om, 0)[1]), f, OMEGA)
    assert CollideStreamAdjoint.plain_calls == calls + 1
    np.testing.assert_allclose(gf_t, gf_j, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(go_t, go_j, rtol=2e-3)
