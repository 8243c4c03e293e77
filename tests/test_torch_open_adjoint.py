"""Gradients through the open boundaries and curved walls: the port's
adjoint K8 (kExtOpen and kExtHybrid forms) and its autograd paths against
xlb_tpu, on the CPU.

Scenes (D3Q19 BGK unless said): "outflow2", xlb_tpu's two-outflow scene of
tests/kernels/test_fused_kernel.py (halfway walls, an equilibrium inlet,
extrapolation outflows on the +x and +y faces, so the staged reads include
an x offset) at 16x12x10; the BC sets of ``chip_smoke.open_bcs`` at
32x16x16 (test_torch_open_bcs.py's scenes) -- "sphere" (a parabolic
regularized inlet through the aux field, the outflow, halfway walls and
mesh sphere) and "zouhe" (a Zou-He velocity inlet, a per-voxel Zou-He
pressure outlet, free-slip walls, a do-nothing piece); and
test_torch_hybrid.py's ``chip_smoke.hybrid_bcs`` tunnels at 24x16x16 with
a hybrid mesh sphere, one per method (with and without wall distances,
static and spinning walls); and "rotating", the D3Q27 KBC rotating sphere of
``chip_smoke.open_bcs`` at 32x16x16 (its (b) only). On the card
(tests/test_torch_gpu.py, chip_smoke [17]/[18]) D3Q27 KBC's K8 is held to
float64 TORCH-tier autograd, as its float32 gradient is ill-conditioned
(the entropic gamma).

For each scene:
- (a) ``staging_keys`` equals xlb_tpu's on the same specs;
- (b) the plain K8 (``collide_stream_adjoint_plain``, the aux field a
  constant) against ``jax.vjp`` of xlb_tpu's jnp-tier
  ``stepper._step_pull`` with a per-voxel omega field -- the reference's
  own oracle for its adjoint kernel (test_fused_kernel.py:436-444) --
  rtol 1e-4, atol 1e-7, except on df in "zouhe" and "rotating", where
  atol is 1e-6, K8's tolerance on the card (chip_smoke [5]): there entries
  that cancel to near zero keep a few float32 ulps of the O(1)
  populations the moments, the Zou-He mass balance and KBC's entropic
  stabilizer sum, in another order in each package (up to 2.3e-7 beyond
  rtol on "zouhe", 1.7e-7 on "rotating"; the reference's 1e-7 compares
  two evaluations of one body). The jnp step is jitted, except on
  "rotating", where it runs op by op: jitted, a D3Q27 KBC step's VJP
  compiles for minutes;
- (c) on "outflow2", "zouhe" and "hybrid-bounceback", ``torch.autograd``
  through the CUDA tier (plain versions here): ``stepper(...)``'s fused
  step (K1, K8), ``build_multi_step(3)`` (K2 forward, K1 replay and K8)
  and the ``kernel="blocked"`` step (the TORCH tier's VJP), gradients of
  sum(out**2) with respect to f_0 and omega against xlb_tpu's jnp tier in
  reverse mode (its step's ``jax.vjp``, chained back through the
  rollout): rtol 2e-4 / atol 1e-6 (f_0) and rtol 2e-3 (omega), xlb_tpu's
  own tolerances for its window (test_fused_kernel.py:463-464). None of
  them raises.

One test per scene, so that its JAX step is compiled once, in one worker;
the open and hybrid scenes come from their modules' caches. All inputs
are made from a seed with NumPy. (torch is imported inside the tests;
test_torch_setup.py says why.)
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import test_torch_hybrid, test_torch_open_bcs
from tests.test_torch_collisions import _init
from tests.test_torch_setup import as_f32, reset_port_state

OMEGA = 1.5
WINDOW = 3
DF_TOL, DOM_TOL = dict(rtol=1e-4, atol=1e-7), dict(rtol=1e-4, atol=1e-7)
DF_ATOL_SUMMED = {"zouhe": 1e-6, "rotating": 1e-6}  # df's atol where (b) says so
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
OMEGA_RTOL = 2e-3
# hybrid tunnels of test_torch_hybrid.SCENES: name -> (method, wall distances, wall, tunnel, q, collision)
HYBRID = {"hybrid-bounceback": ("bounceback", True, None, "closed", 19, "BGK"),
          "hybrid-regularized": ("bounceback_regularized", True, "spin", "closed", 19, "BGK"),
          "hybrid-grads": ("bounceback_grads", True, None, "closed", 19, "BGK"),
          "hybrid-tao": ("nonequilibrium_regularized", False, "static", "closed", 19, "BGK")}
assert set(HYBRID.values()) <= set(test_torch_hybrid.SCENES)
SCENES = ("outflow2", "sphere", "zouhe", "rotating") + tuple(HYBRID)
AUTOGRAD_SCENES = ("outflow2", "zouhe", "hybrid-bounceback")
OP_BY_OP = ("rotating",)  # (b)'s jnp step run op by op


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def _outflow2(pkg_name):
    pkg = _init(pkg_name, 19)
    bnd = importlib.import_module(f"{pkg_name}.boundary")
    models = importlib.import_module(f"{pkg_name}.models")
    shape = (16, 12, 10)
    if pkg_name == "xlb_tpu":
        grid = pkg.grid_factory(shape, mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    else:
        grid = pkg.grid_factory(shape, device="cpu")
    box, box_ne = grid.bounding_box_indices(), grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front")], axis=1), axis=1)
    bcs = [bnd.HalfwayBounceBackBC(indices=walls.tolist()),
           bnd.EquilibriumBC(rho=1.0, u=(0.02, 0.01, 0.0), indices=box_ne["left"]),
           bnd.ExtrapolationOutflowBC(indices=box_ne["right"]),
           bnd.ExtrapolationOutflowBC(indices=box_ne["back"])]
    stepper = models.IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f_0, f_1, bc_mask, missing_mask = stepper.prepare_fields()
    rng = np.random.default_rng(11)
    f = as_f32(f_0)
    return stepper, ((f * (1.0 + 0.05 * rng.standard_normal(f.shape))).astype(np.float32), f_1, bc_mask, missing_mask)


def _build(pkg_name, name):
    if name == "outflow2":
        return _outflow2(pkg_name)
    if name in HYBRID:
        method, dist, wall, tunnel, q, collision = HYBRID[name]
        return test_torch_hybrid.cached_scene(pkg_name, method, dist, wall, tunnel, q, collision=collision)
    return test_torch_open_bcs.cached_scene(pkg_name, name)


def scene(name):
    """The scene in both packages, {package: (stepper, fields)}, with
    xlb_tpu's f_0 in both (as float32 arrays of each package), and the
    seeded float32 cotangent g of one step's output (magnitude w)."""
    import torch

    out = {pkg: _build(pkg, name) for pkg in ("xlb_tpu", "xlb_tpu_torch")}
    f_0 = as_f32(out["xlb_tpu"][1][0])
    for pkg, array in (("xlb_tpu", jnp.asarray), ("xlb_tpu_torch", torch.from_numpy)):
        stepper, (_, *rest) = out[pkg]
        out[pkg] = (stepper, (array(f_0), *rest))
    w = out["xlb_tpu_torch"][0].velocity_set._w.reshape((-1,) + (1,) * (f_0.ndim - 1))
    return out, (w * np.random.default_rng(12).standard_normal(f_0.shape)).astype(np.float32)


def jnp_step_vjp(stepper, fields, jit=True):
    """xlb_tpu's jnp-tier step and its VJP with a per-voxel omega field,
    jitted or op by op: (f, omega field, cotangent) -> (out, df,
    dom_field)."""
    _, _, bm, mm = fields

    def step_vjp(f, om, ct):
        out, pullback = jax.vjp(lambda f, o: stepper._step_pull(f, f, bm, mm, o, 0)[1], f, om)
        return (out, *pullback(ct))

    if jit:
        return jax.jit(step_vjp)

    def op_by_op(f, om, ct):
        with jax.disable_jit():
            return step_vjp(f, om, ct)

    return op_by_op


def jnp_rollout_grads(step_vjp, f_0, steps):
    """(d f_0, d omega) of sum(f**2) after ``steps`` jnp-tier steps, in
    reverse mode: the states forward, then the step's VJP from the last
    state back to the first, omega's cotangent summed over the steps."""
    om = jnp.full(tuple(f_0.shape[1:]), OMEGA, jnp.float32)
    zero = jnp.zeros(f_0.shape, jnp.float32)
    states = [f_0]
    for _ in range(steps):
        states.append(step_vjp(states[-1], om, zero)[0])
    ct, d_omega = 2.0 * states.pop(), 0.0
    while states:
        _, ct, dom = step_vjp(states.pop(), om, ct)
        d_omega += float(np.asarray(dom, dtype=np.float64).sum())
    return as_f32(ct), d_omega


def _autograd(run, f_0):
    import torch

    f = f_0.clone().requires_grad_(True)
    om = torch.tensor(OMEGA, requires_grad=True)
    (run(f, om).float() ** 2).sum().backward()
    return f.grad.numpy(), float(om.grad)


def check_staging_keys(name, sj, st, specs):
    """(a) The outflow's staged reads, key for key and in xlb_tpu's order;
    the +y outflow of "outflow2" stages with an x offset."""
    from xlb_tpu.kernels.adjoint_step import staging_keys as jax_staging_keys
    from xlb_tpu.kernels.fused_step import bc_to_spec as jax_bc_to_spec
    from xlb_tpu_torch.kernels.adjoint_step import staging_keys

    jkeys = jax_staging_keys([jax_bc_to_spec(b, sj.velocity_set) for b in sj.boundary_conditions], sj.velocity_set)
    keys = staging_keys(specs, st.velocity_set)
    assert keys == jkeys and bool(keys) == any(s["kind"] == "extrapolation_outflow" for s in specs)
    if name == "outflow2":
        assert any(x0 != 1 for (_, x0, _, _) in keys)


def check_cuda_tier_gradients(name, st, fields, step_vjp):
    """(c) autograd through the CUDA tier's step, window and blocked step
    against the jnp tier's reverse mode; K8 runs once per step ("blocked":
    the TORCH tier's VJP, no K8)."""
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.fused_step import build_fused_step, build_fused_window

    f_0, f_1, bm, mm = fields
    window = build_fused_window(st, WINDOW)
    step, blocked = build_fused_step(st), build_fused_step(st, kernel="blocked")
    for api, run, steps, k8 in (("step", lambda f, om: step(f, f_1, bm, mm, om, 0)[1], 1, 1),
                                ("window", lambda f, om: window(f, f, bm, mm, om)[0], WINDOW, WINDOW),
                                ("blocked", lambda f, om: blocked(f, f_1, bm, mm, om, 0)[1], 1, 0)):
        calls = CollideStreamAdjoint.plain_calls
        gf, go = _autograd(run, f_0)
        assert CollideStreamAdjoint.plain_calls == calls + k8, api
        gf_ref, go_ref = jnp_rollout_grads(step_vjp, jnp.asarray(f_0.numpy()), steps)
        assert np.isfinite(gf).all() and np.abs(gf_ref).max() > 0
        np.testing.assert_allclose(gf, gf_ref, **GRAD_TOL, err_msg=f"{name} {api}")
        np.testing.assert_allclose(go, go_ref, rtol=OMEGA_RTOL, err_msg=f"{name} {api}")


@pytest.mark.parametrize("name", SCENES)
def test_gradients_match_xlb_tpu(name):
    """(a) staging keys, (b) the plain K8 against jax.vjp of the jnp-tier
    step, (c) autograd through the CUDA tier against the jnp tier's reverse
    mode; the adjoint wrapper takes every scene (ADJOINT_UNSUPPORTED_KINDS
    is empty, as in xlb_tpu)."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import ADJOINT_UNSUPPORTED_KINDS, CollideStreamAdjoint, adjoint_supported
    from xlb_tpu_torch.kernels.collide_stream import kernel_collision_spec
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, build_aux_field, pack_masks

    both, g = scene(name)
    (sj, fj), (st, ft) = both["xlb_tpu"], both["xlb_tpu_torch"]
    f_0, _, bm, mm = ft
    specs = [bc_to_spec(b, st.velocity_set) for b in st.boundary_conditions]
    aux = build_aux_field(st)
    aux = None if aux is None else torch.as_tensor(aux)
    assert ADJOINT_UNSUPPORTED_KINDS == () and adjoint_supported(specs)
    adj = CollideStreamAdjoint(st.velocity_set, tuple(f_0.shape[1:]), collision=kernel_collision_spec(st),
                               bc_specs=specs, has_solids=st.has_solids)
    assert adj.params.walled in (2, 3)
    check_staging_keys(name, sj, st, specs)

    calls = CollideStreamAdjoint.plain_calls
    df, dom = adj(f_0, torch.from_numpy(g), pack_masks(bm, mm), OMEGA, aux)
    assert CollideStreamAdjoint.plain_calls == calls + 1
    step_vjp = jnp_step_vjp(sj, fj, jit=name not in OP_BY_OP)
    _, df_ref, dom_ref = (as_f32(x) for x in step_vjp(
        fj[0], jnp.full(tuple(f_0.shape[1:]), OMEGA, jnp.float32), jnp.asarray(g)))
    assert np.abs(df_ref).max() > 0 and np.abs(dom_ref).max() > 0
    np.testing.assert_allclose(df.numpy(), df_ref, **dict(DF_TOL, atol=DF_ATOL_SUMMED.get(name, DF_TOL["atol"])))
    np.testing.assert_allclose(dom.numpy(), dom_ref, **DOM_TOL)

    if name in AUTOGRAD_SCENES:
        check_cuda_tier_gradients(name, st, ft, step_vjp)
