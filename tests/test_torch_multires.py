"""The multires path of the port against xlb_tpu, at small sizes.

- The grid (level shapes, origins, cell counts) and the acoustic scaling.
- The TORCH tier against xlb_tpu's naive jnp tier over 2 coarse steps
  from a seeded perturbed state: the 2-level 16^3 cavity with an 8^3 box of
  tests/models/test_multires_fused.py (its sphere replaced by a halfway
  solid block given by indices: the port has no geometry/ yet), and a
  3-level 24^3 half-box with a BC-less middle level (rtol 1e-5, atol
  5e-6).
- The fused routes (FUSION_AT_FINEST, FUSION_AT_FINEST_SFV_ALL) with the
  kernels' plain versions against the same jnp tier at xlb_tpu's own bound
  of 5e-6, and their window against per-step calls.
- The plain K5, K6 and K7 against xlb_tpu's kernels in Pallas interpret
  mode, at the smallest one-tile box each of them takes, with solids and
  every supported BC kind: float32 to roundoff, bf16-shifted within 8 bf16
  ulps of each entry and of its direction's median magnitude.
- The bf16-shifted fused window tracks float32, the coarse-BC gate warns
  and still matches the jnp tier, KBC raises.

xlb_tpu's fused stepper is never run here in interpret mode (its own tests
hold it to its jnp tier). All inputs are made from a seed with NumPy.
(torch is imported inside the tests; test_torch_setup.py says why.)
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_setup import as_f32, reset_port_state

OMEGA = 1.5
NAIVE, FUSED, SFV_ALL = "naive_collide_stream", "fusion_at_finest", "fusion_at_finest_sfv_all"
# store dtype: (jnp dtype, torch dtype name, shifted)
STORES = {"f32": (jnp.float32, "float32", False), "bf16-shifted": (jnp.bfloat16, "bfloat16", True)}


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def _walls_and_lid(shape):
    from xlb_tpu_torch.grid import Grid

    grid = Grid(shape, device="cpu")
    box, box_ne = grid.bounding_box_indices(), grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1
    )
    return walls.tolist(), box_ne["top"]


def _block(lo, hi):
    return np.stack([a.ravel() for a in np.meshgrid(*[np.arange(lo, hi)] * 3, indexing="ij")]).tolist()


def build_mres(pkg_name, scene, perf=NAIVE, policy="FP32FP32", extra_coarse_bc=None):
    """(stepper, (fs, bms, mms)) of a multires scene in ``pkg_name``, on
    the CPU, from a clean global state.

    - "two": 16^3 coarse with an 8^3 box at (4, 4, 4); fullway walls and
      an equilibrium lid u = (0.03, 0, 0) on the coarse level, a halfway
      solid block [6, 10)^3 on the finest level.
    - "three": 24^3 coarse, two 12^3 boxes at (6, 6, 6); walls and lid on
      the coarsest level, the middle level BC-less.

    ``extra_coarse_bc``: (class name, indices) of one more coarsest-level
    BC."""
    pkg = importlib.import_module(pkg_name)
    bnd = importlib.import_module(f"{pkg_name}.boundary")
    importlib.import_module(f"{pkg_name}.boundary.registry").boundary_condition_registry.reset()
    stencils = importlib.import_module(f"{pkg_name}.velocity_set")
    mgrid = importlib.import_module(f"{pkg_name}.grid.multires")
    models = importlib.import_module(f"{pkg_name}.models.multires")
    perf_type = importlib.import_module(f"{pkg_name}.mres_perf_optimization_type").MresPerfOptimizationType
    pkg.DefaultConfig.reset()
    backend = "JAX" if pkg_name == "xlb_tpu" else "TORCH"
    pkg.init(velocity_set=stencils.D3Q19(), default_backend=pkg.ComputeBackend[backend],
             default_precision_policy=pkg.PrecisionPolicy[policy])
    kw = {} if pkg_name == "xlb_tpu" else {"device": "cpu"}
    if scene == "two":
        n, boxes = 16, [((4, 4, 4), (8, 8, 8))]
    else:
        n, boxes = 24, [((6, 6, 6), (12, 12, 12)), ((6, 6, 6), (12, 12, 12))]
    grid = mgrid.MultiresGrid((n, n, n), boxes=boxes, **kw)
    walls, top = _walls_and_lid((n, n, n))
    coarse = grid.num_levels - 1
    bcs = {coarse: [bnd.FullwayBounceBackBC(indices=walls), bnd.EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=top)]}
    if scene == "two":
        bcs[0] = [bnd.HalfwayBounceBackBC(indices=_block(6, 10))]
    if extra_coarse_bc is not None:
        name, idx = extra_coarse_bc
        bcs[coarse].append(getattr(bnd, name)(indices=idx))
    stepper = models.MultiresIncompressibleNavierStokesStepper(grid, boundary_conditions=bcs,
                                                                mres_perf_opt=perf_type.from_string(perf))
    fs, _, bms, mms = stepper.prepare_fields()
    return stepper, (fs, bms, mms)


def perturbed(fs, seed=3):
    """The rest state plus 0.01 x U(0, 1) noise, per level, as float32 NumPy
    arrays (rounded to the store dtype by the caller)."""
    rng = np.random.default_rng(seed)
    return [as_f32(f) + 0.01 * rng.random(f.shape).astype(np.float32) for f in fs]


def to_jax(arrs, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


def to_port(arrs, dtype):
    import torch

    from xlb_tpu_torch.utils import level_fields_from_numpy

    return level_fields_from_numpy(arrs, [], [], device="cpu", dtype=getattr(torch, dtype))[0]


@functools.lru_cache(maxsize=None)
def reference_run(scene, extra_coarse_bc=None):
    """xlb_tpu's naive jnp tier: 2 coarse steps from the perturbed state.
    Returns float32 NumPy arrays per level: (the perturbed state, the
    result, and prepare_fields' rest state, bc_mask and missing_mask)."""
    st, (fs, bms, mms) = build_mres("xlb_tpu", scene, extra_coarse_bc=extra_coarse_bc)
    f_in = perturbed(fs)
    out = to_jax(f_in, jnp.float32)
    step = jax.jit(lambda f: st(f, bms, mms, OMEGA))  # one compile instead of one per eager op
    for _ in range(2):
        out = step(out)
    return f_in, [as_f32(f) for f in out], ([as_f32(f) for f in fs], [np.asarray(b) for b in bms],
                                            [np.asarray(m) for m in mms])


def port_run(scene, perf, steps=2, window=False, extra_coarse_bc=None, policy="FP32FP32"):
    st, (fs, bms, mms) = build_mres("xlb_tpu_torch", scene, perf, policy, extra_coarse_bc)
    f = to_port(reference_run(scene)[0], "float32")  # the extra BC leaves the input as it is
    f = [x.to(st.precision_policy.store_dtype) for x in f]
    if window:
        f = st.build_window(steps)(f, bms, mms, OMEGA)
    else:
        for _ in range(steps):
            f = st(f, bms, mms, OMEGA)
    return st, [as_f32(x) for x in f], (bms, mms)


def test_grid_and_omega_match_reference():
    import torch

    from xlb_tpu.grid.multires import MultiresGrid as JGrid
    from xlb_tpu.models.multires import compute_omega as j_omega
    from xlb_tpu_torch.grid.multires import MultiresGrid
    from xlb_tpu_torch.models.multires import compute_omega

    boxes = [((2, 4, 6), (10, 8, 6)), ((1, 2, 3), (8, 6, 4))]
    a, b = JGrid((16, 14, 12), boxes=boxes), MultiresGrid((16, 14, 12), boxes=boxes, device="cpu")
    assert b.num_levels == a.num_levels == 3 and b.device.type == "cpu"
    for l in range(3):
        la, lb = a.levels[l], b.levels[l]
        assert (lb.shape, lb.origin_in_parent, lb.extent_in_parent) == (la.shape, la.origin_in_parent, la.extent_in_parent)
        oa, sa = a.level_origin_spacing(l)
        ob, sb = b.level_origin_spacing(l)
        np.testing.assert_array_equal(ob, oa)
        assert sb == sa
        assert lb.create_field(2, dtype=torch.float32).device.type == "cpu"
    assert b.active_cells() == a.active_cells() and b.finest_equivalent_cells() == a.finest_equivalent_cells()
    assert b.weighted_updates_per_coarse_step() == sum(
        int(np.prod(lvl.shape)) * 2 ** (2 - l) for l, lvl in enumerate(a.levels))
    for level in range(4):
        assert compute_omega(1.6, level) == j_omega(1.6, level)
    with pytest.raises(ValueError):
        MultiresGrid((8, 8, 8), boxes=[((4, 4, 4), (6, 6, 6))], device="cpu")
    assert MultiresGrid((8, 8, 8)).device.type == "cuda"


@pytest.mark.parametrize("scene", ["two", "three"])
def test_prepare_fields_bit_equal(scene):
    """Masks and rest states per level equal xlb_tpu's, and the per-level
    interop carries them across."""
    from xlb_tpu_torch.utils import level_fields_to_numpy

    fj, bj, mj = reference_run(scene)[2]
    _, (ft, bt, mt) = build_mres("xlb_tpu_torch", scene)
    fn, bn, mn = level_fields_to_numpy(ft, bt, mt)
    for l in range(len(fj)):
        np.testing.assert_array_equal(fn[l], fj[l])
        np.testing.assert_array_equal(bn[l], bj[l])
        np.testing.assert_array_equal(mn[l], mj[l])
    if scene == "two":
        assert (bn[0] == 255).any(), "the finest solid block must be cell type 255"


@pytest.mark.parametrize("scene", ["two", "three"])
def test_torch_tier_matches_jnp_tier(scene):
    st, out, _ = port_run(scene, NAIVE)
    assert st.active_finest_tier == st.active_coarsest_tier == "torch"
    ref = reference_run(scene)[1]
    for l, (a, b) in enumerate(zip(out, ref)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=5e-6, err_msg=f"level {l}")


@pytest.mark.parametrize("scene,perf", [("two", FUSED), ("two", SFV_ALL), ("three", FUSED)])
def test_fused_routes_match_jnp_tier(scene, perf):
    """The CUDA tier's routes (the kernels' plain versions on the CPU)
    against xlb_tpu's jnp tier, per call and through the window."""
    from xlb_tpu_torch.kernels.collide_only import LevelCollide
    from xlb_tpu_torch.kernels.collide_then_stream import CollideThenStream

    calls = (CollideThenStream.plain_calls, LevelCollide.plain_calls)
    st, out, _ = port_run(scene, perf)
    assert st.active_finest_tier.startswith("cts_pair") and st.active_coarsest_tier.startswith("cts_single")
    if scene == "three":
        assert st.active_mid_tiers[1].startswith("cts_single")
    assert st.active_collide_levels == ((1,) if perf == SFV_ALL else ())
    ref = reference_run(scene)[1]
    for l, (a, b) in enumerate(zip(out, ref)):
        diff = float(np.abs(a - b).max())
        assert diff < 5e-6, f"level {l}: fused route diverges from xlb_tpu's jnp tier by {diff}"
    # per coarse step: the coarsest single and the finest pair, or the
    # coarsest single, 2 middle singles and 2 finest pairs
    assert CollideThenStream.plain_calls - calls[0] == 2 * (2 if scene == "two" else 5)
    # the coarsest level's collide runs in the fused single pass, not K5
    assert LevelCollide.plain_calls == calls[1]
    _, win, _ = port_run(scene, perf, window=True)
    for l, (a, w) in enumerate(zip(out, win)):
        np.testing.assert_allclose(w, a, rtol=2e-6, atol=1e-7, err_msg=f"window vs per-step calls, level {l}")


def test_bf16_shifted_window_tracks_f32():
    """FP32BF16 runs every fused level in deviation form; per call and
    through the window it tracks FP32FP32 to the bf16 deviation scale."""
    res = {}
    for policy in ("FP32FP32", "FP32BF16"):
        st, per_call, _ = port_run("two", FUSED, policy=policy)
        assert st._cts_shifted == (policy == "FP32BF16")
        res[policy] = (per_call, port_run("two", FUSED, window=True, policy=policy)[1])
    for k in range(2):
        for l, (a, b) in enumerate(zip(res["FP32FP32"][k], res["FP32BF16"][k])):
            diff = float(np.abs(a - b).max())
            assert diff < 6e-3, f"bf16-shifted multires diverges from f32 at level {l} (path {k}): {diff}"


@pytest.mark.parametrize("extra", [("FullwayBounceBackBC", ((8,), (8,), (8,))), ("HalfwayBounceBackBC", ((3,), (8,), (8,)))],
                         ids=["fullway-inside", "halfway-shell-inside"])
@pytest.mark.parametrize("perf", [FUSED, SFV_ALL])
def test_coarse_bc_inside_refined_region_gate(perf, extra):
    """A coarsest-level BC voxel inside the refined region (for a halfway
    BC: its dilated shell) keeps the coarsest level off the fused pass with
    a RuntimeWarning; the result still matches the TORCH tier (which
    test_torch_tier_matches_jnp_tier holds to xlb_tpu's). Under
    FUSION_AT_FINEST_SFV_ALL the coarsest collide then runs through K5
    (its plain version here)."""
    from xlb_tpu_torch.kernels.collide_only import LevelCollide

    calls = LevelCollide.plain_calls
    with pytest.warns(RuntimeWarning, match="inside the refined region"):
        st, out, _ = port_run("two", perf, steps=1, extra_coarse_bc=extra)
    assert st._coarse_bc_placement_ok() is False and st.active_coarsest_tier.startswith("torch")
    assert LevelCollide.plain_calls == calls + (perf == SFV_ALL)
    _, ref, _ = port_run("two", NAIVE, steps=1, extra_coarse_bc=extra)
    for l, (a, b) in enumerate(zip(out, ref)):
        assert float(np.abs(a - b).max()) < 5e-6, f"level {l}"


def test_unported_pieces_raise():
    from xlb_tpu_torch.grid.multires import MultiresGrid
    from xlb_tpu_torch.models.multires import MultiresIncompressibleNavierStokesStepper
    from xlb_tpu_torch.velocity_set import D3Q19

    import xlb_tpu_torch

    xlb_tpu_torch.init(D3Q19())
    grid = MultiresGrid((8, 8, 8), boxes=[((2, 2, 2), (4, 4, 4))], device="cpu")
    for collision in ("KBC", "SmagorinskyLESBGK"):
        with pytest.raises(NotImplementedError, match="Queue A step 8"):
            MultiresIncompressibleNavierStokesStepper(grid, collision_type=collision)


def test_simulation_manager():
    """run(3, window=2) is one window and one step; export_macroscopic
    gives per-level (rho, u)."""
    import torch

    from xlb_tpu_torch.helper import MultiresSimulationManager
    from xlb_tpu_torch.mres_perf_optimization_type import MresPerfOptimizationType

    st, _ = build_mres("xlb_tpu_torch", "two", FUSED)
    sim = MultiresSimulationManager(st.grid, OMEGA, boundary_conditions=st.boundary_conditions,
                                    mres_perf_opt=MresPerfOptimizationType.FUSION_AT_FINEST)
    f0 = [f.clone() for f in sim.f_0]
    sim.run(3, window=2)
    assert sim.iteration_idx == 3
    ref = f0
    for _ in range(3):
        ref = sim.stepper(ref, sim.bc_mask, sim.missing_mask, OMEGA)
    for a, b in zip(sim.f_0, ref):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=1e-7)
    mac = sim.export_macroscopic()
    assert [m[0].shape for m in mac] == [(1, 16, 16, 16), (1, 16, 16, 16)] and mac[1][1].shape == (3, 16, 16, 16)
    assert abs(float(mac[1][0].mean()) - 1.0) < 1e-2


# ---------------------------------------------------------------------------
# The kernels' plain versions against xlb_tpu's interpret-mode kernels
# ---------------------------------------------------------------------------
EXT = (8, 16, 8)  # one (8, 16) tile of xlb_tpu's thin kernel
RING = (2, 2, 1)  # even x/y rings: xlb_tpu's in-kernel coalescence needs them


@functools.lru_cache(maxsize=None)
def kernel_inputs(shape, ring, store_key, seed=0):
    """A seeded box with a 254 ring, a solid block, and a fullway, an
    equilibrium and a halfway (moving wall) BC, as (f store-form float32
    NumPy, packed int32 mask, specs)."""
    from xlb_tpu_torch.velocity_set import D3Q19

    vs = D3Q19()
    rng = np.random.default_rng(seed)
    w = vs._w.reshape(-1, 1, 1, 1)
    noise = rng.standard_normal((19,) + shape)
    shifted = STORES[store_key][2]
    f = (0.02 * w * noise if shifted else w * (1.0 + 0.05 * noise)).astype(np.float32)
    f = np.asarray(jnp.asarray(f).astype(STORES[store_key][0]).astype(jnp.float32))
    bc = np.zeros(shape, np.int64)
    interior = tuple(slice(g, n - g) for g, n in zip(ring, shape))
    ring_cells = np.ones(shape, bool)
    ring_cells[interior] = False
    bc[3:5, 6:8, 3:5] = 255
    bc[2, 9:12, 2:6] = 5
    bc[5, 3:6, 4] = 6
    bc[2:4, 3, 2] = 7
    bc[ring_cells] = 254
    miss = rng.random((19,) + shape) < 0.2
    miss[0] = False
    packed = bc << 19
    for l in range(19):
        packed |= miss[l].astype(np.int64) << l
    specs = [
        {"kind": "fullway", "id": 5, "step": "collision"},
        {"kind": "equilibrium", "id": 6, "step": "streaming", "feq": (vs._w * 1.01).astype(np.float32)},
        {"kind": "halfway", "id": 7, "step": "streaming", "mw": 6.0 * vs._w * (vs._c.T @ np.array([0.01, 0.0, 0.0]))},
    ]
    return f, packed.astype(np.int32), specs


def assert_held(ours, ref, store_key):
    """float32: roundoff (rtol 1e-6, atol 1e-7); bf16-shifted: 8 bf16 ulps
    of each entry and of its direction's median |ref|."""
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    if store_key == "f32":
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
        return
    rtol = 8 * float(jnp.finfo(jnp.bfloat16).eps)
    atol = rtol * np.median(np.abs(ref).reshape(ref.shape[0], -1), axis=1).reshape((-1,) + (1,) * (ref.ndim - 1))
    assert (np.abs(ours - ref) <= atol + rtol * np.abs(ref)).all(), float(np.abs(ours - ref).max())


def _port_cts(store_key, shape, specs, **kw):
    import torch

    from xlb_tpu_torch.kernels.collide_then_stream import CollideThenStream
    from xlb_tpu_torch.velocity_set import D3Q19

    _, tname, shifted = STORES[store_key]
    return CollideThenStream(D3Q19(), shape, bc_specs=specs, store_dtype=getattr(torch, tname), shifted=shifted, **kw)


@pytest.mark.parametrize("mode,store", [("pair+coalesce", "f32"), ("pair+coalesce", "bf16-shifted"),
                                        ("single", "bf16-shifted"), ("single+ring_freeze+coalesce", "f32")])
def test_plain_k7_matches_xlb_tpu_kernel(mode, store):
    """K7 in its modes; each store form meets a pair and a single sub-step
    (one interpret-mode call takes ~4 s here, so not every pairing runs)."""
    import torch

    from xlb_tpu.kernels.collide_then_stream import build_fused_cts_pair_thin
    from xlb_tpu.velocity_set import D3Q19 as JD3Q19

    jstore, tname, shifted = STORES[store]
    f, packed, specs = kernel_inputs(EXT, RING, store)
    pair, freeze, coalesce = mode.startswith("pair"), "ring_freeze" in mode, "coalesce" in mode
    ref = build_fused_cts_pair_thin(JD3Q19(), EXT, bc_specs=specs, store_dtype=jstore, tile=(8, 16), interpret=True,
                                    pair=pair, shifted=shifted, coalesce_out=coalesce,
                                    ring_freeze=RING if freeze else None)(jnp.asarray(f).astype(jstore), jnp.asarray(packed), OMEGA)
    ours = _port_cts(store, EXT, specs, pair=pair, ring=RING, ring_freeze=freeze, coalesce=coalesce)(
        torch.tensor(f).to(getattr(torch, tname)), torch.tensor(packed), OMEGA)
    if coalesce:
        (ref, ref2), (ours, avg) = ref, ours
        # finish xlb_tpu's x/y-summed side output as its stepper does
        X, Y, Z = EXT
        gx, gy, gz = RING
        sl = np.asarray(ref2.astype(jnp.float32))[:, gx // 2 : (X - gx) // 2, gy // 2 : (Y - gy) // 2, gz : Z - gz]
        assert_held(avg.numpy(), sl.reshape(sl.shape[:-1] + (sl.shape[-1] // 2, 2)).sum(-1) * np.float32(0.125), store)
    assert ours.dtype == getattr(torch, tname)
    assert_held(ours.float().numpy(), as_f32(ref), store)


def test_plain_k6_matches_xlb_tpu_kernel():
    """K6's configuration: the pair over one common ring, no side output
    (float32: the bf16-shifted pair is held in the K7 test, through the
    same code)."""
    import torch

    from xlb_tpu.kernels.collide_then_stream import build_fused_collide_then_stream
    from xlb_tpu.velocity_set import D3Q19 as JD3Q19

    store = "f32"
    jstore, tname, shifted = STORES[store]
    shape = (8, 8, 8)
    f, packed, specs = kernel_inputs(shape, (2, 2, 2), store, seed=1)
    ref = build_fused_collide_then_stream(JD3Q19(), shape, bc_specs=specs, store_dtype=jstore, tile=(8, 8),
                                          interpret=True, pair=True, shifted=shifted)(
        jnp.asarray(f).astype(jstore), jnp.asarray(packed), OMEGA)
    ours = _port_cts(store, shape, specs, pair=True, ring=(2, 2, 2))(
        torch.tensor(f).to(getattr(torch, tname)), torch.tensor(packed), OMEGA)
    assert_held(ours.float().numpy(), as_f32(ref), store)


def test_plain_k5_matches_xlb_tpu_kernel():
    import torch

    from xlb_tpu.kernels.collide_only import build_level_collide
    from xlb_tpu.velocity_set import D3Q19 as JD3Q19

    from xlb_tpu_torch.kernels.collide_only import LevelCollide
    from xlb_tpu_torch.velocity_set import D3Q19

    shape = (6, 10, 7)  # N = 420: the TPU kernel pads it to a tile multiple
    f, packed, specs = kernel_inputs(shape, (1, 1, 1), "f32", seed=2)
    ref = build_level_collide(JD3Q19(), shape, bc_specs=specs, interpret=True)(jnp.asarray(f), jnp.asarray(packed), OMEGA)
    kernel = LevelCollide(D3Q19(), shape, bc_specs=specs)
    assert [s["kind"] for s in kernel.bc_specs] == ["fullway"]
    ours = kernel(torch.tensor(f), torch.tensor(packed), OMEGA)
    assert_held(ours.numpy(), as_f32(ref), "f32")


@pytest.mark.parametrize("pair", [False, True])
def test_cts_result_ignores_all_but_the_innermost_ring_layer(pair):
    """The same core and innermost ring layer inside rings of width 1 and 3
    (the outer layers holding noise) give the same core, bit for bit; and
    the pair equals two single sub-steps with the ring frozen."""
    import torch

    f, packed, specs = kernel_inputs((10, 12, 10), (1, 1, 1), "f32", seed=4)
    noise = np.random.default_rng(5).random((19, 14, 16, 14)).astype(np.float32) * 0.05
    f3 = noise.copy()
    f3[:, 2:-2, 2:-2, 2:-2] = f
    p3 = np.full((14, 16, 14), 254 << 19, np.int32)
    p3[2:-2, 2:-2, 2:-2] = packed
    small = _port_cts("f32", (10, 12, 10), specs, pair=pair, ring=(1, 1, 1), ring_freeze=True)
    large = _port_cts("f32", (14, 16, 14), specs, pair=pair, ring=(3, 3, 3), ring_freeze=True)
    a = small(torch.tensor(f), torch.tensor(packed), OMEGA)
    b = large(torch.tensor(f3), torch.tensor(p3), OMEGA)
    assert torch.equal(a[:, 1:-1, 1:-1, 1:-1], b[:, 3:-3, 3:-3, 3:-3])
    if pair:
        one = _port_cts("f32", (10, 12, 10), specs, ring=(1, 1, 1), ring_freeze=True)
        g = torch.tensor(f)
        assert torch.equal(a, one(one(g, torch.tensor(packed), OMEGA), torch.tensor(packed), OMEGA))


def test_cts_and_collide_wrappers_reject_what_the_kernels_do_not_take():
    import torch

    from xlb_tpu_torch.kernels.collide_only import LevelCollide, collide_specs
    from xlb_tpu_torch.kernels.collide_then_stream import CollideThenStream
    from xlb_tpu_torch.velocity_set import D3Q19

    vs = D3Q19()
    with pytest.raises(NotImplementedError):
        CollideThenStream(vs, (6, 6, 6), bc_specs=[{"kind": "zouhe", "id": 3, "step": "streaming"}])
    with pytest.raises(ValueError):
        CollideThenStream(vs, (7, 6, 6), ring=(1, 1, 1), coalesce=True)  # odd core
    with pytest.raises(NotImplementedError):
        collide_specs([{"kind": "extrapolation_outflow", "id": 3, "step": "collision"}])
    kernel = LevelCollide(vs, (4, 4, 4))
    for bad in (torch.zeros((19, 4, 4, 4), dtype=torch.bfloat16), torch.zeros((19, 4, 4, 3)),
                torch.zeros((19, 4, 4, 4)).requires_grad_(True)):
        with pytest.raises((ValueError, TypeError, RuntimeError)):
            kernel(bad, torch.zeros((4, 4, 4), dtype=torch.int32), OMEGA)
