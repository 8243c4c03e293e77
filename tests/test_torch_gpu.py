"""Tests of xlb_tpu_torch's CUDA kernels on the card: each kernel against
its plain version on a small seeded cavity, and the CUDA-tier window
against the TORCH tier. They skip without a CUDA device. (torch is
imported inside the tests; test_torch_setup.py says why.)

This file imports nothing of JAX, so it also runs on a machine without it
(there, skip tests/conftest.py, which configures JAX)::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest

SHAPE = (24, 20, 36)  # non-cubic, ragged against the k-step tiles
OMEGA = 1.9


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _reset_port_state():
    from xlb_tpu_torch import DefaultConfig
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry

    DefaultConfig.reset()
    boundary_condition_registry.reset()


@pytest.fixture(autouse=True)
def _reset_port():
    _reset_port_state()
    yield


def _cavity(policy, backend, device):
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary import EquilibriumBC, FullwayBounceBackBC
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.velocity_set import D3Q19

    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend[backend],
             default_precision_policy=xlb.PrecisionPolicy[policy])
    grid = xlb.grid_factory(SHAPE, device=device)
    box, box_ne = grid.bounding_box_indices(), grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1
    )
    bcs = [FullwayBounceBackBC(indices=walls.tolist()), EquilibriumBC(rho=1.0, u=(0.02, 0.0, 0.0), indices=box_ne["top"])]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    return stepper, stepper.prepare_fields()


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_kernels_match_plain_versions(cuda_device, store):
    import torch

    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    store = getattr(torch, store)
    stepper, (_, _, bc_mask, missing_mask) = _cavity("FP32FP32", "TORCH", cuda_device)
    vs = stepper.velocity_set
    specs = [bc_to_spec(bc, vs) for bc in stepper.boundary_conditions]
    mask = pack_masks(bc_mask, missing_mask)
    shifted = store == torch.bfloat16
    w = torch.as_tensor(vs._w, dtype=torch.float32).reshape(-1, 1, 1, 1)
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal((vs.q,) + SHAPE).astype(np.float32))
    f = ((0.02 * w * noise) if shifted else (w * (1.0 + 0.05 * noise))).to(store).to(cuda_device)
    eps = torch.finfo(store).eps
    # f32: reassociation and FMA contraction; bf16: the store dtype's 8-ulp bound
    tol = dict(rtol=1e-5, atol=1e-6) if store == torch.float32 else dict(rtol=8 * eps, atol=8 * eps * 0.05)
    for kernel in (CollideStreamStep, CollideStreamKStep):
        fused = kernel(vs, SHAPE, bc_specs=specs, store_dtype=store, shifted=shifted, has_solids=stepper.has_solids)
        torch.testing.assert_close(fused(f, mask, OMEGA).float(), fused.plain(f, mask, OMEGA).float(), **tol)


@pytest.mark.gpu
def test_cuda_window_matches_torch_tier(cuda_device):
    """21 steps: the fused window (k-step + single-step kernels) against the
    plain TORCH tier on the card, FP32FP32 (rtol 1e-4: float32 roundoff and
    FMA contraction over 21 steps)."""
    import torch

    from xlb_tpu_torch import ComputeBackend
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    cuda, (f_0, f_1, bc_mask, missing_mask) = _cavity("FP32FP32", "CUDA", cuda_device)
    plain = IncompressibleNavierStokesStepper(cuda.grid, cuda.boundary_conditions, compute_backend=ComputeBackend.TORCH)
    a, _ = cuda.build_multi_step(21)(f_0, f_1, bc_mask, missing_mask, OMEGA)
    b, _ = plain.build_multi_step(21)(f_0.clone(), f_1.clone(), bc_mask, missing_mask, OMEGA)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("solid", [True, False])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_adjoint_kernel_matches_plain_version(cuda_device, store, solid):
    """The adjoint kernel against torch.func.vjp of the plain step, with a
    solid block (cell type 255) or without. The hand-derived transpose and
    autograd sum the same O(1) terms in other orders (and nvcc contracts
    into FMAs), so df's near-zero entries keep a few float32 ulps of
    |g| ~ 1 (atol 1e-6)."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    store = getattr(torch, store)
    stepper, (_, _, bc_mask, missing_mask) = _cavity("FP32FP32", "TORCH", cuda_device)
    vs = stepper.velocity_set
    specs = [bc_to_spec(bc, vs) for bc in stepper.boundary_conditions]
    mask = pack_masks(bc_mask, missing_mask)
    if solid:
        mask[6:12, 5:10, 10:20] = 255 << 19
    shifted = store == torch.bfloat16
    rng = np.random.default_rng(1)
    w = torch.as_tensor(vs._w, dtype=torch.float32).reshape(-1, 1, 1, 1)
    noise = torch.from_numpy(rng.standard_normal((vs.q,) + SHAPE).astype(np.float32))
    f = ((0.02 * w * noise) if shifted else (w * (1.0 + 0.05 * noise))).to(store).to(cuda_device)
    g = (w * torch.from_numpy(rng.standard_normal((vs.q,) + SHAPE).astype(np.float32))).to(cuda_device)
    adjoint = CollideStreamAdjoint(vs, SHAPE, bc_specs=specs, store_dtype=store, shifted=shifted, has_solids=solid)
    launches = CollideStreamAdjoint.launches
    df, dom = adjoint(f, g, mask, 1.5)
    assert CollideStreamAdjoint.launches == launches + 1
    df_ref, dom_ref = adjoint.plain(f, g, mask, 1.5)
    torch.testing.assert_close(df, df_ref, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dom, dom_ref, rtol=1e-4, atol=1e-7)


@pytest.mark.gpu
def test_cuda_window_gradients_match_torch_tier(cuda_device):
    """torch.autograd through the CUDA-tier window (adjoint kernel) against
    the TORCH tier's autograd over 5 FP32FP32 steps."""
    import torch

    from xlb_tpu_torch import ComputeBackend
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    cuda, (f_0, f_1, bc_mask, missing_mask) = _cavity("FP32FP32", "CUDA", cuda_device)
    plain = IncompressibleNavierStokesStepper(cuda.grid, cuda.boundary_conditions, compute_backend=ComputeBackend.TORCH)
    noise = torch.from_numpy(np.random.default_rng(2).standard_normal(tuple(f_0.shape)).astype(np.float32))
    f_in = f_0 * (1.0 + 0.05 * noise.to(cuda_device))
    grads = []
    for stepper in (cuda, plain):
        f = f_in.clone().requires_grad_(True)
        omega = torch.tensor(1.5, device=cuda_device, requires_grad=True)
        out, _ = stepper.build_multi_step(5)(f, f_1, bc_mask, missing_mask, omega)
        (out**2).sum().backward()
        grads.append((f.grad, omega.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=2e-4, atol=1e-6)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=2e-3, atol=0.0)


SHAPE_2D = (72, 52)  # ragged against the k-step's 32 x 48 tiles


def _scene_2d(kind, backend, device, policy="FP32FP32"):
    """The 2D scenes of chip_smoke.py at SHAPE_2D: "cavity" (fullway walls),
    "halfway_cavity" (moving halfway walls and a solid block), or the
    cylinder with "zouhe" or "regularized" inlet and outlet."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary import (EquilibriumBC, FullwayBounceBackBC, HalfwayBounceBackBC, RegularizedBC,
                                        ZouHeBC)
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.velocity_set import D2Q9

    xlb.init(velocity_set=D2Q9(), default_backend=xlb.ComputeBackend[backend],
             default_precision_policy=xlb.PrecisionPolicy[policy])
    grid = xlb.grid_factory(SHAPE_2D, device=device)
    box, box_ne = grid.bounding_box_indices(), grid.bounding_box_indices(remove_edges=True)
    nx, ny = SHAPE_2D
    if kind in ("cavity", "halfway_cavity"):
        walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right")], axis=1), axis=1)
        wall = (FullwayBounceBackBC(indices=walls.tolist()) if kind == "cavity"
                else HalfwayBounceBackBC(indices=walls.tolist(), prescribed_value=(0.01, 0.0)))
        bcs = [wall, EquilibriumBC(rho=1.0, u=(0.05, 0.0), indices=box_ne["top"])]
    else:
        d = ny // 4
        X, Y = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        cyl = np.array(np.nonzero((X - nx // 4) ** 2 + (Y - ny // 2 - 1) ** 2 <= (d / 2) ** 2))
        walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top")], axis=1), axis=1)
        inout = ZouHeBC if kind == "zouhe" else RegularizedBC
        bcs = [FullwayBounceBackBC(indices=walls.tolist()), inout("velocity", prescribed_value=(0.04, 0.0), indices=box_ne["left"]),
               inout("pressure", prescribed_value=1.0, indices=box_ne["right"]), HalfwayBounceBackBC(indices=cyl.tolist())]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    return stepper, stepper.prepare_fields()


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["cavity", "halfway_cavity", "zouhe", "regularized"])
def test_2d_kernels_match_plain_versions(cuda_device, kind, store):
    """K3 and K4 (k = 2, 8) against their plain versions for every 2D BC
    kind: equilibrium and fullway (cavity), halfway with a moving wall and
    a solid block, Zou-He and regularized with the cylinder's solid
    interior. f32: reassociation and FMA contraction; bf16: 8 bf16 ulps,
    of each entry and of its direction's median magnitude (so a lost or
    swapped direction fails). Each K4 equals k K3 launches bit for bit."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep, CollideStream2DStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    store = getattr(torch, store)
    stepper, (_, _, bc_mask, missing_mask) = _scene_2d(kind, "TORCH", cuda_device)
    vs = stepper.velocity_set
    specs = [bc_to_spec(bc, vs) for bc in stepper.boundary_conditions]
    mask = pack_masks(bc_mask, missing_mask)
    if kind == "halfway_cavity":
        mask[30:40, 20:28] = 255 << 19
    shifted = store == torch.bfloat16
    w = torch.as_tensor(vs._w, dtype=torch.float32).reshape(-1, 1, 1)
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal((vs.q,) + SHAPE_2D).astype(np.float32))
    f = ((0.02 * w * noise) if shifted else (w * (1.0 + 0.05 * noise))).to(store).to(cuda_device)
    kw = dict(bc_specs=specs, store_dtype=store, shifted=shifted, has_solids=True)
    one = CollideStream2DStep(vs, SHAPE_2D, **kw)
    for fused in [one] + [CollideStream2DKStep(vs, SHAPE_2D, steps=k, **kw) for k in (2, 8)]:
        launches = type(fused).launches
        out, ref = fused(f, mask, 1.6), fused.plain(f, mask, 1.6)
        assert type(fused).launches == launches + 1
        if shifted:
            rtol = 8 * torch.finfo(store).eps
            atol = rtol * ref.float().abs().flatten(1).median(dim=1).values.reshape(-1, 1, 1)
            assert bool(((out.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()).all())
        else:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
        if fused is not one:
            g = f
            for _ in range(fused.steps):
                g = one(g, mask, 1.6)
            assert torch.equal(out, g)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["cavity", "regularized"])
def test_2d_cuda_window_matches_torch_tier(cuda_device, kind):
    """21 steps: the 2D fused window (two K4 calls at k = 8 and five K3)
    against the plain TORCH tier on the card, FP32FP32 (rtol 1e-4: float32
    roundoff and FMA contraction over 21 steps)."""
    import torch

    from xlb_tpu_torch import ComputeBackend
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    cuda, (f_0, f_1, bc_mask, missing_mask) = _scene_2d(kind, "CUDA", cuda_device)
    plain = IncompressibleNavierStokesStepper(cuda.grid, cuda.boundary_conditions, compute_backend=ComputeBackend.TORCH)
    a, _ = cuda.build_multi_step(21)(f_0, f_1, bc_mask, missing_mask, 1.6)
    b, _ = plain.build_multi_step(21)(f_0.clone(), f_1.clone(), bc_mask, missing_mask, 1.6)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def _mres(perf, device, policy="FP32FP32", levels=2):
    """A small walled multires cavity on ``device``: a 24^3 coarse level
    (fullway walls, equilibrium lid), a centred 12^3 box (two of them with
    ``levels`` = 3, the middle level BC-less), a halfway solid block on the
    finest level."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary import EquilibriumBC, FullwayBounceBackBC, HalfwayBounceBackBC
    from xlb_tpu_torch.grid import Grid, MultiresGrid
    from xlb_tpu_torch.models.multires import MultiresIncompressibleNavierStokesStepper
    from xlb_tpu_torch.mres_perf_optimization_type import MresPerfOptimizationType
    from xlb_tpu_torch.velocity_set import D3Q19

    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend.TORCH,
             default_precision_policy=xlb.PrecisionPolicy[policy])
    grid = MultiresGrid((24, 24, 24), boxes=[((6, 6, 6), (12, 12, 12))] * (levels - 1), device=device)
    helper = Grid((24, 24, 24), device="cpu")
    box, box_ne = helper.bounding_box_indices(), helper.bounding_box_indices(remove_edges=True)
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1)
    block = np.stack([a.ravel() for a in np.meshgrid(*[np.arange(10, 14)] * 3, indexing="ij")])
    bcs = {levels - 1: [FullwayBounceBackBC(indices=walls.tolist()), EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["top"])],
           0: [HalfwayBounceBackBC(indices=block.tolist())]}
    st = MultiresIncompressibleNavierStokesStepper(grid, boundary_conditions=bcs,
                                                   mres_perf_opt=MresPerfOptimizationType.from_string(perf))
    fs, _, bms, mms = st.prepare_fields()
    rng = np.random.default_rng(7)
    import torch

    fs = [(f.float() + 0.01 * torch.from_numpy(rng.random(tuple(f.shape)).astype(np.float32)).to(device)).to(f.dtype)
          for f in fs]
    return st, fs, bms, mms


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["pair+coalesce", "pair", "single", "single+freeze+coalesce"])
def test_multires_kernels_match_plain_versions(cuda_device, mode, store):
    """K7 (and K6's configuration, "pair") against its plain version on the
    finest ring box of a walled cavity (halfway solid block, 254 ring):
    f32 to reassociation and FMA contraction, bf16-shifted within 8 bf16
    ulps of each entry and of its direction's median magnitude; the pair
    with ring freeze bit-equal to two single launches."""
    import torch

    from xlb_tpu_torch.kernels.collide_then_stream import CollideThenStream

    st, fs, bms, mms = _mres("fusion_at_finest", cuda_device)
    mask = st._fine_mask_ext(bms, mms)
    store = getattr(torch, store)
    shifted = store == torch.bfloat16
    w = st._w_col(cuda_device)
    f = torch.nn.functional.pad(fs[0].float() - (w if shifted else 0), (1, 1, 1, 1, 1, 1)).to(store).contiguous()
    freeze, coalesce = "freeze" in mode or mode == "pair+coalesce", "coalesce" in mode
    kw = dict(bc_specs=st._cts.bc_specs, store_dtype=store, shifted=shifted, ring_freeze=freeze, coalesce=coalesce)
    kern = CollideThenStream(st.velocity_set, tuple(mask.shape), pair=mode.startswith("pair"), **kw)
    launches = CollideThenStream.launches
    out, ref = kern(f, mask, 1.6), kern.plain(f, mask, 1.6)
    assert CollideThenStream.launches == launches + 1
    outs, refs = (out, ref) if coalesce else ((out,), (ref,))
    for o, r in zip(outs, refs):
        if shifted:
            rtol = 8 * torch.finfo(store).eps
            atol = rtol * r.float().abs().flatten(1).median(dim=1).values.reshape(-1, 1, 1, 1)
            assert bool(((o.float() - r.float()).abs() <= atol + rtol * r.float().abs()).all())
        else:
            torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-6)
    if mode == "pair+coalesce":
        one = CollideThenStream(st.velocity_set, tuple(mask.shape), **kw)
        two = one(one(f, mask, 1.6)[0], mask, 1.6)
        assert torch.equal(out[0], two[0]) and torch.equal(out[1], two[1])


@pytest.mark.gpu
def test_collide_only_kernel_matches_plain_version(cuda_device):
    import torch

    from xlb_tpu_torch.kernels.collide_only import LevelCollide
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    st, fs, bms, mms = _mres("fusion_at_finest_sfv_all", cuda_device)
    mask = pack_masks(bms[1], mms[1])
    mask[2:5, 2:5, 2:5] = 255 << 19
    kern = LevelCollide(st.velocity_set, st.grid.levels[1].shape,
                        bc_specs=[bc_to_spec(b, st.velocity_set) for b in st.boundary_conditions[1]])
    f = fs[1].float().contiguous()
    torch.testing.assert_close(kern(f, mask, 1.6), kern.plain(f, mask, 1.6), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("perf,levels", [("fusion_at_finest", 2), ("fusion_at_finest", 3), ("fusion_at_finest_sfv_all", 2)])
def test_multires_cuda_tier_matches_torch_tier(cuda_device, perf, levels):
    """3 coarse steps of the fused routes (kernels on the card) against the
    TORCH tier from a perturbed state, per call and through the window
    (5e-6, xlb_tpu's fused-vs-naive bound)."""
    import torch

    from xlb_tpu_torch.kernels.collide_then_stream import CollideThenStream
    from xlb_tpu_torch.models.multires import MultiresIncompressibleNavierStokesStepper

    st, fs, bms, mms = _mres(perf, cuda_device, levels=levels)
    plain = MultiresIncompressibleNavierStokesStepper(st.grid, boundary_conditions=st.boundary_conditions)
    launches, plain_calls = CollideThenStream.launches, CollideThenStream.plain_calls
    a, b = list(fs), list(fs)
    for _ in range(3):
        a = st(a, bms, mms, 1.6)
        b = plain(b, bms, mms, 1.6)
    assert CollideThenStream.launches > launches and CollideThenStream.plain_calls == plain_calls
    c = st.build_window(3)(list(fs), bms, mms, 1.6)
    for x, y, z in zip(a, b, c):
        assert float((x.float() - y.float()).abs().max()) < 5e-6
        assert float((z.float() - y.float()).abs().max()) < 5e-6


# the 3D collision zoo: (collision, q) pairs of the CUDA kernels K0, K1, K2
ZOO = [("BGK", 19), ("SmagorinskyLESBGK", 19), ("TRT", 19), ("MRT", 19), ("PowerLawBGK", 19), ("BGK", 27),
       ("KBC", 27)]
ZOO_SHAPE = (20, 18, 36)  # ragged against the k-step and blocked tiles


def _zoo_scene(kind, collision, q, device, backend="TORCH", policy="FP32FP32", shape=ZOO_SHAPE):
    """A D3Q``q`` scene with ``collision``: "cavity" (fullway walls,
    equilibrium lid) or "channel" (halfway walls in z, a body force)."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary import EquilibriumBC, FullwayBounceBackBC, HalfwayBounceBackBC
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.velocity_set import D3Q19, D3Q27

    xlb.init(velocity_set={19: D3Q19, 27: D3Q27}[q](), default_backend=xlb.ComputeBackend[backend],
             default_precision_policy=xlb.PrecisionPolicy[policy])
    grid = xlb.grid_factory(shape, device=device)
    box = grid.bounding_box_indices()
    kw = dict(collision_type=collision,
              collision_params={"consistency": 0.05, "power_index": 0.8} if collision == "PowerLawBGK" else None)
    if kind == "cavity":
        walls = np.unique(
            np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1)
        bcs = [FullwayBounceBackBC(indices=walls.tolist()),
               EquilibriumBC(rho=1.0, u=(0.02, 0.0, 0.0), indices=grid.bounding_box_indices(remove_edges=True)["top"])]
    else:
        walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top")], axis=1), axis=1)
        bcs = [HalfwayBounceBackBC(indices=walls.tolist())]
        kw["force_vector"] = np.array([2e-5, 0.0, 0.0])
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, **kw)
    return stepper, stepper.prepare_fields()


def _held(a, ref, store):
    """f32: rtol 1e-5, atol 1e-6; bf16 deviation form: 8 bf16 ulps of each
    entry and of its direction's median |ref|."""
    import torch

    a, ref = a.float(), ref.float()
    if store == torch.float32:
        torch.testing.assert_close(a, ref, rtol=1e-5, atol=1e-6)
        return
    rtol = 8 * torch.finfo(store).eps
    atol = rtol * ref.abs().flatten(1).median(dim=1).values.reshape(-1, 1, 1, 1)
    assert bool(((a - ref).abs() <= atol + rtol * ref.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["cavity", "channel"])
@pytest.mark.parametrize("collision,q", ZOO)
def test_zoo_kernels_match_plain_versions(cuda_device, collision, q, kind, store):
    """K1, K2 and K0 against their plain versions, with a solid block, on a
    seeded perturbed state; K0 (with its default and another tile) equals
    K1 and K2 two K1 launches, bit for bit (one collide_voxel, the same
    store-dtype rounding)."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream import kernel_collision_spec, packed_cell
    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_blocked import CollideStreamBlocked
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks, stepper_force_vector

    store = getattr(torch, store)
    stepper, (_, _, bc_mask, missing_mask) = _zoo_scene(kind, collision, q, cuda_device)
    vs = stepper.velocity_set
    mask = pack_masks(bc_mask, missing_mask)
    mask[6:12, 5:10, 10:20] = packed_cell(255, q)
    shifted = store == torch.bfloat16
    w = torch.as_tensor(vs._w, dtype=torch.float32).reshape(-1, 1, 1, 1)
    noise = torch.from_numpy(np.random.default_rng(q).standard_normal((vs.q,) + ZOO_SHAPE).astype(np.float32))
    f = ((0.02 * w * noise) if shifted else (w * (1.0 + 0.05 * noise))).to(store).to(cuda_device)
    kw = dict(collision=kernel_collision_spec(stepper), bc_specs=[bc_to_spec(b, vs) for b in stepper.boundary_conditions],
              store_dtype=store, shifted=shifted, has_solids=True, force_vector=stepper_force_vector(stepper))
    one, two = CollideStreamStep(vs, ZOO_SHAPE, **kw), CollideStreamKStep(vs, ZOO_SHAPE, steps=2, **kw)
    blocked = CollideStreamBlocked(vs, ZOO_SHAPE, **kw)
    k1, k2, k0 = one(f, mask, 1.7), two(f, mask, 1.7), blocked(f, mask, 1.7)
    _held(k1, one.plain(f, mask, 1.7), store)
    _held(k2, two.plain(f, mask, 1.7), store)
    _held(k0, blocked.plain(f, mask, 1.7), store)
    assert torch.equal(k0, k1)
    assert torch.equal(CollideStreamBlocked(vs, ZOO_SHAPE, tile=(2, 4, 16), **kw)(f, mask, 1.7), k1)
    assert torch.equal(k2, one(k1, mask, 1.7))


@pytest.mark.gpu
@pytest.mark.parametrize("collision,q", [("MRT", 19), ("KBC", 27)])
def test_zoo_cuda_tier_matches_torch_tier(cuda_device, collision, q):
    """10 FP32FP32 steps of the forced channel: the CUDA window (K2 + K1),
    the blocked window (K0) and stepper(...) against the TORCH tier."""
    import torch

    from xlb_tpu_torch import ComputeBackend
    from xlb_tpu_torch.kernels.fused_step import build_fused_window
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    cuda, (f_0, f_1, bc_mask, missing_mask) = _zoo_scene("channel", collision, q, cuda_device, "CUDA")
    torch_tier = IncompressibleNavierStokesStepper(cuda.grid, cuda.boundary_conditions, collision_type=collision,
                                                   force_vector=cuda.collision.force_vector,
                                                   compute_backend=ComputeBackend.TORCH)
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal(tuple(f_0.shape)).astype(np.float32))
    f_in = f_0 * (1.0 + 0.02 * noise.to(cuda_device))
    ref, _ = torch_tier.build_multi_step(10)(f_in.clone(), f_1, bc_mask, missing_mask, 1.7)
    for run in (cuda.build_multi_step(10), build_fused_window(cuda, 10, kernel="blocked")):
        out, _ = run(f_in.clone(), f_1, bc_mask, missing_mask, 1.7)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-6)
    a0, a1 = f_in.clone(), f_1.clone()
    for t in range(10):
        a0, a1 = cuda(a0, a1, bc_mask, missing_mask, 1.7, t)
        a0, a1 = a1, a0
    torch.testing.assert_close(a0, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["cavity", "channel"])
@pytest.mark.parametrize("collision,q", ZOO)
def test_zoo_adjoint_kernel_matches_plain_version(cuda_device, collision, q, kind, store):
    """K8 against its plain version (torch.func.vjp of the plain step) for
    every pair of the zoo, with a solid block, on a seeded perturbed primal
    and cotangent: the cavity (equilibrium, fullway) and the forced
    channel (halfway walls); rtol 1e-4, atol 1e-6 (df) and 1e-7 (dom), as
    the adjoint's own tests."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream import kernel_collision_spec, packed_cell
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks, stepper_force_vector

    store = getattr(torch, store)
    stepper, (_, _, bc_mask, missing_mask) = _zoo_scene(kind, collision, q, cuda_device)
    vs = stepper.velocity_set
    mask = pack_masks(bc_mask, missing_mask)
    mask[6:12, 5:10, 10:20] = packed_cell(255, q)
    shifted = store == torch.bfloat16
    w = torch.as_tensor(vs._w, dtype=torch.float32).reshape(-1, 1, 1, 1)
    rng = np.random.default_rng(q + 1)
    noise = torch.from_numpy(rng.standard_normal((vs.q,) + ZOO_SHAPE).astype(np.float32))
    f = ((0.02 * w * noise) if shifted else (w * (1.0 + 0.05 * noise))).to(store).to(cuda_device)
    g = (w * torch.from_numpy(rng.standard_normal((vs.q,) + ZOO_SHAPE).astype(np.float32))).to(cuda_device)
    adj = CollideStreamAdjoint(vs, ZOO_SHAPE, collision=kernel_collision_spec(stepper), store_dtype=store,
                               bc_specs=[bc_to_spec(b, vs) for b in stepper.boundary_conditions], shifted=shifted,
                               has_solids=True, force_vector=stepper_force_vector(stepper))
    launches = CollideStreamAdjoint.launches
    (df, dom), (pdf, pdom) = adj(f, g, mask, 1.7), adj.plain(f, g, mask, 1.7)
    assert CollideStreamAdjoint.launches == launches + 1
    torch.testing.assert_close(df, pdf, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dom, pdom, rtol=1e-4, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_many_bc_kernels_match_plain_versions(cuda_device, store):
    """K1, K2, K0 and K8 on the 15-BC cavity, K8 also on the 13 BCs without
    the halfway blocks, against their plain versions (f32: rtol 1e-5,
    atol 1e-6; bf16: the 8-ulp bound; the adjoint: rtol 1e-4, atol 1e-6 as
    its own test), K0 == K1 and K2 == two K1 launches bit for bit."""
    import torch

    from chip_smoke import many_bc_cavity
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_blocked import CollideStreamBlocked
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    store = getattr(torch, store)
    shifted = store == torch.bfloat16
    eps = torch.finfo(store).eps
    tol = dict(rtol=1e-5, atol=1e-6) if store == torch.float32 else dict(rtol=8 * eps, atol=8 * eps * 0.05)
    for halfway in (True, False):
        stepper, (_, _, bc_mask, missing_mask) = many_bc_cavity(SHAPE, cuda_device, halfway)
        vs = stepper.velocity_set
        specs = [bc_to_spec(bc, vs) for bc in stepper.boundary_conditions]
        assert len(specs) == (15 if halfway else 13)
        mask = pack_masks(bc_mask, missing_mask)
        w = torch.as_tensor(vs._w, dtype=torch.float32).reshape(-1, 1, 1, 1)
        noise = torch.from_numpy(np.random.default_rng(3).standard_normal((vs.q,) + SHAPE).astype(np.float32))
        f = ((0.02 * w * noise) if shifted else (w * (1.0 + 0.05 * noise))).to(store).to(cuda_device)
        kw = dict(bc_specs=specs, store_dtype=store, shifted=shifted, has_solids=stepper.has_solids)
        if halfway:
            one, blocked = CollideStreamStep(vs, SHAPE, **kw), CollideStreamBlocked(vs, SHAPE, **kw)
            two = CollideStreamKStep(vs, SHAPE, steps=2, **kw)
            k1, k0, k2 = one(f, mask, OMEGA), blocked(f, mask, OMEGA), two(f, mask, OMEGA)
            p1 = one.plain(f, mask, OMEGA)
            torch.testing.assert_close(k1.float(), p1.float(), **tol)
            torch.testing.assert_close(k2.float(), one.plain(p1, mask, OMEGA).float(), **tol)
            assert torch.equal(k0, k1) and torch.equal(k2, one(k1, mask, OMEGA))
        g = (w * torch.from_numpy(np.random.default_rng(4).standard_normal(f.shape).astype(np.float32))).to(cuda_device)
        adj = CollideStreamAdjoint(vs, SHAPE, **kw)
        for got, ref in zip(adj(f, g, mask, 1.5), adj.plain(f, g, mask, 1.5)):
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("collision,q,kind", [("TRT", 19, "cavity"), ("KBC", 27, "channel")])
def test_zoo_dma_step_differentiates_through_adjoint_kernel(cuda_device, collision, q, kind):
    """stepper(...) of the D3Q19 TRT cavity and of the forced D3Q27 KBC
    channel on the CUDA tier: the forward launches K1, the backward K8.
    Its gradients of f_0 and omega, and those of float32 TORCH-tier
    autograd, against float64 (FP64FP64) TORCH-tier autograd: the CUDA
    tier's error at most twice the float32 TORCH tier's plus 1e-6 (f_0)
    and 2e-3 relative (omega). KBC's float32 derivative is ill-conditioned
    on this state: both float32 tiers are ~4e-5 from float64, so the
    float32 TORCH tier is not a sharper reference than the kernel."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep

    grads = {}
    for backend, policy in (("CUDA", "FP32FP32"), ("TORCH", "FP32FP32"), ("TORCH", "FP64FP64")):
        _reset_port_state()
        stepper, (f_0, f_1, bc_mask, missing_mask) = _zoo_scene(kind, collision, q, cuda_device, backend, policy)
        noise = torch.from_numpy(np.random.default_rng(5).standard_normal(tuple(f_0.shape)).astype(np.float32))
        f = (f_0 * (1.0 + 0.02 * noise.to(cuda_device, f_0.dtype))).requires_grad_(True)
        omega = torch.tensor(1.5, device=cuda_device, dtype=f_0.dtype, requires_grad=True)
        launches = (CollideStreamStep.launches, CollideStreamAdjoint.launches)
        out = stepper(f, f_1, bc_mask, missing_mask, omega)[1]
        out.square().sum().backward()
        if backend == "CUDA":
            assert (CollideStreamStep.launches, CollideStreamAdjoint.launches) == (launches[0] + 1, launches[1] + 1)
        grads[backend, policy] = (f.grad.double(), float(omega.grad))
    ref, w_ref = grads["TORCH", "FP64FP64"]
    (df_c, dw_c), (df_t, dw_t) = grads["CUDA", "FP32FP32"], grads["TORCH", "FP32FP32"]
    assert float((df_c - ref).abs().max()) <= 2 * float((df_t - ref).abs().max()) + 1e-6
    assert abs(dw_c - w_ref) <= 2 * abs(dw_t - w_ref) + 2e-3 * abs(w_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["aligned", "offset"])
@pytest.mark.parametrize("shape", [
    (3, 17, 13, 11), (7, 5, 3), (19, 24, 20, 36),
    # the bulk copies' chunk plan at its edges: q above the resident blocks,
    # ranges shorter than a 16-byte word, a range of one chunk and of a chunk
    # plus a word ("chunk": copy_bandwidth.BULK_CHUNK // 4 floats), a prime q
    # that divides no persistent grid of 132 x k blocks
    (1000, 7), (5000, 7), (64, 3), (3, "chunk"), (3, "chunk + 1 word"), (131, 300),
])
def test_copy_probes_match_plain_versions(cuda_device, shape, where):
    """K9 under its three launch shapes, K10, K11 over the leading channels
    and K12's five variants against their plain versions, bit for bit, on
    ragged fields (420 bytes: not a multiple of 16) and at the edges of the
    bulk copies' chunk plan, aligned and 4 bytes past a 16-byte boundary."""
    import torch

    from xlb_tpu_torch.examples.performance.memory_bandwidth import LAUNCH_SHAPES
    from xlb_tpu_torch.kernels import copy_bandwidth as cb

    chunk = cb.BULK_CHUNK // 4
    shape = tuple({"chunk": chunk, "chunk + 1 word": chunk + 4}.get(s, s) for s in shape)
    n = int(np.prod(shape))
    base = torch.from_numpy(np.random.default_rng(16).standard_normal(n + 1).astype(np.float32)).to(cuda_device)
    x = (base[:n] if where == "aligned" else base[1:]).view(shape)
    kernels = [(cb.PipelinedCopy(t, v), cb.copy_plain) for t, v in LAUNCH_SHAPES]
    kernels += [(cb.BulkCopy(), cb.copy_plain), (cb.SplitBulkCopy(shape[0]), cb.copy_plain)]
    kernels += [(cb.ManualScaleCopy(*v), cb.scale_copy_plain) for v in cb.MANUAL_VARIANTS]
    for kernel, plain in kernels:
        launches = type(kernel).launches
        out = kernel(x)
        assert type(kernel).launches == launches + 1
        assert out.data_ptr() % 16 == x.data_ptr() % 16
        assert torch.equal(out, plain(x)), type(kernel).__name__


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sphere", "rotating", "zouhe"])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_open_kernels_match_plain_versions_on_the_card(cuda_device, kind, store):
    """K1, K2 (k = 2) and K0 against their plain versions at 40x20x24
    (f32: rtol 1e-5, atol 1e-6; bf16-shifted: 8 bf16 ulps, as chip_smoke's
    ``held``), K0 == K1 and K2 == two K1 launches bit for bit."""
    import torch

    import xlb_tpu_torch as xlb
    from chip_smoke import OPEN_OMEGA, held, open_kernels
    from chip_smoke import open_scene as port_scene
    from xlb_tpu_torch.kernels.fused_step import pack_masks

    shape = (40, 20, 24)
    stepper, (_, _, bc_mask, missing_mask) = port_scene(kind, shape, xlb.PrecisionPolicy.FP32FP32,
                                                        xlb.ComputeBackend.TORCH, cuda_device)
    dtype, shifted = getattr(torch, store), store == "bfloat16"
    w = torch.as_tensor(stepper.velocity_set._w, dtype=torch.float32, device=cuda_device).reshape(-1, 1, 1, 1)
    noise = torch.randn((stepper.velocity_set.q,) + shape, generator=torch.Generator(cuda_device).manual_seed(3),
                        device=cuda_device)
    f = ((0.02 * w * noise) if shifted else (w * (1.0 + 0.05 * noise))).to(dtype).contiguous()
    mask = pack_masks(bc_mask, missing_mask)
    (one, two, blocked), aux, _ = open_kernels(stepper, dtype, shifted)
    k1, k2, k0 = one(f, mask, OPEN_OMEGA, *aux), two(f, mask, OPEN_OMEGA, *aux), blocked(f, mask, OPEN_OMEGA, *aux)
    p1 = one.plain(f, mask, OPEN_OMEGA, *aux)
    for out, ref in ((k1, p1), (k0, p1), (k2, one.plain(p1, mask, OPEN_OMEGA, *aux))):
        assert held(out, ref, dtype)[1] <= 1.0
    assert torch.equal(k0, k1) and torch.equal(k2, one(k1, mask, OPEN_OMEGA, *aux))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["bounceback", "bounceback_regularized", "bounceback_grads",
                                    "nonequilibrium_regularized"])
@pytest.mark.parametrize("pair,variant", [(("D3Q19", "BGK"), (True, "static", "closed")),
                                          (("D3Q27", "KBC"), (False, "spin", "open"))])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_hybrid_kernels_match_plain_versions_on_the_card(cuda_device, method, pair, variant, store):
    """K1, K2 (k = 2) and K0 with the kExtHybrid epilogues against their
    plain versions on a hybrid_bcs tunnel at 40x20x24 (f32: rtol 1e-5, atol
    1e-6; bf16-shifted: 8 bf16 ulps, as chip_smoke's ``held``), K0 == K1 and
    K2 == two K1 launches bit for bit."""
    import torch

    from chip_smoke import HYBRID_OMEGA, held, hybrid_scene, open_kernels, perturbed
    from xlb_tpu_torch.kernels.fused_step import pack_masks

    shape = (40, 20, 24)
    stepper, (_, _, bc_mask, missing_mask) = hybrid_scene(pair, method, *variant, shape, cuda_device)
    dtype, shifted = getattr(torch, store), store == "bfloat16"
    f = perturbed(stepper.velocity_set, shape, dtype, shifted, 3, cuda_device)
    mask = pack_masks(bc_mask, missing_mask)
    (one, two, blocked), aux, _ = open_kernels(stepper, dtype, shifted)
    om = HYBRID_OMEGA
    k1, k2, k0 = one(f, mask, om, *aux), two(f, mask, om, *aux), blocked(f, mask, om, *aux)
    p1 = one.plain(f, mask, om, *aux)
    for out, ref in ((k1, p1), (k0, p1), (k2, one.plain(p1, mask, om, *aux))):
        assert held(out, ref, dtype)[1] <= 1.0
    assert torch.equal(k0, k1) and torch.equal(k2, one(k1, mask, om, *aux))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["bounceback", "nonequilibrium_regularized"])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_hybrid_2d_kernels_match_plain_versions_on_the_card(cuda_device, method, store):
    """K3 and K4 (k = 8) in their kExtHybrid form on the Schafer-Turek scene
    at D = 8 (177x34: the parabolic inlet through the aux field, the hybrid
    cylinder) against their plain versions, K4 == 8 K3 bit for bit; then 50
    steps of stepper(...) (K3) against the TORCH tier on the card."""
    import torch

    from chip_smoke import held, perturbed
    from xlb_tpu_torch.examples.cfd.cylinder_benchmark_schafer_turek import build
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep, CollideStream2DStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, build_aux_field, pack_masks

    stepper, fields, omega, _ = build(d=8, hybrid_method=method, backend="cuda", device=cuda_device)
    vs, shape = stepper.velocity_set, tuple(stepper.grid.shape)
    dtype, shifted = getattr(torch, store), store == "bfloat16"
    mask = pack_masks(fields[2], fields[3])
    kw = dict(bc_specs=[bc_to_spec(b, vs) for b in stepper.boundary_conditions], store_dtype=dtype, shifted=shifted,
              has_solids=stepper.has_solids)
    aux = torch.as_tensor(build_aux_field(stepper), device=cuda_device)
    one, eight = CollideStream2DStep(vs, shape, **kw), CollideStream2DKStep(vs, shape, steps=8, **kw)
    f = perturbed(vs, shape, dtype, shifted, 4, cuda_device)
    assert held(one(f, mask, omega, aux), one.plain(f, mask, omega, aux), dtype)[1] <= 1.0
    g = f
    for _ in range(8):
        g = one(g, mask, omega, aux)
    assert torch.equal(eight(f, mask, omega, aux), g)
    if store == "float32":
        plain, pfields, _, _ = build(d=8, hybrid_method=method, backend="torch", device=cuda_device)
        a0, a1, bm, mm = fields
        b0, b1 = pfields[0], pfields[1]
        for t in range(50):
            a0, a1 = stepper(a0, a1, bm, mm, omega, t)
            a0, a1 = a1, a0
            b0, b1 = plain(b0, b1, bm, mm, omega, t)
            b0, b1 = b1, b0
        torch.testing.assert_close(a0, b0, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sphere", "rotating", "zouhe", "outflow2", "sphere+force"])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_open_adjoint_matches_plain_version_on_the_card(cuda_device, kind, store):
    """K8 in its kExtOpen form on the open scenes at 40x20x24 (f32, and
    bf16-shifted; "+force": with a body force, K8's forced bulk): against
    its plain version (rtol 1e-4, atol 1e-6 / 1e-7), D3Q27 KBC against
    float64 TORCH-tier autograd (no farther than twice the plain version),
    two calls bit for bit, both split by voxel class, and the limit failing
    K8 without its boundary launch (chip_smoke's ``check_adjoint``)."""
    import torch

    import xlb_tpu_torch as xlb
    from chip_smoke import OPEN_OMEGA, OPEN_SCENES, check_adjoint, open_kernels, perturbed
    from chip_smoke import open_scene as port_scene
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.fused_step import pack_masks

    shape = (40, 20, 24)
    kind, forced = kind.split("+")[0], kind.endswith("+force")
    P, B = xlb.PrecisionPolicy, xlb.ComputeBackend
    stepper, (_, _, bc_mask, missing_mask) = port_scene(kind, shape, P.FP32FP32, B.TORCH, cuda_device)
    scene64 = port_scene(kind, shape, P.FP64FP64, B.TORCH, cuda_device) if OPEN_SCENES[kind][1] == "KBC" else None
    dtype, shifted = getattr(torch, store), store == "bfloat16"
    f = perturbed(stepper.velocity_set, shape, dtype, shifted, 3, cuda_device)
    _, aux, _ = open_kernels(stepper, dtype, shifted)
    split = CollideStreamAdjoint.split_launches
    check_adjoint(stepper, f, pack_masks(bc_mask, missing_mask), OPEN_OMEGA, aux, dtype, shifted, kind, scene64,
                  force_vector=(2e-5, -1e-5, 1e-5) if forced else None)
    assert CollideStreamAdjoint.split_launches == split + 2


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["bounceback", "bounceback_regularized", "bounceback_grads",
                                    "nonequilibrium_regularized"])
@pytest.mark.parametrize("pair,variant", [(("D3Q19", "BGK"), (True, "static", "closed")),
                                          (("D3Q19", "BGK"), (False, "spin", "open")),
                                          (("D3Q27", "KBC"), (True, "spin", "open"))])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_hybrid_adjoint_matches_plain_version_on_the_card(cuda_device, method, pair, variant, store):
    """K8 in its kExtHybrid form on hybrid_bcs tunnels at 40x20x24, as the
    open scenes' test: every method, with and without wall distances,
    static and spinning walls, both pairs (D3Q27 KBC against float64)."""
    import torch

    from chip_smoke import HYBRID_OMEGA, check_adjoint, hybrid_scene, open_kernels, perturbed
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.fused_step import pack_masks

    shape = (40, 20, 24)
    stepper, (_, _, bc_mask, missing_mask) = hybrid_scene(pair, method, *variant, shape, cuda_device)
    scene64 = hybrid_scene(pair, method, *variant, shape, cuda_device, "FP64FP64") if pair[1] == "KBC" else None
    dtype, shifted = getattr(torch, store), store == "bfloat16"
    f = perturbed(stepper.velocity_set, shape, dtype, shifted, 3, cuda_device)
    _, aux, _ = open_kernels(stepper, dtype, shifted)
    split = CollideStreamAdjoint.split_launches
    check_adjoint(stepper, f, pack_masks(bc_mask, missing_mask), HYBRID_OMEGA, aux, dtype, shifted, method, scene64)
    assert CollideStreamAdjoint.split_launches == split + 2


@pytest.mark.gpu
def test_open_window_gradients_match_torch_tier(cuda_device):
    """build_multi_step(4) on the CUDA tier (K2 forward; K1 replay and K8
    once per step) against TORCH-tier autograd on a flow past a sphere and
    an open hybrid tunnel at 64x32x32: d f_0 rtol 2e-4, atol 1e-6; d omega
    rtol 2e-3 (chip_smoke's ``open_window_gradients``)."""
    from chip_smoke import open_window_gradients

    assert set(open_window_gradients(cuda_device)) == {"sphere", "hybrid"}


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_field_kernels_match_plain_versions_on_the_card(cuda_device, store):
    """K1's and K3's field modes (ade, extern_force) in every instantiated
    form -- chip_smoke.field_cases at 40x24, 24x20x16 and the Schafer-Turek
    scene at D = 4 -- against their plain versions (f32: rtol 1e-5, atol
    1e-6; bf16: 8 bf16 ulps, as chip_smoke's ``held``), two launches bit
    for bit."""
    import torch

    from chip_smoke import field_case, field_cases, held_field

    for i, (label, stepper, field) in enumerate(field_cases(cuda_device, (40, 24), (24, 20, 16), 4)):
        kernel, f, mask, aux, _ = field_case(stepper, field, getattr(torch, store), 7 + i, cuda_device)
        held_field(kernel, f, mask, aux, label)  # raises past the tolerance or when two launches differ


@pytest.mark.gpu
def test_thermal_and_shan_chen_cuda_tier_match_torch_tier(cuda_device):
    """chip_smoke.thermal_tier_parity: 10 coupled steps of the CUDA tier
    (one launch of each field mode per step) against the TORCH tier on the
    card (rtol 1e-4), the 2D and 3D thermal scenes and Shan-Chen in 2D and
    3D."""
    from chip_smoke import field_counts, thermal_tier_parity

    field_counts(reset=True)
    thermal_tier_parity(cuda_device)
    counts = field_counts()
    assert counts["K3 ade"][0] == counts["K1 ade"][0] == 10
    assert counts["K3 extern_force"][0] == counts["K1 extern_force"][0] == 20
    assert counts["K3 ade"][1] == counts["K1 ade"][1] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case,syncs", [("window f32", 0), ("window bf16", 2), ("train f32", 1)])
def test_wait_spans_count_the_host_syncs(cuda_device, case, syncs):
    """Under the profiler, the port's ``xlb.wait.*`` records of one window
    call (training: the call and its ``loss.backward()``, Adam left out as
    the user's code) are as many as the synchronizations that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports for it: bf16 copies
    ``w_shift`` from pageable host memory in and out, training reads omega
    back. Each ``xlb.window`` record's device time covers its sweeps'."""
    import warnings

    import torch

    from xlb_tpu_torch.kernels.fused_step import build_fused_window
    from xlb_tpu_torch.utils import tracing

    train = case.startswith("train")
    stepper, (f_0, _, bc_mask, missing_mask) = _cavity("FP32BF16" if "bf16" in case else "FP32FP32", "CUDA",
                                                       cuda_device)
    window = build_fused_window(stepper, 3)
    omega = torch.tensor(OMEGA, device=cuda_device, requires_grad=True) if train else OMEGA

    def call():
        f_in = f_0.detach().float().requires_grad_(train)
        out, _ = window(f_in, f_in, bc_mask, missing_mask, omega)
        if train:
            torch.mean(out ** 2).backward()

    call()  # loads the kernels
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    reported = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    recs = tracing.records()
    waits = [r.name for r in recs if r.name.startswith("xlb.wait.")]
    assert len(waits) == len(reported) == syncs, (waits, [str(w.message) for w in reported])
    windows = [r for r in recs if r.name == "xlb.window"]
    assert len(windows) == 1 and sum(r.name == "xlb.backward" for r in recs) == int(train)
    for w in windows:
        sweeps = [r.device_ms for r in recs if r.parent is w and r.name == "xlb.window.sweep"]
        assert sweeps and w.device_ms >= sum(sweeps) > 0
