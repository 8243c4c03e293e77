#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (xlb_tpu_torch) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab LABEL [--quick]   # one tree's kernel times (ab_line)

1. Device: requires CUDA; prints the card's name and power limit.
2. Builds the CUDA kernels from xlb_tpu_torch/csrc with nvcc (sm_90a) and
   prints the build time and the ptxas register/spill report.
3. Holds each kernel against its plain torch version on a seeded,
   perturbed 64x48x40 lid-driven cavity (non-cubic: tile edges and
   periodic wrap are exercised), again with a solid block (cell type 255,
   has_solids) in it, then at 256^3, where it also times kernel and plain
   version (CUDA events) beside the kernel's bound. Then a 64x48x40 cavity
   of 15 BCs (ten fullway wall pieces, three equilibrium lid pieces, two
   halfway blocks; past the 8 prescriptions the kernels take by value,
   the rest from the device table): K1, K2 and K0 against their plain
   versions, K0 == K1 and K2 == two K1 launches; K8 on it and on its 13
   BCs without the blocks.
4. Main path through the public API: init(D3Q19, CUDA, policy) ->
   grid_factory((256,)*3, device="cuda") -> the lid-cavity BCs ->
   IncompressibleNavierStokesStepper -> prepare_fields() ->
   build_multi_step(200), under FP32BF16 and FP32FP32 at omega 1.9: one
   warm-up window, then the best of 5 windows (MLUPS = 256^3*200/s/1e6).
   Then 10 FP32FP32 steps through stepper(...) against the plain TORCH
   tier on the card. Kernel launch counts are reset before and read after
   this phase; physics checks run on the final states.
5. Holds the adjoint kernel against its plain version (torch.func.vjp of
   the plain step) on the 64x48x40 cavity with and without the solid
   block, f32 and bf16-shifted primal, then at 256^3, where it also times
   both beside the bound.
6. The training path at 256^3 through the public API: torch.autograd
   through build_multi_step(16) on the CUDA tier (forward: the k-step
   kernel; backward: single-step replay and the adjoint kernel), under
   FP32BF16 and FP32FP32. A seeded 5% perturbation of f_0 and omega are
   the inputs; 5 Adam iterations on omega (lr 0.05, from 1.5) fit the
   window's output at omega 1.7, and must lower the loss and bring omega
   closer to 1.7. Prints forward, backward and per-step ms and the peak
   device memory. Before it, CUDA-tier gradients are held against
   TORCH-tier autograd on the 64x48x40 cavity over 4 FP32FP32 steps.
   Launch counts are reset before and read after the training runs.
7. Holds the 2D kernels (K3 single step, K4 k-step) against their plain
   versions, f32 and bf16-shifted, and each K4 against k K3 launches bit
   for bit: on a seeded, perturbed 200x136 cavity with halfway walls and
   on the 320x128 cylinder's BC set (Zou-He and regularized inlet and
   outlet, halfway cylinder with its solid interior), K4 at k = 2 and 8;
   on a 200x136 scene of 13 BCs (four fullway, two halfway pieces, a
   Zou-He velocity and a regularized pressure piece, three equilibrium lid
   pieces, a halfway and a fullway block); then on the 2048^2 lid cavity
   of the main path, K4 at k = 2, 4 and 8, where it also times each kernel
   and its plain version beside the bound.
8. The 2D main path through the public API (examples/performance/
   mlups_2d.py's scene and protocol): D2Q9, BGK, 2048^2, fullway walls,
   equilibrium lid u = (0.02, 0), omega 1.6, build_multi_step(500) (K4 at
   k = 8 and K3 for the remainder), 2 warm-up windows, then the best of 3
   (MLUPS = 2048^2*500/s/1e6), under FP32FP32 and FP32BF16; then 10
   FP32FP32 steps through stepper(...) against the TORCH tier. Launch
   counts are reset before and read after each policy's windows.
9. The cylinder of examples/cfd/flow_past_cylinder_2d.py at its defaults
   (320x128, Re 100, u_in 0.04, regularized inlet and outlet) on the CUDA
   tier: 8000 steps in windows of 500, momentum-transfer drag after each;
   prints Cd and the wake u_y amplitude, then holds 200 CUDA-tier steps
   against the TORCH tier.
10. Holds the multires kernels against their plain versions at the
   shapes of bench.py's multires scenes, f32 and bf16-shifted, with and
   without solid blocks: K7 as the finest pair with ring freeze and the
   coalesced average (194^3 ring box), the coarsest single sub-step
   (96^3) and the middle single with ring freeze and average (98^3); K6's
   configuration (the pair over a common ring, no side output); K5 on the
   96^3 coarsest level. The pair must equal two single launches bit for
   bit. The non-solid variants are timed (CUDA events) beside the bound.
11. The multires main path (examples/performance/mlups_3d_multires.py's
   scenes and protocol, as bench.py:129-137 runs them): the 2-level fully
   refined 96^3/192^3 scene and the 3-level half-box pyramid of three
   96^3 levels, FUSION_AT_FINEST, omega 1.6, through
   MultiresSimulationManager.run(20, window=20): one warm-up window, then
   the best of 3 (weighted MLUPS = sum_l cells_l 2^(L-1-l) x 20 / s /
   1e6), FP32FP32 and FP32BF16; launch counts around the timed windows;
   the tier attributes; one profiled window (device busy share, largest
   kernels); physics checks; FP32FP32 also 2 coarse steps of the CUDA tier
   against the TORCH tier from a seeded perturbed state (5e-6).
12. The walled 2-level cavity (fullway walls, equilibrium lid, a coarse
   fullway voxel inside the refined region, a halfway solid block on the
   finest level) under FUSION_AT_FINEST_SFV_ALL: its kernels against
   their plain versions, then 2 coarse steps with the coarsest collide
   through K5 (launches counted), against the TORCH tier (5e-6).
13. The 3D collision zoo: K1, K2 and K0 (kernel="blocked") against their
   plain versions for each (velocity set, collision) pair of ZOO -- D3Q19
   BGK, SmagorinskyLESBGK, TRT, MRT, PowerLawBGK; D3Q27 BGK, KBC -- on the
   256^3 lid cavity, a ragged 250x246x200 cavity and the 192x96x64
   channel (body force, halfway walls), f32 and bf16-shifted, with and
   without a solid block; K0 against K1 and K2 against two K1 launches,
   bit for bit; on the 256^3 cavity each kernel and its plain version
   timed (CUDA events) beside the bound.
14. examples/performance/mlups_3d.py's protocol at 256^3 (omega 1.9, lid
   0.02, windows of 50, 2 warm-up windows, best of 3) for each pair under
   FP32FP32 and FP32BF16, through K1, K2 and K0, each route from the rest
   state with its launch counts reset before and read after it; physics
   checks after each route; FP32FP32 also 10 steps of stepper(...) against
   the TORCH tier.
15. examples/cfd/turbulent_channel_3d.py (D3Q27, KBC, exact-difference
   force, halfway walls in z) on the CUDA tier: run()'s defaults against
   the TORCH tier (the mean profile), then the validation shape 192x96x64
   at u_tau 0.009 for 2000 steps (MLUPS, finite, bulk velocity rising).
   Then the adjoint kernel K8 on the zoo: against its plain version for
   every pair on the 64x48x40 cavity with a solid block and on the
   192x96x64 channel (body force, halfway walls), f32 and bf16-shifted,
   timed there; and autograd through stepper(...) of the D3Q19 TRT cavity
   and build_multi_step(4) of the forced D3Q27 KBC channel, forward
   through K1 / K2, backward through K8 once per step, gradients against
   float64 TORCH-tier autograd (within twice the float32 TORCH tier's own
   error).
16. The copy-bandwidth probes (K9-K12): each kernel and variant against its
   plain version bit for bit on the (19, 256, 256, 256) field of the
   scripts, a ragged (3, 17, 13, 11) field and a 420-byte (7, 5, 3) one,
   the small ones also 4 bytes past a 16-byte boundary; then
   examples/performance/memory_bandwidth.py and dma_experiments.py in their
   torch form at their defaults (every line printed; launch counts reset
   before and read after: every probe launched, no plain call), the plain
   versions timed, and the best sustained copy rate as the card's measured
   copy roofline.
17. Prints the seconds of the whole run, a JSON line of the card, MLUPS,
   training times and each kernel's per-dtype errors and times, then the
   kernels' JSON line (K0-K12), then the result line {"ok": true,
   "device": {...}} last.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available. It imports
nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np

N_MAIN = 256
WINDOW = 200
REPS = 5
OMEGA = 1.9
LID_U = 0.02
SMALL = (64, 48, 40)
SOLID_BLOCK = (slice(20, 28), slice(16, 24), slice(12, 20))  # of SMALL, set to cell type 255
ADJ_OMEGA = 1.5
TRAIN_WINDOW = 16
TRAIN_ITERS = 5
OMEGA_START, OMEGA_TARGET = 1.5, 1.7
# the card's data-sheet rates (H100 SXM): device memory and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# float32 operations per fluid voxel, counted from csrc/ (plain / shifted storage):
# step 202 / 240, k-step 2 x step, adjoint 495 / 514
FLOPS_PER_VOXEL = {
    "collide_stream_step": (202, 240),
    "collide_stream_kstep": (404, 480),
    "collide_stream_adjoint": (495, 514),
    # D2Q9 (csrc/collide_stream_2d.cu, the lid cavity's epilogues): one step; the k-step k x that
    "collide_stream_2d_step": (93, 111),
    # multires (csrc/collide_then_stream.cu, csrc/collide_only.cu): the same moments, equilibrium and
    # BGK per voxel and sub-step as the 3D step; the pair 2 x that
    "collide_then_stream": (202, 240),
    "collide_only": (202, 202),
}
# the 2D main path: examples/performance/mlups_2d.py's scene and protocol
N_2D = 2048
WINDOW_2D = 500
WARMUP_2D, REPS_2D = 2, 3
OMEGA_2D = 1.6
SMALL_2D = (200, 136)
K_SWEEP_2D = (2, 4, 8)
# the cylinder: examples/cfd/flow_past_cylinder_2d.py's defaults
CYL_SHAPE, CYL_RE, CYL_U, CYL_STEPS, CYL_WINDOW = (320, 128), 100.0, 0.04, 8000, 500


def check(cond, message):
    if not cond:
        raise RuntimeError(f"check failed: {message}")


def cavity(shape, policy, backend, device):
    """The lid-driven cavity of bench.py through the port's public API."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary import EquilibriumBC, FullwayBounceBackBC
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.velocity_set import D3Q19

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D3Q19(), default_backend=backend, default_precision_policy=policy)
    grid = xlb.grid_factory(shape, device=device)
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1
    )
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(LID_U, 0.0, 0.0), indices=box_ne["top"]),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type="BGK")
    return stepper, stepper.prepare_fields()


def within(a, b, rtol, atol):
    """(max |a - b|, all |a - b| <= atol + rtol |b|) in float32."""
    a, b = a.float(), b.float()
    err = (a - b).abs()
    return float(err.max()), bool((err <= atol + rtol * b.abs()).all())


def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over reps calls after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(name, tensors, voxels, shifted, steps=1):
    """(least ms the card could take, "bytes" or "operations") for a kernel
    that reads its inputs once and writes its outputs once (``tensors``)
    and does ``steps`` x FLOPS_PER_VOXEL operations on each of ``voxels``."""
    t_bytes = sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S * 1e3
    t_ops = steps * FLOPS_PER_VOXEL[name][int(shifted)] * voxels / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def solid_mask(mask):
    """The packed mask with SOLID_BLOCK set to cell type 255."""
    out = mask.clone()
    out[SOLID_BLOCK] = 255 << 19
    return out


def kernel_variants(shape, device, seed, solid=False):
    """The kernel instantiations of the main path on a seeded perturbed
    cavity of ``shape``: one (store dtype, single step, 2-step, f, mask)
    per store dtype -- f32 plain storage and bf16 deviation form. With
    ``solid``, SOLID_BLOCK is cell type 255 and the kernels keep it out."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    stepper, (_, _, bc_mask, missing_mask) = cavity(shape, xlb.PrecisionPolicy.FP32FP32, xlb.ComputeBackend.TORCH, device)
    vs = stepper.velocity_set
    specs = [bc_to_spec(bc, vs) for bc in stepper.boundary_conditions]
    mask = pack_masks(bc_mask, missing_mask)
    if solid:
        mask = solid_mask(mask)
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.as_tensor(vs._w, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1)
    noise = torch.randn((vs.q,) + tuple(shape), generator=gen, device=device)
    plain_f = (w * (1.0 + 0.05 * noise)).contiguous()  # plain storage, f32
    dev_g = (0.02 * w * noise).to(torch.bfloat16).contiguous()  # deviation form, bf16
    out = []
    for store, shifted, f in ((torch.float32, False, plain_f), (torch.bfloat16, True, dev_g)):
        kw = dict(bc_specs=specs, store_dtype=store, shifted=shifted, has_solids=solid or stepper.has_solids)
        one = CollideStreamStep(vs, shape, **kw)
        two = CollideStreamKStep(vs, shape, steps=2, **kw)
        out.append((store, one, two, f, mask))
    return out


def compare_kernels(shape, device, seed, time_them, solid=False):
    """Kernel against plain version for both kernels and both store dtypes.
    Returns {kernel: {label: record}}."""
    import torch

    results = {"collide_stream_step": {}, "collide_stream_kstep": {}}
    for store, one, two, f, mask in kernel_variants(shape, device, seed, solid):
        label = ("f32" if store == torch.float32 else "bf16-shifted") + (" solid" if solid else "")
        eps = torch.finfo(store).eps
        ulp8 = dict(rtol=8 * eps, atol=8 * eps * 0.05)  # store-dtype 8-ulp bound
        f32_tol = dict(rtol=1e-5, atol=1e-6)  # f32 reassociation and FMA contraction
        one_tol = f32_tol if store == torch.float32 else ulp8

        k1, p1 = one(f, mask, OMEGA), one.plain(f, mask, OMEGA)
        k2, p2 = two(f, mask, OMEGA), two.plain(f, mask, OMEGA)
        k11 = one(one(f, mask, OMEGA), mask, OMEGA)
        torch.cuda.synchronize()
        for t in (k1, k2, k11):
            check(bool(torch.isfinite(t.float()).all()), f"{label}: non-finite kernel output at {shape}")
        e1, ok1 = within(k1, p1, **one_tol)
        e2, ok2 = within(k2, p2, **(f32_tol if store == torch.float32 else ulp8))
        e21, ok21 = within(k2, k11, **ulp8)
        print(f"  {shape} {label}: step vs plain max|err| {e1:.3e} ok={ok1}; "
              f"kstep vs plain {e2:.3e} ok={ok2}; kstep vs 2 step launches {e21:.3e} ok={ok21}")
        check(ok1 and ok2 and ok21, f"{label} kernel disagrees with its reference at {shape}")
        rec1 = {"max_abs_err": e1}
        rec2 = {"max_abs_err": max(e2, e21)}
        del k1, p1, k2, p2, k11
        if time_them:
            voxels = mask.numel()
            rec1["bound_ms"], rec1["bound_by"] = bound("collide_stream_step", (f, mask, f), voxels, one.shifted)
            rec2["bound_ms"], rec2["bound_by"] = bound("collide_stream_kstep", (f, mask, f), voxels, two.shifted)
            rec1["ms"] = cuda_ms(lambda: one(f, mask, OMEGA), 20)
            rec1["plain_ms"] = cuda_ms(lambda: one.plain(f, mask, OMEGA), 2)
            rec2["ms"] = cuda_ms(lambda: two(f, mask, OMEGA), 20)
            rec2["plain_ms"] = cuda_ms(lambda: two.plain(f, mask, OMEGA), 2)
            print(f"  {shape} {label}: step {rec1['ms']:.4f} ms (plain {rec1['plain_ms']:.3f} ms, "
                  f"bound {rec1['bound_ms']:.4f} ms); kstep(2 steps) {rec2['ms']:.4f} ms "
                  f"(plain {rec2['plain_ms']:.3f} ms, bound {rec2['bound_ms']:.4f} ms)")
        results["collide_stream_step"][label] = rec1
        results["collide_stream_kstep"][label] = rec2
        torch.cuda.empty_cache()
    return results


# the many-BC cavity: walls in ten fullway pieces, the lid in equilibrium pieces of these
# velocities and (with ``halfway``) two halfway blocks at these corners
MANY_BC_LID = ((0.03, 0.0, 0.0), (0.02, 0.01, 0.0), (0.01, 0.0, 0.0))
MANY_BC_BLOCKS = ((3, 3, 3), (9, 9, 6))


def many_bcs(grid, bnd, halfway=True):
    """The BCs of the many-BC lid cavity on ``grid``, made from the BC
    classes of ``bnd`` (a package's ``boundary`` module): 15, or 13 without
    the halfway blocks -- past the 8 prescriptions the launch parameters
    carry by value."""
    box = grid.bounding_box_indices()
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1)
    bcs = [bnd.FullwayBounceBackBC(indices=piece.tolist()) for piece in np.array_split(walls, 10, axis=1)]
    lid = np.asarray(grid.bounding_box_indices(remove_edges=True)["top"])
    bcs += [bnd.EquilibriumBC(rho=1.0, u=u, indices=piece.tolist())
            for u, piece in zip(MANY_BC_LID, np.array_split(lid, len(MANY_BC_LID), axis=1))]
    if halfway:
        for origin in MANY_BC_BLOCKS:
            block = np.indices((3, 2, 2)).reshape(3, -1) + np.array(origin).reshape(3, 1)
            bcs.append(bnd.HalfwayBounceBackBC(indices=block.tolist()))
    return bcs


def many_bc_cavity(shape, device, halfway=True):
    """(stepper, prepare_fields()) of the many-BC lid cavity on the TORCH
    tier (D3Q19, BGK, FP32FP32)."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch import boundary
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.velocity_set import D3Q19

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend.TORCH,
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)
    grid = xlb.grid_factory(shape, device=device)
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=many_bcs(grid, boundary, halfway),
                                                collision_type="BGK")
    return stepper, stepper.prepare_fields()


def compare_many_bcs_3d(shape, device, seed):
    """[3], the BC table beyond 8 entries: K1, K2 and K0 on the 15-BC cavity
    against their plain versions (``held``), K0 == K1 and K2 == two K1
    launches bit for bit; K8 on it and on the 13-BC cavity without the
    halfway blocks against its plain version; f32 and bf16-shifted.
    Returns the largest tolerance share of each kernel (K8: of rtol 1e-4,
    atol 1e-6 on df and 1e-7 on dom)."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_blocked import CollideStreamBlocked
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    shares = {"K1": 0.0, "K2": 0.0, "K0": 0.0, "K8": 0.0}
    for halfway in (True, False):
        stepper, (_, _, bc_mask, missing_mask) = many_bc_cavity(shape, device, halfway)
        vs = stepper.velocity_set
        specs = [bc_to_spec(bc, vs) for bc in stepper.boundary_conditions]
        mask = pack_masks(bc_mask, missing_mask)
        gen = torch.Generator(device=device).manual_seed(seed)
        w = torch.as_tensor(vs._w, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1)
        noise = torch.randn((vs.q,) + tuple(shape), generator=gen, device=device)
        for store, shifted in ((torch.float32, False), (torch.bfloat16, True)):
            f = ((0.02 * w * noise) if shifted else (w * (1.0 + 0.05 * noise))).to(store).contiguous()
            kw = dict(bc_specs=specs, store_dtype=store, shifted=shifted, has_solids=stepper.has_solids)
            label = f"{len(specs)} BCs {'f32' if store == torch.float32 else 'bf16-shifted'}"
            found = {}
            if halfway:
                one, two, blocked = (CollideStreamStep(vs, shape, **kw), CollideStreamKStep(vs, shape, steps=2, **kw),
                                     CollideStreamBlocked(vs, shape, **kw))
                k1, k2, k0 = one(f, mask, OMEGA), two(f, mask, OMEGA), blocked(f, mask, OMEGA)
                k11 = one(k1, mask, OMEGA)
                p1 = one.plain(f, mask, OMEGA)
                p2 = one.plain(p1, mask, OMEGA)
                torch.cuda.synchronize()
                found = {"K1": held(k1, p1, store), "K2": held(k2, p2, store), "K0": held(k0, p1, store)}
                same01, same2 = torch.equal(k0, k1), torch.equal(k2, k11)
                print(f"  {shape} {label}: " + ", ".join(f"{n} {e:.2e} ({s:.3f} of tol)" for n, (e, s) in found.items())
                      + f"; K0 == K1 {same01}, K2 == 2 K1 {same2}")
                check(same01 and same2, f"{label}: K0 differs from K1, or K2 from two K1 launches")
                del k1, k2, k0, k11, p1, p2
            gen_g = torch.Generator(device=device).manual_seed(seed + 1)
            g = (w * torch.randn(f.shape, generator=gen_g, device=device)).contiguous()
            adj = CollideStreamAdjoint(vs, shape, **kw)
            (df, dom), (pdf, pdom) = adj(f, g, mask, ADJ_OMEGA), adj.plain(f, g, mask, ADJ_OMEGA)
            torch.cuda.synchronize()
            e1, s1 = tolerance_share(df, pdf, rtol=1e-4, atol=1e-6)
            e2, s2 = tolerance_share(dom, pdom, rtol=1e-4, atol=1e-7)
            print(f"  {shape} {label}: K8 df max|err| {e1:.3e}, dom_field {e2:.3e} ({max(s1, s2):.3f} of tol)")
            found["K8"] = (max(e1, e2), max(s1, s2))
            del df, dom, pdf, pdom, g
            for n, (_, share) in found.items():
                check(share <= 1.0, f"{label}: {n} disagrees with its plain version")
                shares[n] = max(shares[n], share)
            del f
        del stepper, bc_mask, missing_mask, mask, noise
        torch.cuda.empty_cache()
    return shares


def tolerance_share(a, ref, rtol, atol):
    """(max |a - ref|, the largest share of atol + rtol |ref| that an entry
    of |a - ref| takes) in float32."""
    a, ref = a.float(), ref.float()
    err = (a - ref).abs()
    return float(err.max()), float((err / (atol + rtol * ref.abs())).max())


def physics_checks(stepper, f, bc_mask, label):
    import torch

    from xlb_tpu_torch.ops.macroscopic import density, velocity

    f = f.float()
    check(bool(torch.isfinite(f).all()), f"{label}: non-finite populations")
    rho = density(f)
    u = velocity(f, rho, stepper.velocity_set._c)
    fluid = bc_mask[0] == 0
    mean_rho = float(rho[0][fluid].mean())
    umax = float(torch.linalg.vector_norm(u, dim=0)[fluid].max())
    n = stepper.grid.shape
    ux_lid = float(u[0, n[0] // 2, n[1] // 2, n[2] - 2])
    print(f"  {label}: fluid mean rho {mean_rho:.6f}, fluid max|u| {umax:.6f}, u_x under lid centre {ux_lid:.6f}")
    check(abs(mean_rho - 1.0) < 1e-2, f"{label}: |mean rho - 1| >= 1e-2")
    check(umax <= 1.05 * LID_U, f"{label}: max|u| {umax} above 1.05 x lid speed")
    check(ux_lid > 0.0, f"{label}: u_x under the lid centre is not positive")


def main_path(device):
    """Timed windows under both policies plus 10 per-step API calls.
    Returns ({policy: (mlups, ms_per_step)}, launch counts)."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.examples.performance.mlups_2d import time_windows
    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep

    shape = (N_MAIN,) * 3
    kernels = (CollideStreamStep, CollideStreamKStep)
    for k in kernels:
        k.launches = k.plain_calls = 0

    perf = {}
    for policy in (xlb.PrecisionPolicy.FP32BF16, xlb.PrecisionPolicy.FP32FP32):
        stepper, (f_0, f_1, bc_mask, missing_mask) = cavity(shape, policy, xlb.ComputeBackend.CUDA, device)
        run = stepper.build_multi_step(WINDOW)
        best, (f_0, f_1) = time_windows(run, (f_0, f_1, bc_mask, missing_mask), OMEGA, 1, REPS)
        mlups = N_MAIN**3 * WINDOW / best / 1e6
        perf[policy.name] = (mlups, best / WINDOW * 1e3)
        print(f"  {policy.name}: {mlups:.1f} MLUPS, {best / WINDOW * 1e3:.4f} ms/step (best of {REPS} windows of {WINDOW})")
        physics_checks(stepper, f_0, bc_mask, policy.name)

        if policy == xlb.PrecisionPolicy.FP32FP32:
            # 10 steps through stepper(...) against the plain TORCH tier
            from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

            plain = IncompressibleNavierStokesStepper(
                stepper.grid, boundary_conditions=stepper.boundary_conditions, collision_type="BGK",
                compute_backend=xlb.ComputeBackend.TORCH,
            )
            a0, a1 = f_0.contiguous(), f_1.clone()
            b0, b1 = f_0.clone(), f_1.clone()
            for i in range(10):
                a0, a1 = stepper(a0, a1, bc_mask, missing_mask, OMEGA, i)
                a0, a1 = a1, a0
                b0, b1 = plain(b0, b1, bc_mask, missing_mask, OMEGA, i)
                b0, b1 = b1, b0
            err, ok = within(a0, b0, rtol=1e-4, atol=1e-6)
            print(f"  10 FP32FP32 steps, CUDA tier vs TORCH tier on the card: max|err| {err:.3e} ok={ok}")
            check(ok, "CUDA tier disagrees with the TORCH tier over 10 steps")
        del stepper, f_0, f_1, bc_mask, missing_mask, run
        torch.cuda.empty_cache()

    counts = {k.__name__: (k.launches, k.plain_calls) for k in kernels}
    return perf, counts


def compare_adjoint(shape, device, seed, time_them, solid):
    """The adjoint kernel against its plain version (torch.func.vjp of the
    plain step) for an f32 and a bf16-shifted primal, seeded cotangent
    g = w * N(0, 1). Returns {label: record}."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint

    # The hand-derived transpose and autograd's sum the same O(1) terms in
    # other orders, and nvcc contracts into FMAs: entries of df that cancel
    # to near zero differ by a few float32 ulps of |g| ~ 1 (atol 1e-6).
    df_tol, dom_tol = dict(rtol=1e-4, atol=1e-6), dict(rtol=1e-4, atol=1e-7)
    results = {}
    for store, one, _, f, mask in kernel_variants(shape, device, seed, solid):
        label = ("f32" if store == torch.float32 else "bf16-shifted") + (" solid" if solid else "")
        gen = torch.Generator(device=device).manual_seed(seed + 100)
        w = torch.as_tensor(one.vs._w, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1)
        g = (w * torch.randn(f.shape, generator=gen, device=device)).contiguous()
        adj = CollideStreamAdjoint(one.vs, shape, bc_specs=one.bc_specs, store_dtype=store, shifted=one.shifted,
                                   has_solids=one.has_solids)
        df, dom = adj(f, g, mask, ADJ_OMEGA)
        pdf, pdom = adj.plain(f, g, mask, ADJ_OMEGA)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(df).all() and torch.isfinite(dom).all()), f"{label}: non-finite adjoint at {shape}")
        e1, ok1 = within(df, pdf, **df_tol)
        e2, ok2 = within(dom, pdom, **dom_tol)
        print(f"  {shape} {label}: adjoint df max|err| {e1:.3e} ok={ok1}; dom_field max|err| {e2:.3e} ok={ok2}")
        check(ok1 and ok2, f"{label} adjoint kernel disagrees with its plain version at {shape}")
        rec = {"max_abs_err": max(e1, e2)}
        del df, dom, pdf, pdom
        if time_them:
            rec["bound_ms"], rec["bound_by"] = bound(
                "collide_stream_adjoint", (f, g, mask, g, mask), mask.numel(), one.shifted
            )  # reads f, g, mask; writes df (as g) and dom (4 B/voxel, as mask)
            rec["ms"] = cuda_ms(lambda: adj(f, g, mask, ADJ_OMEGA), 20)
            rec["plain_ms"] = cuda_ms(lambda: adj.plain(f, g, mask, ADJ_OMEGA), 2)
            print(f"  {shape} {label}: adjoint {rec['ms']:.4f} ms (plain {rec['plain_ms']:.3f} ms, "
                  f"bound {rec['bound_ms']:.4f} ms)")
        results[label] = rec
        torch.cuda.empty_cache()
    return results


def gradient_parity(device):
    """CUDA-tier gradients of sum(f**2) after build_multi_step(4) against
    TORCH-tier autograd on the 64x48x40 cavity, FP32FP32."""
    import torch

    import xlb_tpu_torch as xlb

    steps = 4
    grads = []
    for backend in (xlb.ComputeBackend.CUDA, xlb.ComputeBackend.TORCH):
        stepper, (f_0, _, bc_mask, missing_mask) = cavity(SMALL, xlb.PrecisionPolicy.FP32FP32, backend, device)
        gen = torch.Generator(device=device).manual_seed(5)
        f = (f_0 * (1.0 + 0.05 * torch.randn(f_0.shape, generator=gen, device=device))).requires_grad_(True)
        omega = torch.tensor(ADJ_OMEGA, device=device, requires_grad=True)
        out, _ = stepper.build_multi_step(steps)(f, f, bc_mask, missing_mask, omega)
        (out.float() ** 2).sum().backward()
        grads.append((f.grad, omega.grad))
    (df_c, dw_c), (df_t, dw_t) = grads
    e1, ok1 = within(df_c, df_t, rtol=2e-4, atol=1e-6)
    e2, ok2 = within(dw_c, dw_t, rtol=2e-3, atol=0.0)
    print(f"  {SMALL}, {steps} FP32FP32 steps, CUDA tier vs TORCH tier autograd: d f_0 max|err| {e1:.3e} ok={ok1}; "
          f"d omega {float(dw_c):.6e} vs {float(dw_t):.6e} ok={ok2}")
    check(ok1 and ok2, "CUDA-tier gradients disagree with TORCH-tier autograd")


def training_path(device):
    """5 Adam iterations on omega through the CUDA-tier window at 256^3,
    under both policies. Returns ({policy: record}, launch counts)."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep

    shape = (N_MAIN,) * 3
    kernels = (CollideStreamStep, CollideStreamKStep, CollideStreamAdjoint)
    for k in kernels:
        k.launches = k.plain_calls = 0
    records = {}
    for policy in (xlb.PrecisionPolicy.FP32BF16, xlb.PrecisionPolicy.FP32FP32):
        stepper, (f_0, _, bc_mask, missing_mask) = cavity(shape, policy, xlb.ComputeBackend.CUDA, device)
        gen = torch.Generator(device=device).manual_seed(7)
        noise = torch.randn(f_0.shape, generator=gen, device=device)
        f0 = (f_0.float() * (1.0 + 0.05 * noise)).to(f_0.dtype).requires_grad_(True)
        del noise
        run = stepper.build_multi_step(TRAIN_WINDOW)
        with torch.no_grad():
            target, _ = run(f0, f0, bc_mask, missing_mask, OMEGA_TARGET)
        omega = torch.tensor(OMEGA_START, device=device, requires_grad=True)
        opt = torch.optim.Adam([omega], lr=0.05)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, omegas, fwd, bwd = [], [omega.item()], [], []
        for _ in range(TRAIN_ITERS):
            opt.zero_grad()
            f0.grad = None
            adj0 = CollideStreamAdjoint.launches
            t0 = time.perf_counter()
            out, _ = run(f0, f0, bc_mask, missing_mask, omega)
            loss = torch.mean((out.float() - target.float()) ** 2)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            check(CollideStreamAdjoint.launches - adj0 == TRAIN_WINDOW, "the adjoint kernel ran other than once per step")
            check(f0.grad is not None and f0.grad.dtype == f0.dtype, f"{policy.name}: no f_0 gradient in f_0's dtype")
            check(bool(torch.isfinite(omega.grad)), f"{policy.name}: non-finite omega gradient")
            opt.step()
            losses.append(loss.item())
            omegas.append(omega.item())
            fwd.append((t1 - t0) * 1e3)
            bwd.append((t2 - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rec = {"loss": losses, "omega": omegas, "forward_ms": min(fwd), "backward_ms": min(bwd),
               "ms_per_step": (min(fwd) + min(bwd)) / TRAIN_WINDOW, "peak_gib": peak}
        print(f"  {policy.name}: loss {' -> '.join(f'{x:.4e}' for x in losses)}; "
              f"omega {' -> '.join(f'{x:.4f}' for x in omegas)}")
        print(f"  {policy.name}: window of {TRAIN_WINDOW} forward {rec['forward_ms']:.3f} ms, backward "
              f"{rec['backward_ms']:.3f} ms, {rec['ms_per_step']:.4f} ms per step forward + backward "
              f"(best of {TRAIN_ITERS}); peak device memory {peak:.2f} GiB")
        check(all(np.isfinite(losses)), f"{policy.name}: non-finite loss")
        check(losses[-1] < losses[0], f"{policy.name}: the loss did not fall")
        check(abs(omegas[-1] - OMEGA_TARGET) < abs(omegas[0] - OMEGA_TARGET), f"{policy.name}: omega did not approach its target")
        records[policy.name] = rec
        del stepper, f_0, f0, target, out, loss, run, bc_mask, missing_mask
        torch.cuda.empty_cache()
    counts = {k.__name__: (k.launches, k.plain_calls) for k in kernels}
    return records, counts

def scene_2d(kind, shape, policy, backend, device, inout="regularized"):
    """A 2D scene through the port's public API: "cavity" (mlups_2d.py:
    fullway walls, equilibrium lid), "halfway_cavity" (lid_driven_cavity_2d.py's
    walls, same lid), "many_bcs" (13 BCs: the bottom in four fullway
    pieces, the left side in two halfway pieces, the right in a Zou-He
    velocity and a regularized pressure piece, the lid in three
    equilibrium pieces, a halfway and a fullway block) or "cylinder"
    (flow_past_cylinder_2d.py at ``shape``, Zou-He or regularized
    ``inout``, started from the uniform inflow).
    Returns (stepper, (f_0, f_1, bc_mask, missing_mask), extras)."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary import (EquilibriumBC, FullwayBounceBackBC, HalfwayBounceBackBC, RegularizedBC,
                                        ZouHeBC)
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.helper import CustomInitializer
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.utils import omega_from_reynolds
    from xlb_tpu_torch.velocity_set import D2Q9

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D2Q9(), default_backend=backend, default_precision_policy=policy)
    grid = xlb.grid_factory(shape, device=device)
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    if kind in ("cavity", "halfway_cavity"):
        walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right")], axis=1), axis=1)
        wall_bc = FullwayBounceBackBC if kind == "cavity" else HalfwayBounceBackBC
        bcs = [wall_bc(indices=walls.tolist()), EquilibriumBC(rho=1.0, u=(LID_U, 0.0), indices=box_ne["top"])]
        stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type="BGK")
        return stepper, stepper.prepare_fields(), {}
    nx, ny = shape
    if kind == "many_bcs":
        bcs = [FullwayBounceBackBC(indices=p.tolist()) for p in np.array_split(np.asarray(box["bottom"]), 4, axis=1)]
        bcs += [HalfwayBounceBackBC(indices=p.tolist()) for p in np.array_split(np.asarray(box_ne["left"]), 2, axis=1)]
        right = np.array_split(np.asarray(box_ne["right"]), 2, axis=1)
        bcs += [ZouHeBC("velocity", prescribed_value=(0.0, 0.0), indices=right[0].tolist()),
                RegularizedBC("pressure", prescribed_value=1.0, indices=right[1].tolist())]
        bcs += [EquilibriumBC(rho=1.0, u=(u, 0.0), indices=p.tolist())
                for u, p in zip((0.03, 0.02, 0.01), np.array_split(np.asarray(box_ne["top"]), 3, axis=1))]
        for origin, bc_cls in (((3, 3), HalfwayBounceBackBC), ((9, 9), FullwayBounceBackBC)):
            block = np.indices((3, 3)).reshape(2, -1) + np.array(origin).reshape(2, 1) + nx // 4
            bcs.append(bc_cls(indices=block.tolist()))
        stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type="BGK")
        return stepper, stepper.prepare_fields(), {}
    d = ny // 4
    cx, cy = nx // 4, ny // 2 + 1
    X, Y = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    cyl = np.array(np.nonzero((X - cx) ** 2 + (Y - cy) ** 2 <= (d / 2) ** 2))
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top")], axis=1), axis=1)
    bc_cyl = HalfwayBounceBackBC(indices=cyl.tolist())
    inout_cls = {"zouhe": ZouHeBC, "regularized": RegularizedBC}[inout]
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        inout_cls("velocity", prescribed_value=(CYL_U, 0.0), indices=box_ne["left"]),
        inout_cls("pressure", prescribed_value=1.0, indices=box_ne["right"]),
        bc_cyl,
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type="BGK")
    fields = stepper.prepare_fields(initializer=CustomInitializer(rho_0=1.0, u_0=(CYL_U, 0.0)))
    extras = {"bc_cyl": bc_cyl, "d": d, "probe": (cx + 2 * d, cy), "omega": omega_from_reynolds(CYL_RE, CYL_U, d)}
    return stepper, fields, extras


def kernel_variants_2d(kind, shape, device, seed, inout="regularized"):
    """K3 on a seeded perturbed ``kind`` scene: one (store dtype, K3, f,
    mask) per store dtype -- f32 plain storage and bf16 deviation form."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    stepper, (_, _, bc_mask, missing_mask), _ = scene_2d(kind, shape, xlb.PrecisionPolicy.FP32FP32,
                                                          xlb.ComputeBackend.TORCH, device, inout)
    vs = stepper.velocity_set
    specs = [bc_to_spec(bc, vs) for bc in stepper.boundary_conditions]
    mask = pack_masks(bc_mask, missing_mask)
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.as_tensor(vs._w, dtype=torch.float32, device=device).reshape(-1, 1, 1)
    noise = torch.randn((vs.q,) + tuple(shape), generator=gen, device=device)
    plain_f = (w * (1.0 + 0.05 * noise)).contiguous()
    dev_g = (0.02 * w * noise).to(torch.bfloat16).contiguous()
    out = []
    for store, shifted, f in ((torch.float32, False, plain_f), (torch.bfloat16, True, dev_g)):
        out.append((store, CollideStream2DStep(vs, shape, bc_specs=specs, store_dtype=store, shifted=shifted,
                                               has_solids=stepper.has_solids), f, mask))
    return out


def held(a, ref, store):
    """(max |a - ref|, the largest share of its tolerance any entry of ``a``
    uses) for a kernel's output against its plain version's. f32
    storage: rtol 1e-5, atol 1e-6 (reassociation and FMA contraction).
    bf16 deviation form: 8 bf16 ulps, of the entry (rtol) and of its
    direction's median |ref| (atol), so a direction lost or swapped fails."""
    import torch

    a, ref = a.float(), ref.float()
    if store == torch.float32:
        rtol, atol = 1e-5, 1e-6
    else:
        rtol = 8 * torch.finfo(store).eps
        atol = rtol * ref.abs().flatten(1).median(dim=1).values.reshape((-1,) + (1,) * (ref.ndim - 1))
    err = (a - ref).abs()
    return float(err.max()), float((err / (atol + rtol * ref.abs())).max())


def compare_kernels_2d(kind, shape, device, seed, inout="regularized", steps=(2, 8), time_them=False):
    """K3 and K4 (k in ``steps``, ascending) against their plain versions,
    and each K4 against k K3 launches bit for bit, both store dtypes; with
    ``time_them`` also times each kernel and its plain version (CUDA
    events) beside the bound. Returns {kernel: {label: record}}."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep

    results = {"collide_stream_2d_step": {}, "collide_stream_2d_kstep": {}}
    for store, one, f, mask in kernel_variants_2d(kind, shape, device, seed, inout):
        label = ("f32" if store == torch.float32 else "bf16-shifted") + f" {kind}" + (f" {inout}" if kind == "cylinder" else "")
        kernels = [(one, 1)] + [(CollideStream2DKStep(one.vs, shape, bc_specs=one.bc_specs, store_dtype=store,
                                                      shifted=one.shifted, has_solids=one.has_solids, steps=k), k)
                                for k in steps]
        g, done = f, 0  # f after ``done`` K3 launches
        for kern, k in kernels:
            name, what = ("collide_stream_2d_step", "K3") if k == 1 else ("collide_stream_2d_kstep", f"K4 k={k}")
            out, ref = kern(f, mask, OMEGA_2D), kern.plain(f, mask, OMEGA_2D)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite {what} output at {shape}")
            err, share = held(out, ref, store)
            line = f"  {shape} {label}: {what} vs plain max|err| {err:.3e} ({share:.3f} of its tolerance)"
            check(share <= 1.0, f"{label}: {what} disagrees with its plain version at {shape}")
            if k > 1:
                for _ in range(k - done):
                    g = one(g, mask, OMEGA_2D)
                done = k
                check(torch.equal(out, g), f"{label}: {what} differs from {k} K3 launches at {shape}")
                line += f", bit-equal to {k} K3 launches"
            rec = {"max_abs_err": err, "tolerance_share": share}
            del out, ref
            if time_them:
                rec["ms"] = cuda_ms(lambda: kern(f, mask, OMEGA_2D), 50 if k == 1 else 20)
                rec["plain_ms"] = cuda_ms(lambda: kern.plain(f, mask, OMEGA_2D), 3 if k == 1 else 1)
                rec["bound_ms"], rec["bound_by"] = bound("collide_stream_2d_step", (f, mask, f), mask.numel(),
                                                         one.shifted, steps=k)
                line += (f"; {rec['ms']:.4f} ms = {rec['ms'] / k:.4f} ms/step (plain {rec['plain_ms']:.3f} ms, "
                         f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']})")
            print(line)
            results[name][label if k == 1 else f"{label} k={k}"] = rec
        del g
        torch.cuda.empty_cache()
    return results


def physics_checks_2d(stepper, f, bc_mask, label, u_max):
    """Finite, |mean rho - 1| < 1e-2 and fluid max|u| <= u_max on the fluid
    voxels. Returns (mean rho, max |u|)."""
    import torch

    from xlb_tpu_torch.ops.macroscopic import density, velocity

    f = f.float()
    check(bool(torch.isfinite(f).all()), f"{label}: non-finite populations")
    rho = density(f)
    u = velocity(f, rho, stepper.velocity_set._c)
    fluid = bc_mask[0] == 0
    mean_rho = float(rho[0][fluid].mean())
    umax = float(torch.linalg.vector_norm(u, dim=0)[fluid].max())
    print(f"  {label}: fluid mean rho {mean_rho:.6f}, fluid max|u| {umax:.6f}")
    check(abs(mean_rho - 1.0) < 1e-2, f"{label}: |mean rho - 1| >= 1e-2")
    check(umax <= u_max, f"{label}: max|u| {umax} above {u_max}")
    return mean_rho, umax


def tier_parity_2d(stepper, fields, omega, steps, rtol, atol, label):
    """``steps`` steps of the CUDA tier's stepper(...) against the TORCH
    tier on the card, from the same state. Returns max |err|."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    f_0, f_1, bc_mask, missing_mask = fields
    plain = IncompressibleNavierStokesStepper(stepper.grid, boundary_conditions=stepper.boundary_conditions,
                                              collision_type="BGK", compute_backend=xlb.ComputeBackend.TORCH)
    a0, a1 = f_0.contiguous(), f_1.clone()
    b0, b1 = f_0.clone(), f_1.clone()
    for i in range(steps):
        a0, a1 = stepper(a0, a1, bc_mask, missing_mask, omega, i)
        a0, a1 = a1, a0
        b0, b1 = plain(b0, b1, bc_mask, missing_mask, omega, i)
        b0, b1 = b1, b0
    err, ok = within(a0, b0, rtol=rtol, atol=atol)
    print(f"  {label}: {steps} steps, CUDA tier vs TORCH tier on the card: max|err| {err:.3e} ok={ok}")
    check(ok, f"{label}: CUDA tier disagrees with the TORCH tier over {steps} steps")
    return err


def main_path_2d(device):
    """mlups_2d.py's protocol under both policies, then 10 FP32FP32 steps
    of stepper(...) against the TORCH tier. Returns ({policy: (mlups,
    ms_per_step)}, launch counts of the windows)."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.examples.performance.mlups_2d import time_windows
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep, CollideStream2DStep

    shape = (N_2D, N_2D)
    kernels = (CollideStream2DStep, CollideStream2DKStep)
    counts = {k.__name__: (0, 0) for k in kernels}
    perf = {}
    for policy in (xlb.PrecisionPolicy.FP32FP32, xlb.PrecisionPolicy.FP32BF16):
        stepper, (f_0, f_1, bc_mask, missing_mask), _ = scene_2d("cavity", shape, policy, xlb.ComputeBackend.CUDA, device)
        run = stepper.build_multi_step(WINDOW_2D)
        for k in kernels:
            k.launches = k.plain_calls = 0
        best, (f_0, f_1) = time_windows(run, (f_0, f_1, bc_mask, missing_mask), OMEGA_2D, WARMUP_2D, REPS_2D)
        counts = {k.__name__: (counts[k.__name__][0] + k.launches, counts[k.__name__][1] + k.plain_calls)
                  for k in kernels}
        mlups = N_2D**2 * WINDOW_2D / best / 1e6
        perf[policy.name] = (mlups, best / WINDOW_2D * 1e3)
        print(f"  {policy.name}: {mlups:.1f} MLUPS, {best / WINDOW_2D * 1e3:.5f} ms/step "
              f"(best of {REPS_2D} windows of {WINDOW_2D} after {WARMUP_2D} warm-up)")
        physics_checks_2d(stepper, f_0, bc_mask, policy.name, 1.05 * LID_U)
        if policy == xlb.PrecisionPolicy.FP32FP32:
            tier_parity_2d(stepper, (f_0, f_1, bc_mask, missing_mask), OMEGA_2D, 10, 1e-4, 1e-6, "FP32FP32")
        del stepper, f_0, f_1, bc_mask, missing_mask, run
        torch.cuda.empty_cache()
    return perf, counts


def cylinder_path(device):
    """flow_past_cylinder_2d.py at its defaults on the CUDA tier. Returns
    the record of the run and the launch counts."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep, CollideStream2DStep
    from xlb_tpu_torch.ops import Macroscopic, MomentumTransfer

    kernels = (CollideStream2DStep, CollideStream2DKStep)
    for k in kernels:
        k.launches = k.plain_calls = 0
    stepper, fields, ex = scene_2d("cylinder", CYL_SHAPE, xlb.PrecisionPolicy.FP32FP32, xlb.ComputeBackend.CUDA, device)
    f_0, f_1, bc_mask, missing_mask = fields
    omega, d, (px, py) = ex["omega"], ex["d"], ex["probe"]
    momentum_transfer = MomentumTransfer(ex["bc_cyl"])
    run = stepper.build_multi_step(CYL_WINDOW)
    uy, cd = [], []
    t0 = time.perf_counter()
    for start in range(0, CYL_STEPS, CYL_WINDOW):
        f_0, f_1 = run(f_0, f_1, bc_mask, missing_mask, omega, start)
        _, u = Macroscopic()(f_0)
        uy.append(float(u[1, px, py]))
        force = momentum_transfer(f_0, f_1, bc_mask, missing_mask)
        cd.append(float(force[0]) / (0.5 * CYL_U**2 * d))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    half = np.asarray(uy[len(uy) // 2:])
    amp = float(half.max() - half.min())
    print(f"  cylinder {CYL_SHAPE} Re={CYL_RE} omega={omega:.6f}: Cd={cd[-1]:.4f}, wake u_y amplitude {amp:.3e} "
          f"({'shedding' if amp > 1e-3 * CYL_U else 'steady'}), {CYL_STEPS} steps in {seconds:.2f} s")
    check(all(np.isfinite(cd)) and all(np.isfinite(uy)), "cylinder: non-finite drag or probe velocity")
    check(cd[-1] > 0.0, "cylinder: drag coefficient not positive")
    mean_rho, umax = physics_checks_2d(stepper, f_0, bc_mask, "cylinder", float("inf"))
    counts = {k.__name__: (k.launches, k.plain_calls) for k in kernels}
    err = tier_parity_2d(stepper, (f_0, f_1, bc_mask, missing_mask), omega, 200, 1e-4, 1e-5, "cylinder FP32FP32")
    return {"cd": cd, "uy_probe": uy, "uy_amplitude": amp, "seconds": seconds, "mean_rho": mean_rho,
            "max_u": umax, "tier_err": err}, counts


# the multires scenes of bench.py:129-137, through examples/performance/mlups_3d_multires.py's
# scene and protocol: (label, box_frac, levels) at a 96^3 coarsest level, FUSION_AT_FINEST
MRES_EDGE = 96
MRES_SCENES = (("2-level full", 1.0, 2), ("3-level half-box", 0.5, 3))
MRES_STEPS, MRES_REPS, MRES_OMEGA = 20, 3, 1.6


def mres_grid(box_frac, levels, device):
    """mlups_3d_multires.py's grid at MRES_EDGE: nested boxes of
    ``box_frac`` of their parent (8-cell multiples), centred."""
    from xlb_tpu_torch.examples.performance.mlups_3d_multires import build_grid

    return build_grid(MRES_EDGE, box_frac, levels, device)


def mres_init(policy):
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.velocity_set import D3Q19

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend.TORCH, default_precision_policy=policy)


def mres_walled(device, perf):
    """The walled 2-level cavity: a 96^3 coarse level with fullway walls, an
    equilibrium lid u = (0.03, 0, 0) and one fullway voxel at the centre of
    the refined region (so the coarsest level takes the TORCH tier's route
    and, under SFV_ALL, the collide-only kernel), refined in the centred
    48^3 box; a halfway solid block [40, 56)^3 on the 96^3 finest level
    (the middle sixth of its extents)."""
    from xlb_tpu_torch.boundary import EquilibriumBC, FullwayBounceBackBC, HalfwayBounceBackBC
    from xlb_tpu_torch.grid import Grid
    from xlb_tpu_torch.models.multires import MultiresIncompressibleNavierStokesStepper

    grid = mres_grid(0.5, 2, device)
    n = MRES_EDGE
    helper = Grid((n,) * 3, device="cpu")
    box, box_ne = helper.bounding_box_indices(), helper.bounding_box_indices(remove_edges=True)
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1)
    nf = grid.levels[0].shape[0]
    block = np.stack([a.ravel() for a in np.meshgrid(*[np.arange(5 * nf // 12, 7 * nf // 12)] * 3, indexing="ij")])
    bcs = {1: [FullwayBounceBackBC(indices=walls.tolist()), EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["top"]),
               FullwayBounceBackBC(indices=[[n // 2], [n // 2], [n // 2]])],
           0: [HalfwayBounceBackBC(indices=block.tolist())]}
    return MultiresIncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, mres_perf_opt=perf)


def mres_perturbed(fs, device, seed):
    """The rest state plus 0.01 x U(0, 1) noise per level (float32, on the card, from a seed)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return [f.float() + 0.01 * torch.rand(f.shape, generator=gen, device=device) for f in fs]


def mres_tier_parity(stepper, fs, bms, mms, label):
    """2 coarse steps of the CUDA tier's routes against the TORCH tier on the
    card from the same state; max |err| over the levels, held to 5e-6."""
    from xlb_tpu_torch.models.multires import MultiresIncompressibleNavierStokesStepper

    plain = MultiresIncompressibleNavierStokesStepper(stepper.grid, boundary_conditions=stepper.boundary_conditions)
    a, b = [f.clone() for f in fs], [f.clone() for f in fs]
    for _ in range(2):
        a = stepper(a, bms, mms, MRES_OMEGA)
        b = plain(b, bms, mms, MRES_OMEGA)
    err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
    print(f"  {label}: 2 coarse steps from a perturbed state, CUDA tier vs TORCH tier on the card: max|err| {err:.3e}")
    check(err < 5e-6, f"{label}: the CUDA tier's routes disagree with the TORCH tier ({err})")
    return err


def mres_physics(fs, label, rho_ref=1.0):
    """Finite populations and a per-level mean rho within 1e-2 of ``rho_ref``
    (not checked when None)."""
    import torch

    from xlb_tpu_torch.ops.macroscopic import density

    rhos = []
    for level, f in enumerate(fs):
        f = f.float()
        check(bool(torch.isfinite(f).all()), f"{label}: non-finite populations at level {level}")
        rhos.append(float(density(f).mean()))
        check(rho_ref is None or abs(rhos[-1] - rho_ref) < 1e-2, f"{label}: |mean rho - {rho_ref}| >= 1e-2 at level {level} ({rhos[-1]})")
    print(f"  {label}: finite; mean rho per level (finest first) {', '.join(f'{r:.6f}' for r in rhos)}")
    return rhos


def mres_block(shape):
    """The solid block of [10]: an eighth of each extent, a third of the way in."""
    return tuple(slice(n // 3, n // 3 + n // 8) for n in shape)


def mres_kernel_inputs(device, seed, solid):
    """The masks of the benchmark's kernel launches -- the 2-level scene's
    finest 194^3 ring box and 96^3 coarse level (its refined region 254),
    the 3-level scene's 98^3 middle ring box -- with SOLID blocks of cell
    type 255 when ``solid``, and seeded f32 / bf16-deviation populations."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.models.multires import MultiresIncompressibleNavierStokesStepper
    from xlb_tpu_torch.mres_perf_optimization_type import MresPerfOptimizationType

    masks = {}
    for label, frac, levels in MRES_SCENES:
        mres_init(xlb.PrecisionPolicy.FP32FP32)
        st = MultiresIncompressibleNavierStokesStepper(mres_grid(frac, levels, device),
                                                       mres_perf_opt=MresPerfOptimizationType.FUSION_AT_FINEST)
        _, _, bms, mms = st.prepare_fields()
        if levels == 2:
            masks["finest"] = st._fine_mask_ext(bms, mms)
            masks["coarsest"] = st._coarse_mask_packed(bms, mms)
        else:
            masks["middle"] = st._mid_mask_ext(1, bms, mms)
    if solid:
        for m in masks.values():
            m[mres_block(m.shape)] = 255 << 19
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.as_tensor(st.velocity_set._w, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1)
    inputs = {}
    for name, m in masks.items():
        noise = torch.randn((19,) + tuple(m.shape), generator=gen, device=device)
        inputs[name] = (m, (w * (1.0 + 0.05 * noise)).contiguous(), (0.02 * w * noise).to(torch.bfloat16).contiguous())
    return st.velocity_set, inputs


def compare_kernels_mres(device, seed, solid, time_them):
    """[10]: K7 (pair + ring freeze + coalescence at the finest box, single
    at the coarsest level, single + ring freeze + coalescence at the middle
    box), K6's configuration (pair, no side output) and K5 (the coarsest
    level's collide) against their plain versions, f32 and bf16-shifted;
    the pair bit-equal to two single launches. Returns {kernel: {label: record}}."""
    import torch

    from xlb_tpu_torch.kernels.collide_only import LevelCollide
    from xlb_tpu_torch.kernels.collide_then_stream import CollideThenStream

    vs, inputs = mres_kernel_inputs(device, seed, solid)
    results = {"collide_only": {}, "collide_then_stream_k6": {}, "collide_then_stream": {}}
    tag = " solid" if solid else ""
    for store in (torch.float32, torch.bfloat16):
        shifted = store == torch.bfloat16
        kw = dict(store_dtype=store, shifted=shifted)
        name = ("f32" if store == torch.float32 else "bf16-shifted") + tag
        cases = (
            ("collide_then_stream", "pair+coalesce", "finest",
             CollideThenStream(vs, inputs["finest"][0].shape, pair=True, ring_freeze=True, coalesce=True, **kw), 2),
            ("collide_then_stream_k6", "pair", "finest", CollideThenStream(vs, inputs["finest"][0].shape, pair=True, **kw), 2),
            ("collide_then_stream", "single coarsest", "coarsest",
             CollideThenStream(vs, inputs["coarsest"][0].shape, ring=(0, 0, 0), **kw), 1),
            ("collide_then_stream", "single+freeze+coalesce middle", "middle",
             CollideThenStream(vs, inputs["middle"][0].shape, ring_freeze=True, coalesce=True, **kw), 1),
        )
        for kname, mode, box, kern, steps in cases:
            mask, f32_in, bf16_in = inputs[box]
            f = f32_in if store == torch.float32 else bf16_in
            out, ref = kern(f, mask, MRES_OMEGA), kern.plain(f, mask, MRES_OMEGA)
            torch.cuda.synchronize()
            outs, refs = (out, ref) if kern.coalesce else ((out,), (ref,))
            errs, shares = zip(*(held(o, r, store) for o, r in zip(outs, refs)))
            check(all(bool(torch.isfinite(o.float()).all()) for o in outs), f"{name} {mode}: non-finite output")
            line = f"  {name} {mode} {tuple(mask.shape)}: vs plain max|err| {max(errs):.3e} ({max(shares):.3f} of its tolerance)"
            check(max(shares) <= 1.0, f"{name} {mode}: the kernel disagrees with its plain version")
            if kern.pair and kern.ring_freeze:
                one = CollideThenStream(vs, mask.shape, ring_freeze=True, coalesce=True, **kw)
                two = one(one(f, mask, MRES_OMEGA)[0], mask, MRES_OMEGA)
                check(torch.equal(outs[0], two[0]) and torch.equal(outs[1], two[1]),
                      f"{name}: the pair differs from two single launches")
                line += ", bit-equal to two single launches"
            rec = {"max_abs_err": max(errs), "tolerance_share": max(shares)}
            del out, ref, outs, refs
            if time_them:
                rec["ms"] = cuda_ms(lambda: kern(f, mask, MRES_OMEGA), 20)
                rec["plain_ms"] = cuda_ms(lambda: kern.plain(f, mask, MRES_OMEGA), 2)
                io = (f, mask, f) + ((torch.empty((19,) + tuple(n // 2 for n in kern.core)),) if kern.coalesce else ())
                rec["bound_ms"], rec["bound_by"] = bound("collide_then_stream", io, mask.numel(), shifted, steps=steps)
                line += f"; {rec['ms']:.4f} ms (plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']})"
                if kern.pair and kern.ring_freeze:
                    rec["two_singles_ms"] = cuda_ms(lambda: one(one(f, mask, MRES_OMEGA)[0], mask, MRES_OMEGA), 20)
                    line += f"; two single launches {rec['two_singles_ms']:.4f} ms"
            print(line)
            results[kname][f"{name} {mode}"] = rec
            torch.cuda.empty_cache()
    # K5 on the coarsest level's shape (float32 in and out, as the stepper calls it)
    _, f, _ = inputs["coarsest"]
    mask = torch.zeros(f.shape[1:], dtype=torch.int32, device=device)
    if solid:
        mask[mres_block(mask.shape)] = 255 << 19
        mask[10:20, 10:20, 10:20] = 1 << 19  # a fullway block, cell type 1
    k5 = LevelCollide(vs, tuple(mask.shape), bc_specs=[{"kind": "fullway", "id": 1, "step": "collision"}])
    out, ref = k5(f, mask, MRES_OMEGA), k5.plain(f, mask, MRES_OMEGA)
    torch.cuda.synchronize()
    err, share = held(out, ref, torch.float32)
    check(share <= 1.0, f"collide-only kernel disagrees with its plain version{tag}")
    rec = {"max_abs_err": err, "tolerance_share": share}
    line = f"  f32{tag} K5 collide {tuple(mask.shape)}: vs plain max|err| {err:.3e} ({share:.3f} of its tolerance)"
    if time_them:
        rec["ms"] = cuda_ms(lambda: k5(f, mask, MRES_OMEGA), 50)
        rec["plain_ms"] = cuda_ms(lambda: k5.plain(f, mask, MRES_OMEGA), 3)
        rec["bound_ms"], rec["bound_by"] = bound("collide_only", (f, mask, f), mask.numel(), False)
        line += f"; {rec['ms']:.4f} ms (plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']})"
    print(line)
    results["collide_only"][f"f32{tag}"] = rec
    return results


def mres_kernel_counts():
    from xlb_tpu_torch.kernels.collide_only import LevelCollide
    from xlb_tpu_torch.kernels.collide_then_stream import CollideThenStream

    return {"CollideThenStream": (CollideThenStream.launches, CollideThenStream.plain_calls),
            "CollideThenStream pair": (CollideThenStream.pair_launches, 0),
            "LevelCollide": (LevelCollide.launches, LevelCollide.plain_calls)}


def mres_reset_counts():
    from xlb_tpu_torch.kernels.collide_only import LevelCollide
    from xlb_tpu_torch.kernels.collide_then_stream import CollideThenStream

    CollideThenStream.launches = CollideThenStream.pair_launches = CollideThenStream.plain_calls = 0
    LevelCollide.launches = LevelCollide.plain_calls = 0


def mres_profile(sim):
    """One more window under torch.profiler: the share of its span the
    device was busy (kernel time over the host clock's span, the profiler
    running) and the largest device-time entries in ms per coarse step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(MRES_STEPS, window=MRES_STEPS)
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            kernels[e.key[:60]] = kernels.get(e.key[:60], 0.0) + us / 1e3 / MRES_STEPS
    busy = sum(kernels.values()) * MRES_STEPS / (span * 1e3)
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6])
    return {"busy_share": busy, "span_ms_per_coarse_step": span * 1e3 / MRES_STEPS,
            "device_ms_per_coarse_step": sum(kernels.values()), "top_ms_per_coarse_step": top}


def mres_main_path(device):
    """[11]: the two bench.py multires scenes under FUSION_AT_FINEST through
    MultiresSimulationManager, FP32FP32 and FP32BF16: one warm-up window of
    20 coarse steps, then the best of 3 (weighted MLUPS = sum_l cells_l
    2^(L-1-l) x 20 / s / 1e6). Counts are reset before and read after the
    timed windows of each run. Then, FP32FP32, 2 coarse steps of the CUDA
    tier against the TORCH tier from a perturbed state."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.helper import MultiresSimulationManager
    from xlb_tpu_torch.mres_perf_optimization_type import MresPerfOptimizationType

    perf, counts, tiers, parity = {}, {k: [0, 0] for k in mres_kernel_counts()}, {}, {}
    for label, frac, levels in MRES_SCENES:
        for policy in (xlb.PrecisionPolicy.FP32FP32, xlb.PrecisionPolicy.FP32BF16):
            mres_init(policy)
            grid = mres_grid(frac, levels, device)
            sim = MultiresSimulationManager(grid, MRES_OMEGA, mres_perf_opt=MresPerfOptimizationType.FUSION_AT_FINEST)
            st = sim.stepper
            tiers[f"{label} {policy.name}"] = {"finest": st.active_finest_tier, "coarsest": st.active_coarsest_tier,
                            "middle": {str(k): v for k, v in st.active_mid_tiers.items()}}
            sim.run(MRES_STEPS, window=MRES_STEPS)
            torch.cuda.synchronize()
            mres_reset_counts()
            best = float("inf")
            for _ in range(MRES_REPS):
                t0 = time.perf_counter()
                sim.run(MRES_STEPS, window=MRES_STEPS)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            for k, (n, p) in mres_kernel_counts().items():
                counts[k][0] += n
                counts[k][1] += p
            updates = grid.weighted_updates_per_coarse_step()
            mlups = updates * MRES_STEPS / best / 1e6
            key = f"{label} {policy.name}"
            perf[key] = {"mlups": mlups, "ms_per_coarse_step": best / MRES_STEPS * 1e3, "updates_per_coarse_step": updates}
            print(f"  {key}: {mlups:.1f} weighted MLUPS, {best / MRES_STEPS * 1e3:.4f} ms per coarse step "
                  f"({updates / 1e6:.2f}M updates per coarse step; best of {MRES_REPS} windows of {MRES_STEPS}); "
                  f"tiers {tiers[key]}")
            mres_physics(sim.f_0, key)
            prof = mres_profile(sim)
            perf[key]["profile"] = prof
            print(f"  {key}, one profiled window: device busy {prof['busy_share']:.3f} of its span, "
                  f"{prof['device_ms_per_coarse_step']:.4f} device ms per coarse step; largest: "
                  + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_ms_per_coarse_step"].items()))
            if policy == xlb.PrecisionPolicy.FP32FP32:
                fs = mres_perturbed(sim.f_0, device, seed=21 + levels)
                parity[label] = mres_tier_parity(st, fs, sim.bc_mask, sim.missing_mask, key)
                del fs
            del sim, st, grid
            torch.cuda.empty_cache()
    return perf, {k: tuple(v) for k, v in counts.items()}, tiers, parity


def mres_walled_path(device):
    """[12]: the walled 2-level cavity under FUSION_AT_FINEST_SFV_ALL: its
    kernels against their plain versions on its masks (halfway, equilibrium
    and fullway epilogues, solids), then 2 coarse steps from a perturbed
    state with counts reset before and read after, against the TORCH tier."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.kernels.fused_step import pack_masks
    from xlb_tpu_torch.mres_perf_optimization_type import MresPerfOptimizationType

    mres_init(xlb.PrecisionPolicy.FP32FP32)
    st = mres_walled(device, MresPerfOptimizationType.FUSION_AT_FINEST_SFV_ALL)
    fs, _, bms, mms = st.prepare_fields()
    fs = mres_perturbed(fs, device, seed=31)
    ok = st._coarse_bc_placement_ok()
    check(not ok, "the walled cavity's inside voxel did not trip the coarse gate")
    print(f"  tiers: finest {st.active_finest_tier}; coarsest {st.active_coarsest_tier}; "
          f"collide-only levels {st.active_collide_levels}")
    errs = {}
    mask = st._fine_mask_ext(bms, mms)
    f_ext = torch.nn.functional.pad(fs[0], (1, 1, 1, 1, 1, 1)).contiguous()
    out, ref = st._cts(f_ext, mask, MRES_OMEGA), st._cts.plain(f_ext, mask, MRES_OMEGA)
    pair = [held(o, r, torch.float32) for o, r in zip(out, ref)]
    errs["finest pair"] = (max(e for e, _ in pair), max(sh for _, sh in pair))
    coarse_mask = pack_masks(bms[1], mms[1])
    k5 = st._fused_collide[1]
    errs["coarsest K5"] = held(k5(fs[1], coarse_mask, MRES_OMEGA), k5.plain(fs[1], coarse_mask, MRES_OMEGA), torch.float32)
    for what, (err, share) in errs.items():
        print(f"  walled {what} vs plain: max|err| {err:.3e} ({share:.3f} of its tolerance)")
        check(share <= 1.0, f"walled cavity: {what} disagrees with its plain version")
    mres_reset_counts()
    a = [f.clone() for f in fs]
    for _ in range(2):
        a = st(a, bms, mms, MRES_OMEGA)
    torch.cuda.synchronize()
    counts = mres_kernel_counts()
    from xlb_tpu_torch.models.multires import MultiresIncompressibleNavierStokesStepper

    plain = MultiresIncompressibleNavierStokesStepper(st.grid, boundary_conditions=st.boundary_conditions)
    b = [f.clone() for f in fs]
    for _ in range(2):
        b = plain(b, bms, mms, MRES_OMEGA)
    err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
    print(f"  walled cavity, 2 coarse steps, CUDA tier (SFV_ALL) vs TORCH tier: max|err| {err:.3e}")
    check(err < 5e-6, f"walled cavity: the CUDA tier disagrees with the TORCH tier ({err})")
    mres_physics(a, "walled cavity", rho_ref=None)  # a perturbed start: finite only
    return {"tier_err": err, "kernel_errs": {k: v[0] for k, v in errs.items()}}, counts


# the 3D collision zoo: the (velocity set, collision) pairs of examples/performance/mlups_3d.py that the
# CUDA kernels K0, K1, K2 take, its 256^3 lid cavity and protocol, and examples/cfd/turbulent_channel_3d.py
ZOO = (("D3Q19", "BGK"), ("D3Q19", "SmagorinskyLESBGK"), ("D3Q19", "TRT"), ("D3Q19", "MRT"),
       ("D3Q19", "PowerLawBGK"), ("D3Q27", "BGK"), ("D3Q27", "KBC"))
ZOO_PARAMS = {"PowerLawBGK": {"consistency": 0.05, "power_index": 0.8}}  # mlups_3d.py's
ZOO_RAGGED = (250, 246, 200)
ZOO_WINDOW, ZOO_WARMUP, ZOO_REPS = 50, 2, 3
ZOO_PARITY_STEPS = 10
ZOO_SOLID = (slice(100, 140), slice(90, 130), slice(60, 100))  # a solid block in every [13] scene
# turbulent_channel_3d.py: run()'s defaults, and run_validation()'s shape and u_tau
CHAN_RUN = {"shape": (64, 32, 32), "re_tau": 60.0, "u_tau": 0.002, "steps": 1000}
CHAN_VAL = {"shape": (192, 96, 64), "re_tau": 180.0, "u_tau": 0.009, "steps": 2000}
CHAN_WINDOW = 500
# the largest relative difference of the run() channel's mean profile, CUDA tier against TORCH tier,
# after 1000 steps (float32 roundoff through the KBC stabilizer; measured, PERF.md)
CHAN_PROFILE_RTOL = 1e-4
ZOO_POWER_ITER_OPS = 4  # a / tau, + eps, pow, 3K x + 1/2 per PowerLaw fixed-point iteration (pow counted once)


def zoo_scene(kind, vs_name, collision, shape, policy, backend, device, re_tau=None, u_tau=None, seed=0):
    """A scene of the collision zoo through the port's public API. "cavity":
    mlups_3d.py's lid cavity (omega 1.9); "channel": turbulent_channel_3d.py's
    _build_channel (halfway walls in z, the body force u_tau^2 / h along x,
    the seeded streamwise profile with noise and rolls through
    initialize_from_macroscopic). Returns (stepper, fields, omega)."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch import velocity_set as vsets
    from xlb_tpu_torch.boundary import EquilibriumBC, FullwayBounceBackBC, HalfwayBounceBackBC
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.helper import initialize_from_macroscopic
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=getattr(vsets, vs_name)(), default_backend=backend, default_precision_policy=policy)
    grid = xlb.grid_factory(shape, device=device)
    box = grid.bounding_box_indices()
    kw = dict(collision_type=collision, collision_params=ZOO_PARAMS.get(collision))
    if kind == "cavity":
        walls = np.unique(
            np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1)
        bcs = [FullwayBounceBackBC(indices=walls.tolist()),
               EquilibriumBC(rho=1.0, u=(LID_U, 0.0, 0.0), indices=grid.bounding_box_indices(remove_edges=True)["top"])]
        stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, **kw)
        return stepper, stepper.prepare_fields(), OMEGA
    nx, ny, nz = shape
    h = nz / 2.0
    visc = u_tau * h / re_tau
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top")], axis=1), axis=1)
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=[HalfwayBounceBackBC(indices=walls.tolist())],
                                                force_vector=np.array([u_tau**2 / h, 0.0, 0.0]), **kw)
    _, f_1, bc_mask, missing_mask = stepper.prepare_fields()
    rng = np.random.default_rng(seed)
    z = (np.arange(nz) + 0.5) / nz
    u0 = np.zeros((3, nx, ny, nz), dtype=np.float32)
    u0[0] = (10 * u_tau * (1 - (2 * z - 1) ** 2))[None, None, :]
    u0 += (0.05 * 10 * u_tau * rng.standard_normal(u0.shape)).astype(np.float32)
    X, Y = (np.arange(nx) + 0.5) / nx, (np.arange(ny) + 0.5) / ny
    amp, envelope = 0.1 * 10 * u_tau, np.sin(np.pi * z)[None, None, :]
    u0[1] += amp * np.sin(4 * np.pi * X)[:, None, None] * envelope
    u0[2] += amp * np.sin(2 * np.pi * X)[:, None, None] * np.cos(6 * np.pi * Y)[None, :, None] * envelope
    rho0 = np.ones((1, nx, ny, nz), dtype=np.float32)
    f_0 = initialize_from_macroscopic(grid, stepper.velocity_set, stepper.precision_policy, rho0, u0)
    return stepper, (f_0, f_1, bc_mask, missing_mask), 1.0 / (3.0 * visc + 0.5)


def zoo_flops(vs, collision, shifted, force):
    """Float32 operations per voxel of the zoo kernels' body, counted from
    csrc/collide_stream.cuh (a division, square root or power counts as
    one): the shifted load and store, moments, the pair-shared
    equilibrium, the collision and the body force."""
    from xlb_tpu_torch.ops.collision import mrt_projectors

    q, d, c = vs.q, vs.d, vs._c
    nz = lambda row: int(np.count_nonzero(row))  # noqa: E731
    pairs = [l for l in range(q) if vs._opp_indices[l] > l]
    moments = (q - 1) + sum(nz(c[a]) for a in range(d)) + 1  # rho, the d first moments, 1 / rho
    eq = (2 * d - 1) + 2 + sum(nz(c[:, l]) - 1 + 9 for l in pairs) + 2
    pi = sum(nz(vs._cc[:, t]) - 1 for t in range(vs._cc.shape[1]))
    strain, shear = 2 * vs._cc.shape[1], [l for l in range(q) if 0 < np.abs(c[:, l]).sum() < 3]
    coll = {
        "BGK": 3 * q,
        "TRT": 5 + 16 * len(pairs) + 3,
        "SmagorinskyLESBGK": q + pi + strain + 9 + 2 * q,
        "PowerLawBGK": q + pi + strain + 4 + 5 * ZOO_POWER_ITER_OPS + 3 + 2 * q,
        "MRT": 3 * q + sum(2 * int(np.count_nonzero(np.abs(P) >= 1e-14)) + 2 * q
                           for g, P in mrt_projectors(vs).items() if g in ("ghost",)),
        "KBC": q + pi + 2 + 15 + len(shear) + 2 + 13 * len(pairs) + 3 + 6 + 5 * len(shear) + 3 * (q - len(shear)),
    }[collision]
    return (2 * q if shifted else 0) + moments + eq + coll + ((d + eq + 2 * q) if force else 0)



def zoo_bound(vs, collision, f, mask, shifted, force, steps=1):
    """(least ms the card could take, "bytes" or "operations") for ``steps``
    zoo steps reading f and the mask once and writing f once."""
    t_bytes = (2 * f.numel() * f.element_size() + mask.numel() * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = steps * zoo_flops(vs, collision, shifted, force) * mask.numel() / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_zoo(device):
    """[13]: K1, K2 and K0 against their plain versions for every pair of
    ZOO on the 256^3 cavity, a ragged cavity and the validation channel,
    f32 and bf16-shifted, with and without a solid block; K0 against K1
    and K2 against two K1 launches, bit for bit. On the 256^3 cavity
    without the block, also times each kernel and its plain version beside
    the bound. Returns {pair: {label: record}}."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.kernels.collide_stream import kernel_collision_spec, packed_cell
    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_blocked import CollideStreamBlocked
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks, stepper_force_vector

    results = {}
    scenes = (("cavity", (N_MAIN,) * 3, {}), ("cavity", ZOO_RAGGED, {}),
              ("channel", CHAN_VAL["shape"], {"re_tau": CHAN_VAL["re_tau"], "u_tau": CHAN_VAL["u_tau"]}))
    for vs_name, collision in ZOO:
        pair = f"{vs_name} {collision}"
        results[pair] = {}
        for kind, shape, extra in scenes:
            stepper, (_, _, bc_mask, missing_mask), omega = zoo_scene(
                kind, vs_name, collision, shape, xlb.PrecisionPolicy.FP32FP32, xlb.ComputeBackend.TORCH, device, **extra)
            vs = stepper.velocity_set
            force = stepper_force_vector(stepper)
            base = dict(collision=kernel_collision_spec(stepper), force_vector=force,
                        bc_specs=[bc_to_spec(b, vs) for b in stepper.boundary_conditions])
            gen = torch.Generator(device=device).manual_seed(13)
            noise = torch.randn((vs.q,) + shape, generator=gen, device=device)
            w = torch.as_tensor(vs._w, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1)
            for solid in (False, True):
                mask = pack_masks(bc_mask, missing_mask)
                if solid:
                    mask[ZOO_SOLID] = packed_cell(255, vs.q)
                for store, shifted in ((torch.float32, False), (torch.bfloat16, True)):
                    f = ((0.02 * w * noise) if shifted else (w * (1.0 + 0.05 * noise))).to(store).contiguous()
                    kw = dict(base, store_dtype=store, shifted=shifted, has_solids=solid or stepper.has_solids)
                    one, blocked = CollideStreamStep(vs, shape, **kw), CollideStreamBlocked(vs, shape, **kw)
                    two = CollideStreamKStep(vs, shape, steps=2, **kw)
                    k1, k0, k2 = one(f, mask, omega), blocked(f, mask, omega), two(f, mask, omega)
                    k11 = one(k1, mask, omega)
                    p1 = one.plain(f, mask, omega)
                    p2 = one.plain(p1, mask, omega)
                    torch.cuda.synchronize()
                    label = (f"{kind} {'x'.join(map(str, shape))} {'f32' if store == torch.float32 else 'bf16-shifted'}"
                             + (" solid" if solid else ""))
                    for t, what in ((k1, "K1"), (k0, "K0"), (k2, "K2")):
                        check(bool(torch.isfinite(t.float()).all()), f"{pair} {label}: non-finite {what} output")
                    (e1, s1), (e0, s0), (e2, s2) = held(k1, p1, store), held(k0, p1, store), held(k2, p2, store)
                    same01, same2 = torch.equal(k0, k1), torch.equal(k2, k11)
                    print(f"  {pair} {label}: K1 {e1:.2e} ({s1:.3f} of tol), K0 {e0:.2e} ({s0:.3f}), "
                          f"K2 {e2:.2e} ({s2:.3f}); K0 == K1 {same01}, K2 == 2 K1 {same2}")
                    check(max(s1, s0, s2) <= 1.0, f"{pair} {label}: a kernel disagrees with its plain version")
                    check(same01, f"{pair} {label}: K0 differs from K1")
                    check(same2, f"{pair} {label}: K2 differs from two K1 launches")
                    rec = {"K1": {"max_abs_err": e1, "tolerance_share": s1}, "K0": {"max_abs_err": e0, "tolerance_share": s0},
                           "K2": {"max_abs_err": e2, "tolerance_share": s2}}
                    del k1, k0, k2, k11, p1, p2
                    if kind == "cavity" and shape == (N_MAIN,) * 3 and not solid:
                        for name, kern, steps in (("K1", one, 1), ("K2", two, 2), ("K0", blocked, 1)):
                            r = rec[name]
                            r["ms"] = cuda_ms(lambda: kern(f, mask, omega), 20)
                            r["plain_ms"] = cuda_ms(lambda: kern.plain(f, mask, omega), 1)
                            r["bound_ms"], r["bound_by"] = zoo_bound(vs, collision, f, mask, shifted, force is not None,
                                                                     steps)
                        print("    " + "; ".join(f"{n} {rec[n]['ms']:.4f} ms (plain {rec[n]['plain_ms']:.2f}, bound "
                                                 f"{rec[n]['bound_ms']:.4f} by {rec[n]['bound_by']})" for n in ("K1", "K2", "K0")))
                    results[pair][label] = rec
                    del f
                    torch.cuda.empty_cache()
            del stepper, bc_mask, missing_mask, noise
            torch.cuda.empty_cache()
    return results


def zoo_counts(reset=False):
    """{kernel class name: (launches, plain calls)} of K1, K2 and K0."""
    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_blocked import CollideStreamBlocked
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep

    kernels = (CollideStreamStep, CollideStreamKStep, CollideStreamBlocked)
    if reset:
        for k in kernels:
            k.launches = k.plain_calls = 0
    return {k.__name__: (k.launches, k.plain_calls) for k in kernels}


def zoo_tier_parity(stepper, fields, omega, collision, label):
    """ZOO_PARITY_STEPS steps of stepper(...) (K1) against the TORCH tier on
    the card from the same state (rtol 1e-4). Returns max |err|."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    f_0, f_1, bc_mask, missing_mask = fields
    force = getattr(stepper.collision, "force_vector", None)
    plain = IncompressibleNavierStokesStepper(stepper.grid, boundary_conditions=stepper.boundary_conditions,
                                              collision_type=collision, collision_params=ZOO_PARAMS.get(collision),
                                              force_vector=force, compute_backend=xlb.ComputeBackend.TORCH)
    a0, a1 = f_0.contiguous(), f_1.clone()
    b0, b1 = f_0.clone(), f_1.clone()
    for i in range(ZOO_PARITY_STEPS):
        a0, a1 = stepper(a0, a1, bc_mask, missing_mask, omega, i)
        a0, a1 = a1, a0
        b0, b1 = plain(b0, b1, bc_mask, missing_mask, omega, i)
        b0, b1 = b1, b0
    err, ok = within(a0, b0, rtol=1e-4, atol=1e-6)
    print(f"  {label}: {ZOO_PARITY_STEPS} steps of stepper(...), CUDA tier vs TORCH tier: max|err| {err:.3e} ok={ok}")
    check(ok, f"{label}: CUDA tier disagrees with the TORCH tier")
    return err


def zoo_main_path(device):
    """[14]: mlups_3d.py's protocol at 256^3 (omega 1.9, lid 0.02, windows
    of 50, 2 warm-up windows, best of 3, MLUPS = 256^3 x 50 / s / 1e6, host
    clock around work that ends in a synchronize) for every pair of ZOO
    under FP32FP32 and FP32BF16, through K1 (build_fused_window with
    temporal_steps=1), K2 (build_multi_step: the default window) and K0
    (kernel="blocked"), each route from the rest state; physics checks
    after each route; FP32FP32 also 10 steps of stepper(...) against the
    TORCH tier after the K1 route. Each route's launch counts are
    reset just before it and read just after. Returns ({pair: {policy:
    {route: mlups}}}, total launches, parity errors)."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.examples.performance.mlups_2d import time_windows
    from xlb_tpu_torch.kernels.fused_step import build_fused_window

    shape = (N_MAIN,) * 3
    perf, parity = {}, {}
    totals = {name: 0 for name in zoo_counts(reset=True)}
    for vs_name, collision in ZOO:
        pair = f"{vs_name} {collision}"
        perf[pair] = {}
        for policy in (xlb.PrecisionPolicy.FP32FP32, xlb.PrecisionPolicy.FP32BF16):
            stepper, (f_0, f_1, bc_mask, missing_mask), omega = zoo_scene(
                "cavity", vs_name, collision, shape, policy, xlb.ComputeBackend.CUDA, device)
            routes = (("K1", "CollideStreamStep", build_fused_window(stepper, ZOO_WINDOW, temporal_steps=1), ZOO_WINDOW),
                      ("K2", "CollideStreamKStep", stepper.build_multi_step(ZOO_WINDOW), ZOO_WINDOW // 2),
                      ("K0", "CollideStreamBlocked", build_fused_window(stepper, ZOO_WINDOW, kernel="blocked"), ZOO_WINDOW))
            perf[pair][policy.name] = {}
            start = (f_0, f_1)
            for route, cls, run, per_window in routes:
                # each route starts from prepare_fields()'s rest state, as a run of mlups_3d.py does
                zoo_counts(reset=True)
                best, (f_0, f_1) = time_windows(run, (start[0].clone(), start[1].clone(), bc_mask, missing_mask), omega,
                                                ZOO_WARMUP, ZOO_REPS)
                counts = zoo_counts()
                launches = counts[cls][0]
                check(launches == (ZOO_WARMUP + ZOO_REPS) * per_window, f"{pair} {route}: {launches} launches of {cls}")
                check(all(p == 0 for _, p in counts.values()), f"{pair} {route}: a plain version ran on the main path")
                totals = {k: totals[k] + counts[k][0] for k in totals}
                mlups = N_MAIN**3 * ZOO_WINDOW / best / 1e6
                perf[pair][policy.name][route] = mlups
                print(f"  {pair} {policy.name} {route}: {mlups:.1f} MLUPS ({best / ZOO_WINDOW * 1e3:.4f} ms/step, "
                      f"{launches} launches of {cls})")
                physics_checks(stepper, f_0, bc_mask, f"{pair} {policy.name} {route}")
                if policy == xlb.PrecisionPolicy.FP32FP32 and route == "K1":
                    parity[pair] = zoo_tier_parity(stepper, (f_0, f_1, bc_mask, missing_mask), omega, collision, pair)
            del stepper, f_0, f_1, start, bc_mask, missing_mask, routes, run
            torch.cuda.empty_cache()
    return perf, totals, parity


def mean_profile(f, vs):
    """The streamwise velocity averaged over x and y, per z (float64 NumPy)."""
    from xlb_tpu_torch.ops.macroscopic import density, velocity

    f = f.float()
    u = velocity(f, density(f), vs._c)
    return u[0].mean(dim=(0, 1)).double().cpu().numpy()


def channel_path(device):
    """[15]: turbulent_channel_3d.py on the CUDA tier (D3Q27, KBC, the body
    force, halfway walls in z, FP32FP32). run()'s defaults against the TORCH
    tier (mean profile); then the validation shape at run_validation()'s
    u_tau for CHAN_VAL["steps"] steps in windows of CHAN_WINDOW (MLUPS,
    finite, bulk velocity rising). Returns (record, launch counts)."""
    import torch

    import xlb_tpu_torch as xlb

    fp32 = xlb.PrecisionPolicy.FP32FP32
    args = dict(re_tau=CHAN_RUN["re_tau"], u_tau=CHAN_RUN["u_tau"])
    profiles = []
    counts = zoo_counts(reset=True)
    for backend in (xlb.ComputeBackend.CUDA, xlb.ComputeBackend.TORCH):
        stepper, fields, omega = zoo_scene("channel", "D3Q27", "KBC", CHAN_RUN["shape"], fp32, backend, device, **args)
        f_0, _ = stepper.build_multi_step(CHAN_RUN["steps"])(*fields, omega)
        check(bool(torch.isfinite(f_0).all()), f"channel run() on {backend.name}: non-finite populations")
        profiles.append(mean_profile(f_0, stepper.velocity_set))
        if backend == xlb.ComputeBackend.CUDA:
            counts = zoo_counts()
    cuda_p, torch_p = profiles
    rel = float(np.abs(cuda_p - torch_p).max() / np.abs(torch_p).max())
    print(f"  run() {CHAN_RUN['shape']} Re_tau {CHAN_RUN['re_tau']}, {CHAN_RUN['steps']} steps, omega {omega:.6f}: "
          f"bulk u {cuda_p.mean():.6f}, centreline {cuda_p[len(cuda_p) // 2]:.6f}, wall-adjacent {cuda_p[0]:.6f}; "
          f"mean profile CUDA vs TORCH tier max rel diff {rel:.3e} (bound {CHAN_PROFILE_RTOL:g})")
    check(rel <= CHAN_PROFILE_RTOL, "the channel's CUDA tier disagrees with its TORCH tier")
    check(counts["CollideStreamKStep"][0] > 0 and all(p == 0 for _, p in counts.values()),
          "the channel window did not run through the k-step kernel alone")

    args = dict(re_tau=CHAN_VAL["re_tau"], u_tau=CHAN_VAL["u_tau"])
    stepper, (f_0, f_1, bc_mask, missing_mask), omega = zoo_scene(
        "channel", "D3Q27", "KBC", CHAN_VAL["shape"], fp32, xlb.ComputeBackend.CUDA, device, **args)
    run = stepper.build_multi_step(CHAN_WINDOW)
    bulk, seconds = [float(mean_profile(f_0, stepper.velocity_set).mean())], []
    for _ in range(CHAN_VAL["steps"] // CHAN_WINDOW):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f_0, f_1 = run(f_0, f_1, bc_mask, missing_mask, omega)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(f_0).all()), "validation channel: non-finite populations")
        bulk.append(float(mean_profile(f_0, stepper.velocity_set).mean()))
    mlups = int(np.prod(CHAN_VAL["shape"])) * CHAN_WINDOW / min(seconds) / 1e6
    print(f"  validation shape {CHAN_VAL['shape']} Re_tau {CHAN_VAL['re_tau']} u_tau {CHAN_VAL['u_tau']}, omega "
          f"{omega:.6f}: {mlups:.1f} MLUPS (best of {len(seconds)} windows of {CHAN_WINDOW}); bulk u "
          f"{' -> '.join(f'{b:.6f}' for b in bulk)}")
    check(all(b1 > b0 for b0, b1 in zip(bulk, bulk[1:])), "validation channel: the bulk velocity did not rise")
    return {"run_profile_rel_diff": rel, "run_bulk_u": float(cuda_p.mean()), "validation_mlups": mlups,
            "validation_bulk_u": bulk}, counts


# kernel="dma" autograd of the zoo through K8: (kind, velocity set, collision, shape, API)
DMA_GRAD_CASES = (("cavity", "D3Q19", "TRT", (48, 40, 32), "stepper"),
                  ("channel", "D3Q27", "KBC", CHAN_RUN["shape"], "build_multi_step"))
DMA_GRAD_STEPS = 4
ZOO_ADJ_SOLID = (slice(20, 28), slice(16, 24), slice(12, 20))  # of the small cavity, a solid block


def compare_zoo_adjoint(device):
    """[15]: K8 against its plain version (torch.func.vjp of the plain step)
    for every pair of ZOO on the SMALL cavity with a solid block and on the
    validation channel (body force, halfway walls), f32 and bf16-shifted,
    seeded primal and cotangent; rtol 1e-4, atol 1e-6 (df) and 1e-7 (dom),
    as [5]. On the channel, f32, also times kernel and plain version
    (CUDA events) beside the bytes the kernel moves. Returns {pair: {label:
    record}}."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream import kernel_collision_spec, packed_cell
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks, stepper_force_vector

    results = {}
    scenes = (("cavity", SMALL, {}), ("channel", CHAN_VAL["shape"],
                                      {"re_tau": CHAN_VAL["re_tau"], "u_tau": CHAN_VAL["u_tau"]}))
    for vs_name, collision in ZOO:
        pair = f"{vs_name} {collision}"
        results[pair] = {}
        for kind, shape, extra in scenes:
            stepper, (_, _, bc_mask, missing_mask), omega = zoo_scene(
                kind, vs_name, collision, shape, xlb.PrecisionPolicy.FP32FP32, xlb.ComputeBackend.TORCH, device, **extra)
            vs = stepper.velocity_set
            mask = pack_masks(bc_mask, missing_mask)
            if kind == "cavity":
                mask[ZOO_ADJ_SOLID] = packed_cell(255, vs.q)
            gen = torch.Generator(device=device).manual_seed(15)
            noise = torch.randn((vs.q,) + shape, generator=gen, device=device)
            w = torch.as_tensor(vs._w, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1)
            g = (w * torch.randn((vs.q,) + shape, generator=gen, device=device)).contiguous()
            for store, shifted in ((torch.float32, False), (torch.bfloat16, True)):
                f = ((0.02 * w * noise) if shifted else (w * (1.0 + 0.05 * noise))).to(store).contiguous()
                adj = CollideStreamAdjoint(vs, shape, collision=kernel_collision_spec(stepper), store_dtype=store,
                                           bc_specs=[bc_to_spec(b, vs) for b in stepper.boundary_conditions],
                                           shifted=shifted, has_solids=True, force_vector=stepper_force_vector(stepper))
                (df, dom), (pdf, pdom) = adj(f, g, mask, omega), adj.plain(f, g, mask, omega)
                torch.cuda.synchronize()
                label = f"{kind} {'x'.join(map(str, shape))} {'f32' if store == torch.float32 else 'bf16-shifted'}"
                check(bool(torch.isfinite(df).all() and torch.isfinite(dom).all()), f"{pair} {label}: non-finite K8")
                e1, s1 = tolerance_share(df, pdf, rtol=1e-4, atol=1e-6)
                e2, s2 = tolerance_share(dom, pdom, rtol=1e-4, atol=1e-7)
                rec = {"max_abs_err": max(e1, e2), "tolerance_share": max(s1, s2)}
                del df, dom, pdf, pdom
                if kind == "channel" and store == torch.float32:
                    rec["ms"] = cuda_ms(lambda: adj(f, g, mask, omega), 5)
                    rec["plain_ms"] = cuda_ms(lambda: adj.plain(f, g, mask, omega), 1)
                    # reads f, g and the mask, writes df and dom
                    rec["bytes_ms"] = (f.numel() * f.element_size() + 2 * g.numel() * 4 + 2 * mask.numel() * 4
                                       ) / HBM_BYTES_PER_S * 1e3
                print(f"  {pair} {label}: K8 df max|err| {e1:.2e}, dom_field {e2:.2e} ({rec['tolerance_share']:.3f} "
                      "of tol)" + (f"; {rec['ms']:.3f} ms (plain {rec['plain_ms']:.2f} ms, bytes alone "
                                   f"{rec['bytes_ms']:.4f} ms)" if "ms" in rec else ""))
                check(rec["tolerance_share"] <= 1.0, f"{pair} {label}: K8 disagrees with its plain version")
                results[pair][label] = rec
                del f
                torch.cuda.empty_cache()
            del stepper, bc_mask, missing_mask, mask, noise, g
            torch.cuda.empty_cache()
    return results


def zoo_gradients(device):
    """[15], the default step's autograd on the zoo: a kernel="dma"
    stepper(...) of the D3Q19 TRT cavity and a build_multi_step(4) window
    of the forced D3Q27 KBC channel differentiate on the card, forward
    through K1 / K2 and backward through K8 (once per step), from a seeded
    5% perturbation of the initial state (as gradient_parity). The
    gradients of f_0 and omega are held against TORCH-tier autograd in
    float64 (FP64FP64): no farther from it than twice the float32 TORCH
    tier's own error, plus 1e-6 (f_0) and 2e-3 relative (omega) -- KBC's
    entropic stabilizer makes its float32 derivative ill-conditioned (both
    float32 tiers are ~4e-5 from float64 on the test's channel), so the
    float32 TORCH tier is no sharper a reference than the kernel. Returns
    {case: (d f_0 max |err|, d omega rel err) against float64}."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint

    P = xlb.PrecisionPolicy
    out = {}
    for kind, vs_name, collision, shape, api in DMA_GRAD_CASES:
        extra = {"re_tau": CHAN_RUN["re_tau"], "u_tau": CHAN_RUN["u_tau"]} if kind == "channel" else {}
        grads, counts = {}, {}
        for tier, backend, policy in (("cuda", xlb.ComputeBackend.CUDA, P.FP32FP32),
                                      ("torch f32", xlb.ComputeBackend.TORCH, P.FP32FP32),
                                      ("torch f64", xlb.ComputeBackend.TORCH, P.FP64FP64)):
            stepper, (f_0, f_1, bc_mask, missing_mask), omega = zoo_scene(
                kind, vs_name, collision, shape, policy, backend, device, **extra)
            zoo_counts(reset=True)
            CollideStreamAdjoint.launches = CollideStreamAdjoint.plain_calls = 0
            gen = torch.Generator(device=device).manual_seed(15)
            noise = torch.randn(f_0.shape, generator=gen, device=device, dtype=torch.float32).to(f_0.dtype)
            f = (f_0 * (1.0 + 0.05 * noise)).requires_grad_(True)
            om = torch.tensor(omega, device=device, dtype=f_0.dtype, requires_grad=True)
            if api == "stepper":
                res = stepper(f, f_1, bc_mask, missing_mask, om)[1]
            else:
                res = stepper.build_multi_step(DMA_GRAD_STEPS)(f, f_1, bc_mask, missing_mask, om)[0]
            (res ** 2).sum().backward()
            grads[tier] = (f.grad.double(), float(om.grad))
            if tier == "cuda":
                counts = zoo_counts()
                counts["CollideStreamAdjoint"] = (CollideStreamAdjoint.launches, CollideStreamAdjoint.plain_calls)
            del stepper, f_0, f_1, bc_mask, missing_mask, f, om, res, noise
        ref, w_ref = grads["torch f64"]
        err = {t: (float((g - ref).abs().max()), abs(w - w_ref)) for t, (g, w) in grads.items() if t != "torch f64"}
        (e_c, ew_c), (e_t, ew_t) = err["cuda"], err["torch f32"]
        ok1 = e_c <= 2 * e_t + 1e-6
        ok2 = ew_c <= 2 * ew_t + 2e-3 * abs(w_ref)
        label = f"{vs_name} {collision} {kind} {'x'.join(map(str, shape))} {api}"
        print(f"  {label}: against float64 TORCH-tier autograd: d f_0 max|err| CUDA {e_c:.3e}, TORCH f32 {e_t:.3e} "
              f"ok={ok1}; d omega {grads['cuda'][1]:.6e} / {grads['torch f32'][1]:.6e} vs {w_ref:.6e} ok={ok2}; "
              f"CUDA vs TORCH f32 d f_0 {float((grads['cuda'][0] - grads['torch f32'][0]).abs().max()):.3e}; "
              f"launches {counts}")
        check(ok1 and ok2, f"{label}: CUDA-tier gradients less accurate than the TORCH tier's")
        steps = 1 if api == "stepper" else DMA_GRAD_STEPS
        check(counts["CollideStreamAdjoint"] == (steps, 0), f"{label}: K8 did not run once per step, alone")
        check(sum(n for n, _ in counts.values()) > steps and all(p == 0 for _, p in counts.values()),
              f"{label}: the forward did not run through K1 / K2 alone")
        out[label] = (e_c, ew_c / abs(w_ref))
        torch.cuda.empty_cache()
    return out


# the copy-bandwidth probes (K9-K12): the scripts' field, a ragged one and one of 420 bytes
PROBE_FIELDS = ((19, 256, 256, 256), (3, 17, 13, 11), (7, 5, 3))
PROBE_SEED = 16


def probe_kernels(q):
    """(kernel, variant label, wrapper, plain version) of every probe: K9
    under memory_bandwidth.py's launch shapes, K10, K11 over q channels,
    K12 under dma_experiments.py's five variants."""
    from xlb_tpu_torch.examples.performance.dma_experiments import MANUAL_NAMES
    from xlb_tpu_torch.examples.performance.memory_bandwidth import LAUNCH_SHAPES
    from xlb_tpu_torch.kernels.copy_bandwidth import (MANUAL_VARIANTS, BulkCopy, ManualScaleCopy, PipelinedCopy,
                                                      SplitBulkCopy, copy_plain, scale_copy_plain)

    out = [("K9", PipelinedCopy(t, v).label, PipelinedCopy(t, v), copy_plain) for t, v in LAUNCH_SHAPES]
    out += [("K10", "1 range", BulkCopy(), copy_plain), ("K11", f"{q} ranges", SplitBulkCopy(q), copy_plain)]
    out += [("K12", name, ManualScaleCopy(*v), scale_copy_plain) for name, v in zip(MANUAL_NAMES, MANUAL_VARIANTS)]
    return out


def compare_probes(device):
    """[16]: every probe kernel and variant against its plain version, bit
    for bit (torch.equal), on each PROBE_FIELDS field (seeded normal
    values), the small ones also at an address 4 bytes past a 16-byte
    boundary (a scalar head before the bulk copies). Returns (the number of
    comparisons, {kernel: max |kernel - plain|})."""
    import torch

    n_cmp, errs = 0, {}
    for shape in PROBE_FIELDS:
        numel = int(np.prod(shape))
        gen = torch.Generator(device=device).manual_seed(PROBE_SEED)
        base = torch.randn(numel + 1, generator=gen, device=device)
        views = [("aligned", base[:numel].view(shape))]
        if numel < 2**20:
            views.append(("offset 4 B", base[1:].view(shape)))
        for where, x in views:
            same = []
            for kernel, label, wrapper, plain in probe_kernels(shape[0]):
                out, ref = wrapper(x), plain(x)
                torch.cuda.synchronize()
                ok = torch.equal(out, ref)
                errs[kernel] = max(errs.get(kernel, 0.0), float((out - ref).abs().max()))
                same.append(f"{kernel} {label} {ok}")
                check(ok, f"{kernel} {label} differs from its plain version on {shape} ({where})")
                n_cmp += 1
                del out, ref
            print(f"  {shape} {where} ({numel * 4} B): bit-equal to the plain version: " + "; ".join(same))
        del base, views
        torch.cuda.empty_cache()
    return n_cmp, errs


def probe_path(device):
    """[16]: memory_bandwidth.run() and dma_experiments.run() at their
    defaults, the probes' launch counts reset just before and read just
    after; the plain versions timed at the scripts' field. Returns (the two
    runs' results, counts, plain ms by kernel, the measured copy roofline)."""
    import torch

    from xlb_tpu_torch.examples.performance import dma_experiments, memory_bandwidth
    from xlb_tpu_torch.examples.performance.common import field
    from xlb_tpu_torch.kernels import copy_bandwidth

    copy_bandwidth.counts(reset=True)
    runs = {"memory_bandwidth": memory_bandwidth.run(device), "dma_experiments": dma_experiments.run(device)}
    counts = copy_bandwidth.counts()
    print(f"  launch counts (launches, plain calls): {counts}")
    for name, (launches, plain_calls) in counts.items():
        check(launches > 0 and plain_calls == 0, f"{name}: not launched, or its plain version ran, in the probe runs")
    x = field(256, 19, device)
    plain_ms = {"copy": cuda_ms(lambda: copy_bandwidth.copy_plain(x), 10),
                "scale": cuda_ms(lambda: copy_bandwidth.scale_copy_plain(x), 10)}
    del x
    torch.cuda.empty_cache()
    best = max(((rec["GBps"], f"{script}: {name}") for script, r in runs.items() for name, rec in r["lines"].items()))
    print(f"  plain versions at (19, 256, 256, 256): clone {plain_ms['copy']:.4f} ms, scale {plain_ms['scale']:.4f} ms; "
          f"measured copy roofline {best[0]:.1f} GB/s ({best[1]}) = {best[0] * 1e9 / HBM_BYTES_PER_S:.3f} of the "
          f"data sheet's {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    return runs, counts, plain_ms, {"GBps": best[0], "line": best[1]}


def probe_records(runs, counts, plain_ms, n_cmp, errs):
    """The kernels-line entries of K9-K12: each kernel's best variant of the
    [16] runs beside the plain version, the bound (the array read and
    written at the data-sheet rate) and the library call (copy_ for K9-K11,
    torch.mul(..., out=) for K12)."""
    mb, dma = runs["memory_bandwidth"]["lines"], runs["dma_experiments"]["lines"]
    bound_ms = 2 * runs["dma_experiments"]["bytes"] / HBM_BYTES_PER_S * 1e3
    table = (
        ("pipelined_copy", "PipelinedCopy", "examples/performance/memory_bandwidth.py:55",
         {k: v for k, v in mb.items() if k.startswith("K9")}, mb["library copy (Tensor.copy_)"], "copy"),
        ("bulk_copy", "BulkCopy", "examples/performance/dma_experiments.py:62",
         {k: v for k, v in dma.items() if "(K10)" in k}, dma["A0 library copy_"], "copy"),
        ("split_bulk_copy", "SplitBulkCopy", "examples/performance/dma_experiments.py:83",
         {k: v for k, v in dma.items() if "(K11)" in k}, dma["A0 library copy_"], "copy"),
        ("manual_scale_copy", "ManualScaleCopy", "examples/performance/dma_experiments.py:161",
         {k: v for k, v in dma.items() if "(K12)" in k}, dma["E library scale-copy"], "scale"),
    )
    out = []
    for (name, cls, rep, lines, library, plain), kernel in zip(table, ("K9", "K10", "K11", "K12")):
        variant, rec = min(lines.items(), key=lambda kv: kv[1]["ms"])
        out.append({
            "name": name, "route": "cuda", "source": "xlb_tpu_torch/csrc/copy_bandwidth.cu", "replaces": rep,
            "launches": counts[cls][0], "max_abs_err": errs[kernel], "ms": rec["ms"], "plain_ms": plain_ms[plain],
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library["ms"], "variant": variant,
            "bit_equal_comparisons": n_cmp,
        })
    return out


def ptxas_summary(report):
    """One line per kernel family and (stencil, collision) of ptxas's
    report: the register range over the store forms and variants, the
    largest spill and the static shared memory."""
    import re

    groups = {}
    for name, regs, spill_st, spill_ld, smem in report:
        m = re.match(r"_ZN3xlb(\d+)", name)
        kernel = name[m.end():m.end() + int(m.group(1))] if m else name
        stencil = re.search(r"D3Q27|D3Q19|D2Q9", name)
        coll = re.search(r"(Coll[A-Za-z]+?)E", name)
        key = " ".join(x for x in (kernel, stencil.group(0) if stencil else "", coll.group(1) if coll else "") if x)
        g = groups.setdefault(key, [])
        g.append((regs, spill_st, spill_ld, smem))
    lines = []
    for key, g in groups.items():
        regs = [r for r, _, _, _ in g]
        spill = max(max(st, ld) for _, st, ld, _ in g)
        lines.append(f"{key}: {len(g)} instantiations, {min(regs)}-{max(regs)} registers, largest spill {spill} B, "
                     f"static smem {max(sm for *_, sm in g)} B")
    return lines


def ab_line(device, label, quick):
    """``--ab LABEL [--quick]``: one tree's kernel times for comparing two
    trees on one card, as one line ``AB {json}``: at the main paths'
    shapes, K1 and K2 (256^3 lid cavity), K8 (its adjoint), K3 and K4
    (k = 8, the 2048^2 2D cavity), f32 and bf16 deviation form, in ms per
    call (``cuda_ms``), and [4]'s MLUPS under both policies. ``--quick``
    leaves out K8 and the MLUPS. Run it from the root of each tree in
    turns (parent, change, change, parent) within one call."""
    out = {"tree": label}
    big = compare_kernels((N_MAIN,) * 3, device, seed=1, time_them=True)
    out["K1"] = {k: v["ms"] for k, v in big["collide_stream_step"].items()}
    out["K2"] = {k: v["ms"] for k, v in big["collide_stream_kstep"].items()}
    if not quick:
        adj = compare_adjoint((N_MAIN,) * 3, device, seed=6, time_them=True, solid=False)
        out["K8"] = {k: v["ms"] for k, v in adj.items()}
    two_d = compare_kernels_2d("cavity", (N_2D, N_2D), device, seed=9, steps=(8,), time_them=True)
    out["K3"] = {k: v["ms"] for k, v in two_d["collide_stream_2d_step"].items()}
    out["K4"] = {k: v["ms"] for k, v in two_d["collide_stream_2d_kstep"].items()}
    if not quick:
        perf, _ = main_path(device)
        out["main_mlups"] = {k: v[0] for k, v in perf.items()}
    print("AB " + json.dumps(out))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from xlb_tpu_torch.kernels import _cuda

    device = torch.device("cuda", 0)
    if "--ab" in sys.argv:
        _cuda.load_library()
        ab_line(device, sys.argv[sys.argv.index("--ab") + 1], "--quick" in sys.argv)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    t_start = t0 = time.perf_counter()
    _cuda.load_library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_summary(_cuda.ptxas_report()):
        print("    " + line)

    print("[3] kernels against their plain versions")
    compare_kernels(SMALL, device, seed=0, time_them=False)
    compare_kernels(SMALL, device, seed=2, time_them=False, solid=True)
    big = compare_kernels((N_MAIN,) * 3, device, seed=1, time_them=True)
    many_bcs = {"3d": compare_many_bcs_3d(SMALL, device, seed=7)}

    print(f"[4] main path at {N_MAIN}^3, {smi}")
    perf, counts = main_path(device)
    print(f"  launch counts (launches, plain calls): {counts}")
    for name, (launches, plain_calls) in counts.items():
        check(launches > 0, f"{name} was not launched on the main path")
        check(plain_calls == 0, f"{name}'s plain version ran on the main path")

    print("[5] the adjoint kernel against its plain version")
    compare_adjoint(SMALL, device, seed=3, time_them=False, solid=True)
    compare_adjoint(SMALL, device, seed=4, time_them=False, solid=False)
    big["collide_stream_adjoint"] = compare_adjoint((N_MAIN,) * 3, device, seed=6, time_them=True, solid=False)

    print(f"[6] training path at {N_MAIN}^3, {smi}")
    gradient_parity(device)
    training, train_counts = training_path(device)
    print(f"  launch counts (launches, plain calls): {train_counts}")
    for name, (launches, plain_calls) in train_counts.items():
        check(launches > 0, f"{name} was not launched on the training path")
        check(plain_calls == 0, f"{name}'s plain version ran on the training path")
    check(train_counts["CollideStreamAdjoint"][0] == 2 * TRAIN_ITERS * TRAIN_WINDOW, "adjoint launches != W per backward")

    print("[7] the 2D kernels against their plain versions")
    big_2d = compare_kernels_2d("halfway_cavity", SMALL_2D, device, seed=11)
    for more in (compare_kernels_2d("cylinder", CYL_SHAPE, device, seed=12, inout="zouhe"),
                 compare_kernels_2d("cylinder", CYL_SHAPE, device, seed=12, inout="regularized"),
                 compare_kernels_2d("many_bcs", SMALL_2D, device, seed=14),
                 compare_kernels_2d("cavity", (N_2D, N_2D), device, seed=9, steps=K_SWEEP_2D, time_them=True)):
        for name, recs in more.items():
            big_2d[name].update(recs)

    print(f"[8] 2D main path at {N_2D}^2, {smi}")
    perf_2d, counts_2d = main_path_2d(device)
    print(f"  launch counts (launches, plain calls): {counts_2d}")
    for name, (launches, plain_calls) in counts_2d.items():
        check(launches > 0, f"{name} was not launched on the 2D main path")
        check(plain_calls == 0, f"{name}'s plain version ran on the 2D main path")

    print(f"[9] the cylinder at its script's defaults, {smi}")
    cylinder, cyl_counts = cylinder_path(device)
    print(f"  launch counts (launches, plain calls): {cyl_counts}")
    for name, (launches, plain_calls) in cyl_counts.items():
        check(launches > 0 and plain_calls == 0, f"{name}: not launched, or its plain version ran, on the cylinder")

    print("[10] the multires kernels against their plain versions at the benchmark's shapes")
    big_mres = compare_kernels_mres(device, seed=41, solid=False, time_them=True)
    for name, recs in compare_kernels_mres(device, seed=42, solid=True, time_them=False).items():
        big_mres[name].update(recs)

    print(f"[11] the bench.py multires scenes (mlups_3d_multires.py, FUSION_AT_FINEST), {smi}")
    perf_mres, counts_mres, tiers_mres, parity_mres = mres_main_path(device)
    print(f"  launch counts of the timed windows (launches, plain calls): {counts_mres}")
    check(counts_mres["CollideThenStream"][0] > 0 and counts_mres["CollideThenStream pair"][0] > 0,
          "the collide-then-stream kernel was not launched on the multires main path")
    check(counts_mres["CollideThenStream"][1] == 0, "the collide-then-stream plain version ran on the multires main path")

    print("[12] the walled 2-level cavity under FUSION_AT_FINEST_SFV_ALL")
    walled, counts_walled = mres_walled_path(device)
    print(f"  launch counts (launches, plain calls): {counts_walled}")
    for name, (launches, plain_calls) in counts_walled.items():
        check(launches > 0 and plain_calls == 0, f"{name}: not launched, or its plain version ran, on the walled cavity")

    print("[13] the collision zoo's kernels (K1, K2, K0) against their plain versions")
    big_zoo = compare_zoo(device)

    print(f"[14] mlups_3d.py's cavity at {N_MAIN}^3 for every collision, through K1, K2 and K0, {smi}")
    perf_zoo, counts_zoo, parity_zoo = zoo_main_path(device)
    print(f"  launches over the timed routes: {counts_zoo}")

    print(f"[15] the turbulent channel (turbulent_channel_3d.py), {smi}")
    channel, counts_chan = channel_path(device)
    print(f"  launch counts of the run() window (launches, plain calls): {counts_chan}")
    zoo_adjoint = compare_zoo_adjoint(device)
    zoo_grads = zoo_gradients(device)

    print(f"[16] the copy-bandwidth probes (K9-K12: memory_bandwidth.py, dma_experiments.py), {smi}")
    n_cmp, probe_errs = compare_probes(device)
    probes, probe_counts, probe_plain_ms, roofline = probe_path(device)

    kernels = []
    for name, cls, source, rep, launches in (
        ("collide_stream_step", "CollideStreamStep", "xlb_tpu_torch/csrc/collide_stream_3d.cuh",
         "xlb_tpu/kernels/collide_stream_dma.py:237", counts),
        ("collide_stream_kstep", "CollideStreamKStep", "xlb_tpu_torch/csrc/collide_stream_3d.cuh",
         "xlb_tpu/kernels/collide_stream_2step.py:309", counts),
        ("collide_stream_adjoint", "CollideStreamAdjoint", "xlb_tpu_torch/csrc/adjoint_step.cuh",
         "xlb_tpu/kernels/adjoint_step.py:366", train_counts),
    ):
        rec = big[name]
        prod = rec["bf16-shifted"]  # the main path's production variant (FP32BF16: bf16 deviation form)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "launches": launches[cls][0],
            "max_abs_err": max(r["max_abs_err"] for r in rec.values()),
            "ms": prod["ms"], "plain_ms": prod["plain_ms"], "bound_ms": prod["bound_ms"], "bound_by": prod["bound_by"],
            "library_ms": None,  # no single PyTorch call computes an LBM step or its adjoint
        })
    for name, cls, rep, label in (
        ("collide_stream_2d_step", "CollideStream2DStep", "xlb_tpu/kernels/collide_stream_2d.py:111", "f32 cavity"),
        ("collide_stream_2d_kstep", "CollideStream2DKStep", "xlb_tpu/kernels/collide_stream_2d.py:270",
         "f32 cavity k=8"),
    ):
        prod = big_2d[name][label]  # mlups_2d.py's default policy, FP32FP32; K4 at the default k = 8
        kernels.append({
            "name": name, "route": "cuda", "source": "xlb_tpu_torch/csrc/collide_stream_2d.cu", "replaces": rep,
            "launches": counts_2d[cls][0], "max_abs_err": max(r["max_abs_err"] for r in big_2d[name].values()),
            "ms": prod["ms"], "plain_ms": prod["plain_ms"], "bound_ms": prod["bound_ms"], "bound_by": prod["bound_by"],
            "library_ms": None,
        })
    for name, rep, label, launches in (
        ("collide_only", "xlb_tpu/kernels/collide_only.py:103", "f32", counts_walled["LevelCollide"][0]),
        ("collide_then_stream_k6", "xlb_tpu/kernels/collide_then_stream.py:270", "f32 pair",
         counts_mres["CollideThenStream pair"][0]),
        ("collide_then_stream", "xlb_tpu/kernels/collide_then_stream.py:554", "f32 pair+coalesce",
         counts_mres["CollideThenStream"][0]),
    ):
        prod = big_mres[name][label]  # mlups_3d_multires.py's default policy, FP32FP32, at 96^3 / 194^3
        kernels.append({
            "name": name, "route": "cuda",
            "source": "xlb_tpu_torch/csrc/" + ("collide_only.cu" if name == "collide_only" else "collide_then_stream.cu"),
            "replaces": rep, "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in big_mres[name].values()),
            "ms": prod["ms"], "plain_ms": prod["plain_ms"], "bound_ms": prod["bound_ms"], "bound_by": prod["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a collide or a collide-then-stream
        })
    k0 = big_zoo["D3Q19 BGK"][f"cavity {N_MAIN}x{N_MAIN}x{N_MAIN} bf16-shifted"]["K0"]  # as K1's record: bf16-shifted
    kernels.append({
        "name": "collide_stream_blocked", "route": "cuda", "source": "xlb_tpu_torch/csrc/collide_stream_blocked.cuh",
        "replaces": "xlb_tpu/kernels/collide_stream.py:1032", "launches": counts_zoo["CollideStreamBlocked"],
        "max_abs_err": max(rec["K0"]["max_abs_err"] for pair in big_zoo.values() for rec in pair.values()),
        "ms": k0["ms"], "plain_ms": k0["plain_ms"], "bound_ms": k0["bound_ms"], "bound_by": k0["bound_by"],
        "library_ms": None,  # no single PyTorch call computes an LBM step
    })
    kernels += probe_records(probes, probe_counts, probe_plain_ms, n_cmp, probe_errs)
    check(len(kernels) == 13, f"the kernels line lists {len(kernels)} kernels, not K0-K12")
    for rec in kernels:  # the byte bound at the measured copy roofline, and the kernel's share of it
        if rec["bound_by"] == "bytes":
            rec["roofline_ms"] = rec["bound_ms"] * HBM_BYTES_PER_S / (roofline["GBps"] * 1e9)
            rec["roofline_share"] = rec["roofline_ms"] / rec["ms"]
    print("  kernel time against the measured copy roofline (" + f"{roofline['GBps']:.1f} GB/s): "
          + "; ".join(f"{r['name']} {r['ms']:.4f} ms, {r['roofline_share']:.3f}" for r in kernels if "roofline_share" in r))
    print(json.dumps({"card": smi, "mlups": {k: v[0] for k, v in perf.items()},
                      "ms_per_step": {k: v[1] for k, v in perf.items()}, "training": training,
                      "kernel_variants": big, "mlups_2d": {k: v[0] for k, v in perf_2d.items()},
                      "ms_per_step_2d": {k: v[1] for k, v in perf_2d.items()}, "kernel_variants_2d": big_2d,
                      "cylinder": cylinder, "multires": perf_mres, "multires_tiers": tiers_mres,
                      "multires_tier_err": parity_mres, "kernel_variants_mres": big_mres, "walled_multires": walled,
                      "kernel_variants_zoo": big_zoo, "mlups_zoo": perf_zoo, "zoo_tier_err": parity_zoo,
                      "channel": channel, "many_bcs": many_bcs, "zoo_adjoint": zoo_adjoint, "zoo_gradients": zoo_grads,
                      "probes": probes,
                      "copy_roofline": roofline}))
    print(f"[17] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
