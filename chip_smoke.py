#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (xlb_tpu_torch) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab LABEL [--quick]   # one tree's kernel times (ab_line)
    python3 chip_smoke.py --ptxas                # one tree's ptxas report: PTXAS {kernel: [registers,
                                                 # spill stores, spill loads, static smem]}
    python3 chip_smoke.py --k8 [--out PATH]      # K8's launches by scene (k8_launches), as JSON in PATH
    python3 chip_smoke.py --field                # phase [20] alone (field_path)
    python3 chip_smoke.py --probes               # phase [16] alone (the copy-bandwidth probes)

1. Device: requires CUDA; prints the card's name and power limit.
2. Builds the CUDA kernels from xlb_tpu_torch/csrc with nvcc (sm_90a) and
   prints the build time and the ptxas register/spill report.
3. Holds each kernel against its plain torch version on a seeded,
   perturbed 64x48x40 lid-driven cavity (non-cubic: tile edges and
   periodic wrap are exercised), again with a solid block (cell type 255,
   has_solids) in it, then at 256^3, where it also times kernel and plain
   version (CUDA events) beside the kernel's bound. Then a 64x48x40 cavity
   of 15 BCs (ten fullway wall pieces, three equilibrium lid pieces, two
   halfway blocks; the kernels take every BC's prescription by value in
   their launch parameters): K1, K2 and K0 against their plain versions,
   K0 == K1 and K2 == two K1 launches; K8 on it and on its 13 BCs without
   the blocks.
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
   0.02, windows of 50, 1 warm-up window, best of 2) for each pair under
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
   copy roofline. Then K10, K11 and Tensor.copy_ in alternating windows
   of 50 calls on the scripts' field, best of 5 each: each one's ms, its
   ratio to copy_, and the bulk kernel's resident blocks per SM and shared
   memory per block; the kernels line's K10 / K11 ms and library_ms come
   from these windows.
17. The open-boundary path (3D flows past a sphere; K1, K2 and K0 with the
   kExtOpen epilogues: outflow and its staging, 3D Zou-He / regularized,
   free-slip, do-nothing, the aux field of per-voxel prescriptions). K1,
   K2 (k = 2) and K0 against their plain versions at a ragged 100x52x44,
   f32 and bf16-shifted, on four BC sets of open_bcs: flow_past_sphere_3d.py's
   (parabolic regularized inlet through aux, outflow, halfway walls,
   halfway mesh sphere; D3Q19 BGK), rotating_sphere_3d.py's (equilibrium
   inlet, outflow, fullway walls, halfway sphere with a spatial wall
   velocity through aux; D3Q27 KBC), a D3Q19 scene of Zou-He velocity
   and spatial pressure faces, free-slip walls and a do-nothing piece,
   and xlb_tpu's two-outflow scene (outflows at +x and +y); K0 == K1 and
   K2 == two K1 launches bit for bit; and on each the adjoint K8 in its
   kExtOpen form (check_adjoint: against its plain version, D3Q27 KBC
   against float64 TORCH-tier autograd, a limit that must also fail a
   planted fault, the centred reads' cotangent dropped; two calls bit for
   bit). Then the torch forms of
   flow_past_sphere_3d.py (both inlets), windtunnel_3d.py and
   rotating_sphere_3d.py at their defaults on the CUDA tier against the
   TORCH tier on the card (velocity field rtol 1e-4; the Cd history 1e-3
   relative; the Magnus asymmetry's sign and the velocity field), 10 steps
   of stepper(...) (K1) against the TORCH tier, launch counts reset before
   and read after each CUDA run. Then the flow past a sphere at
   512x256x256 under FP32FP32 and FP32BF16: build_multi_step(200), one
   warm-up window, best of 2 (MLUPS), launch counts, physics checks, and
   K1, K2, K0 on its final state against the plain version and timed
   beside the bound (aux bytes of the inlet included) and its share of
   [16]'s measured copy roofline; [4]'s cavity MLUPS beside those PERF.md
   records for the cavity's kernels before the open-boundary forms.
18. The curved-wall path (HybridBC; K1, K2 and K0 with the kExtHybrid
   epilogues, K3 and K4 with the 2D aux form). K1, K2 (k = 2) and K0
   against their plain versions at a ragged 100x52x44, f32 and
   bf16-shifted, on the tunnels of hybrid_bcs past a mesh sphere: for
   D3Q19 BGK and D3Q27 KBC, each of the four methods, with wall distances
   and a static moving wall (fullway walls, equilibrium inlet), with t = 1/2
   and a spinning wall (per-voxel, through the aux field; free-slip walls,
   regularized inlet and outlet), and with distances and the spinning
   wall; K0 == K1 and K2 == two K1 launches bit for bit; K8 in its
   kExtHybrid form as in [17]. K3 and K4 (k = 2,
   8) on the Schafer-Turek scene at D = 20 (441x84: the parabolic inlet
   through aux, the pressure outlet, halfway walls, the hybrid cylinder
   with its circle distances) for each method, K4 == k K3 bit for bit;
   K3 and K4 (k = 8) timed at the scene's D = 60 shape beside the bound.
   Then the torch forms of cylinder_benchmark_schafer_turek.py (D = 60,
   ~428,500 steps) and sphere_drag_validation.py (D = 24, ~41,000 steps)
   at their defaults on the CUDA tier: Cd_max, Cl_max and St in the
   published intervals, the sphere's Cd in [1.00, 1.18], each beside
   xlb_tpu's value; CUDA against TORCH tier on the card: 10 steps of
   stepper(...) (K1) on the sphere tunnel, one shedding period of the
   Schafer-Turek force history (K3) and windtunnel_3d.py --object-bc
   hybrid's Cd history (1e-3 of the largest |value|); launch counts reset
   before and read after each CUDA run. Then the sphere-drag
   tunnel at D = 48 (576x288x288, 47.8 M voxels) under FP32FP32 and
   FP32BF16: the setup's seconds, build_multi_step(200), one warm-up
   window, best of 2 (MLUPS), and K1, K2, K0 on its final state against
   the plain version and timed beside the bound (the hybrid voxels' aux bytes
   included) and [16]'s measured copy roofline.
19. Gradients through the open boundaries and curved walls (K8's kExtOpen
   and kExtHybrid forms; its checks against the plain version ran on
   every scene of [17] and [18]): build_multi_step(4) gradients (K2
   forward, K1 replay and K8) against TORCH-tier autograd on a small flow
   past a sphere and a small open hybrid tunnel; then the training path
   of [6] (5 Adam iterations on omega through build_multi_step(8)) on the
   flow past a sphere at 512x256x256 under FP32FP32 and FP32BF16, on the
   sphere-drag tunnel at D = 48 under FP32BF16 (and FP32FP32 when it
   fits in the card's memory) and on windtunnel_3d.py --object-bc hybrid
   at its defaults (D3Q27 KBC): loss and omega per iteration, forward and
   backward ms per window, ms per step, peak device memory, launch counts
   reset before and read after each run (K8 once per step); K8 on each
   final state against its plain version (float64 TORCH-tier autograd
   on the KBC tunnel; at D = 48, where the plain version's graph over the
   whole tunnel does not fit beside it, over x-slabs with a halo), timed
   beside its bound and [16]'s measured copy roofline.
20. Thermal convection and Shan-Chen multiphase (K1's and K3's field
   modes, ade and extern_force): every instantiated form against its plain
   version, f32 and bf16, two launches bit for bit (field_cases: the 2D
   and 3D thermal scenes, Zou-He / regularized / do-nothing faces for
   ADE's kExtOpen form, the flow past a sphere and the open hybrid tunnel
   for the force's kExtOpen and kExtHybrid forms, D3Q27 KBC); the CUDA
   tier against the TORCH tier on the card over 10 coupled steps (2D and
   3D thermal, 2D and 3D Shan-Chen); rayleigh_benard_2d.py (with and
   without --obstacle) and multiphase_droplet_2d.py at their defaults on
   both tiers against xlb_tpu's numbers (RB_REFERENCE, DROPLET_REFERENCE);
   2D thermal convection at 4096x2048 (Ra 1e8) and 3D Rayleigh-Benard at
   512x512x128 (Ra 1e6) under FP32FP32 and FP32BF16 from a hydrostatic
   start, Shan-Chen phase separation at 256^3: one warm-up window of 100
   coupled steps, best of 3 (MLUPS, ms per step), launches (one of each
   mode per step, no plain call), physics checks, peak memory, each
   kernel on the final state against its plain version and timed beside
   its bound, the glue's share of a step.
21. Prints the seconds of the whole run, a JSON line of the card, MLUPS,
   training times and each kernel's per-dtype errors and times, then the
   kernels' JSON line (K0-K12; K0, K1 and K2 with an "open" entry for the
   open-boundary path; K0-K4 with a "hybrid" entry for the curved-wall
   path; K8 with both: the training runs of [19]; K1 and K3 with a "field"
   entry per mode), then the result line {"ok": true, "device": {...}}
   last.

Every phase prints its seconds. The TORCH tier's side of the CUDA-versus-
TORCH comparisons of the scripts in [17], [18] and [20] runs in a second
process while the kernels build (torch_tier_runs; it is bound by the
host's launches, and the card idles during the build); [2] waits for it.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available. It imports
nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

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


def cuda_ms(fn, reps, warmup=True):
    """Mean device time of fn() in ms over reps calls after one warm-up
    (none with ``warmup=False``: a plain version timed right after the
    call that its check made is warm already)."""
    import torch

    if warmup:
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
    """[3], more BCs than the 8 prescriptions an early layout held: K1, K2
    and K0 on the 15-BC cavity
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


def train_omega(run, f0, bc_mask, missing_mask, label, window):
    """TRAIN_ITERS Adam iterations (lr 0.05) on omega from OMEGA_START
    through the differentiable window ``run`` of ``window`` steps, fitting
    its output from ``f0`` (which requires grad) at OMEGA_TARGET with the
    loss mean((out - target)^2): checks that the adjoint kernel ran once per
    step in each backward, that f_0's and omega's gradients are finite, that
    the loss falls and omega approaches its target. Returns {loss, omega
    per iteration, best forward and backward ms of a window, ms per step
    forward + backward, peak device memory in GiB}."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint

    device = f0.device
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
        del out
        check(CollideStreamAdjoint.launches - adj0 == window, f"{label}: the adjoint kernel ran other than once per step")
        check(f0.grad is not None and f0.grad.dtype == f0.dtype and bool(torch.isfinite(f0.grad).all()),
              f"{label}: no finite f_0 gradient in f_0's dtype")
        check(bool(torch.isfinite(omega.grad)), f"{label}: non-finite omega gradient")
        opt.step()
        losses.append(loss.item())
        omegas.append(omega.item())
        fwd.append((t1 - t0) * 1e3)
        bwd.append((t2 - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = {"loss": losses, "omega": omegas, "forward_ms": min(fwd), "backward_ms": min(bwd),
           "ms_per_step": (min(fwd) + min(bwd)) / window, "peak_gib": peak}
    print(f"  {label}: loss {' -> '.join(f'{x:.4e}' for x in losses)}; "
          f"omega {' -> '.join(f'{x:.4f}' for x in omegas)}")
    print(f"  {label}: window of {window} forward {rec['forward_ms']:.3f} ms, backward "
          f"{rec['backward_ms']:.3f} ms, {rec['ms_per_step']:.4f} ms per step forward + backward "
          f"(best of {TRAIN_ITERS}); peak device memory {peak:.2f} GiB")
    check(all(np.isfinite(losses)), f"{label}: non-finite loss")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall")
    check(abs(omegas[-1] - OMEGA_TARGET) < abs(omegas[0] - OMEGA_TARGET), f"{label}: omega did not approach its target")
    del target
    return rec


def perturbed_start(f_0, seed):
    """A seeded 5% perturbation of f_0 in its dtype, requiring grad."""
    import torch

    gen = torch.Generator(device=f_0.device).manual_seed(seed)
    noise = torch.randn(f_0.shape, generator=gen, device=f_0.device)
    return (f_0.float() * (1.0 + 0.05 * noise)).to(f_0.dtype).requires_grad_(True)


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
        f0 = perturbed_start(f_0, 7)
        run = stepper.build_multi_step(TRAIN_WINDOW)
        records[policy.name] = train_omega(run, f0, bc_mask, missing_mask, policy.name, TRAIN_WINDOW)
        del stepper, f_0, f0, run, bc_mask, missing_mask
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
ZOO_WINDOW, ZOO_WARMUP, ZOO_REPS = 50, 1, 2
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
                            r["plain_ms"] = cuda_ms(lambda: kern.plain(f, mask, omega), 1, warmup=False)
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
    of 50, ZOO_WARMUP warm-up windows, best of ZOO_REPS, MLUPS = 256^3 x 50 / s / 1e6, host
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
                    rec["plain_ms"] = cuda_ms(lambda: adj.plain(f, g, mask, omega), 1, warmup=False)
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
PROBE_ROUNDS = 5  # [16]'s interleaved K10 / K11 / copy_ windows: best of 5 each


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


def probe_interleaved(device):
    """[16]: K10, K11 and ``Tensor.copy_`` on the scripts' (19, 256^3)
    field in alternating windows of 50 calls (common.interleaved_ms), best
    of PROBE_ROUNDS each; prints each one's ms and ratio to copy_ and the
    bulk kernel's launch shape. Returns {"K10", "K11", "copy_": ms,
    "blocks_per_sm", "smem_per_block"}."""
    import torch

    from xlb_tpu_torch.examples.performance.common import field, interleaved_ms, library_step
    from xlb_tpu_torch.kernels.copy_bandwidth import BulkCopy, SplitBulkCopy, bulk_shape

    x = field(256, 19, device)
    ms = interleaved_ms({"copy_": library_step("copy", x), "K10": BulkCopy(), "K11": SplitBulkCopy(19)}, x, 50,
                        PROBE_ROUNDS)
    per_sm, smem = bulk_shape(device)
    del x
    torch.cuda.empty_cache()
    print(f"  interleaved at (19, 256, 256, 256), best of {PROBE_ROUNDS} windows of 50: "
          + "; ".join(f"{k} {v:.4f} ms ({v / ms['copy_']:.4f} x copy_)" for k, v in ms.items())
          + f"; the bulk kernel: {per_sm} resident blocks per SM x {smem} B shared memory")
    return {**ms, "blocks_per_sm": per_sm, "smem_per_block": smem}


def probe_records(runs, counts, plain_ms, n_cmp, errs, inter):
    """The kernels-line entries of K9-K12: K9's and K12's best variant of the
    [16] runs, K10's and K11's time from the interleaved windows (``inter``,
    probe_interleaved), beside the plain version, the bound (the array read
    and written at the data-sheet rate) and the library call (copy_ for
    K9-K11, from the interleaved windows for K10 / K11; torch.mul(...,
    out=) for K12)."""
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
        ms, library_ms = rec["ms"], library["ms"]
        if kernel in ("K10", "K11"):
            variant, ms, library_ms = f"interleaved with copy_, best of {PROBE_ROUNDS}", inter[kernel], inter["copy_"]
        out.append({
            "name": name, "route": "cuda", "source": "xlb_tpu_torch/csrc/copy_bandwidth.cu", "replaces": rep,
            "launches": counts[cls][0], "max_abs_err": errs[kernel], "ms": ms, "plain_ms": plain_ms[plain],
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms, "variant": variant,
            "bit_equal_comparisons": n_cmp,
        })
    return out


# [17]: the open-boundary scenes -- (velocity set, collision) of each BC set of open_bcs
OPEN_SCENES = {"sphere": ("D3Q19", "BGK"), "rotating": ("D3Q27", "KBC"), "zouhe": ("D3Q19", "BGK"),
               "outflow2": ("D3Q19", "BGK")}
OPEN_U = 0.04


def open_bcs(kind, grid, bnd, geo):
    """The BCs of an open-boundary scene on ``grid``, from the BC classes
    and geometry of a package (its ``boundary`` and ``geometry`` modules),
    for the pair OPEN_SCENES[kind]:
    - "sphere": flow_past_sphere_3d.py's set -- the parabolic regularized
      inlet (a per-voxel velocity), the extrapolation outflow, halfway
      walls, a halfway mesh-voxelized sphere;
    - "rotating": rotating_sphere_3d.py's -- an equilibrium inlet, the
      outflow, fullway walls, a halfway sphere turning about z (a per-voxel
      wall velocity, profile(coords));
    - "zouhe": a Zou-He velocity inlet and a Zou-He pressure outlet whose
      density varies over the face (per voxel), free-slip walls on four
      sides, half of the top a do-nothing piece;
    - "outflow2": xlb_tpu's tests/kernels/test_fused_kernel.py scene of two
      outflow faces -- halfway walls at the bottom, top and front, an
      equilibrium inlet, extrapolation outflows at +x and +y (their staged
      reads reach across both faces' edge)."""
    nx, ny, nz = grid.shape
    box, box_ne = grid.bounding_box_indices(), grid.bounding_box_indices(remove_edges=True)
    center, radius = np.array([nx / 4, ny / 2, nz / 2]), ny / 8

    def faces(*names):
        return np.unique(np.concatenate([np.asarray(box[k]) for k in names], axis=1), axis=1).tolist()

    if kind == "sphere":
        yz = (np.arange(ny) + 0.5) / ny - 0.5
        ry, rz = np.meshgrid(2.0 * yz, 2.0 * (np.arange(nz) + 0.5) / nz - 1.0, indexing="ij")
        inlet = np.zeros((3, 1, ny, nz))
        inlet[0, 0] = OPEN_U * np.maximum(0.0, 1.0 - ry**2 - rz**2)
        return [bnd.HalfwayBounceBackBC(indices=faces("bottom", "top", "front", "back")),
                bnd.RegularizedBC("velocity", profile=lambda: inlet, indices=box_ne["left"]),
                bnd.ExtrapolationOutflowBC(indices=box_ne["right"]),
                bnd.HalfwayBounceBackBC(mesh_vertices=geo.sphere_triangles(center=center, radius=radius,
                                                                           subdivisions=3))]
    if kind == "outflow2":
        walls = faces("bottom", "top", "front")
        return [bnd.HalfwayBounceBackBC(indices=walls),
                bnd.EquilibriumBC(rho=1.0, u=(0.02, 0.01, 0.0), indices=box_ne["left"]),
                bnd.ExtrapolationOutflowBC(indices=box_ne["right"]),
                bnd.ExtrapolationOutflowBC(indices=box_ne["back"])]
    if kind == "rotating":
        sphere = geo.solid_voxel_indices(geo.voxelize(geo.sphere_triangles(center=center, radius=radius,
                                                                           subdivisions=3), grid.shape))

        def spin(coords):  # u_wall = Omega x (x - c), Omega = 0.005 e_z
            return np.cross(np.array([0.0, 0.0, 0.005])[None, :], (coords - center[:, None]).T).T

        return [bnd.FullwayBounceBackBC(indices=faces("bottom", "top", "front", "back")),
                bnd.EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["left"]),
                bnd.ExtrapolationOutflowBC(indices=box_ne["right"]),
                bnd.HalfwayBounceBackBC(indices=sphere.tolist(), profile=spin)]
    ys, zs = np.meshgrid(np.arange(ny), np.arange(nz), indexing="ij")
    rho_out = (1.0 + 0.002 * (ys / ny - 0.5) * (zs / nz))[None, None]  # (1, 1, ny, nz)
    xs, ys_in = np.meshgrid(np.arange(nx), np.arange(1, ny - 1), indexing="ij")
    bottom = np.stack([xs.ravel(), ys_in.ravel(), np.zeros(xs.size, int)])
    top = np.stack([xs.ravel(), ys_in.ravel(), np.full(xs.size, nz - 1)])
    lid = top[0] >= nx // 2
    return [bnd.FreeSlipBC(indices=np.asarray(box["front"]).tolist(), normal=(0, -1, 0)),
            bnd.FreeSlipBC(indices=np.asarray(box["back"]).tolist(), normal=(0, 1, 0)),
            bnd.FreeSlipBC(indices=bottom.tolist(), normal=(0, 0, -1)),
            bnd.FreeSlipBC(indices=top[:, ~lid].tolist(), normal=(0, 0, 1)),
            bnd.DoNothingBC(indices=top[:, lid].tolist()),
            bnd.ZouHeBC("velocity", prescribed_value=(OPEN_U, 0.0, 0.0), indices=box_ne["left"]),
            bnd.ZouHeBC("pressure", profile=lambda: rho_out, indices=box_ne["right"])]


# [18]: the curved-wall (hybrid) scenes -- (velocity set, collision) of each tunnel of hybrid_bcs
HYBRID_PAIRS = (("D3Q19", "BGK"), ("D3Q27", "KBC"))
HYBRID_METHODS = ("bounceback", "bounceback_regularized", "bounceback_grads", "nonequilibrium_regularized")
HYBRID_U = 0.03


def hybrid_bcs(grid, bnd, geo, method, use_dist=True, wall=None, tunnel="closed"):
    """The BCs of a tunnel past a hybrid mesh sphere (radius ny / 5 at the
    centre) on ``grid``, from a package's BC classes and geometry:
    - tunnel "closed": xlb_tpu's tests/kernels/test_fused_hybrid.py set --
      fullway walls on the four sides and the back, an equilibrium inlet;
    - tunnel "open": sphere_drag_validation.py's -- free-slip sides, a
      regularized velocity inlet and pressure outlet.
    ``use_dist``: the wall distances from the mesh, or t = 1/2; ``wall``:
    None, "static" (a constant wall velocity) or "spin" (a per-voxel wall
    velocity, profile(coords): Omega x (x - c), Omega = 0.01 e_z)."""
    nx, ny, nz = grid.shape
    box, box_ne = grid.bounding_box_indices(), grid.bounding_box_indices(remove_edges=True)
    center = np.array([nx / 2, ny / 2, nz / 2])
    tris = geo.sphere_triangles(center=center, radius=ny / 5, subdivisions=2)

    def spin(coords):
        return np.cross(np.array([0.0, 0.0, 0.01])[None, :], (coords - center[:, None]).T).T

    kw = {"static": {"prescribed_value": (0.01, -0.005, 0.002)}, "spin": {"profile": spin}, None: {}}[wall]
    sphere = bnd.HybridBC(bc_method=method, mesh_vertices=tris, use_mesh_distance=use_dist, **kw)
    if tunnel == "closed":
        walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back", "right")],
                                         axis=1), axis=1)
        return [bnd.FullwayBounceBackBC(indices=walls.tolist()),
                bnd.EquilibriumBC(rho=1.0, u=(HYBRID_U, 0.0, 0.0), indices=box_ne["left"]), sphere]
    g = np.indices(grid.shape)
    return [bnd.FreeSlipBC(indices=g[:, :, 0, :].reshape(3, -1).tolist(), normal=(0, -1, 0)),
            bnd.FreeSlipBC(indices=g[:, :, ny - 1, :].reshape(3, -1).tolist(), normal=(0, 1, 0)),
            bnd.FreeSlipBC(indices=g[:, :, 1:ny - 1, 0].reshape(3, -1).tolist(), normal=(0, 0, -1)),
            bnd.FreeSlipBC(indices=g[:, :, 1:ny - 1, nz - 1].reshape(3, -1).tolist(), normal=(0, 0, 1)),
            bnd.RegularizedBC("velocity", prescribed_value=(HYBRID_U, 0.0, 0.0), indices=box_ne["left"]),
            bnd.RegularizedBC("pressure", prescribed_value=1.0, indices=box_ne["right"]), sphere]


OPEN_RAGGED = (100, 52, 44)
OPEN_OMEGA = 1.6
OPEN_BIG = (512, 256, 256)  # the flow past a sphere at 33.5 M voxels
OPEN_WINDOW, OPEN_REPS = 200, 2
OPEN_PARITY_STEPS = 10
# [4]'s cavity MLUPS as PERF.md records them before the open-boundary kernels (NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside this run's to show that the cavity's path did not move
CAVITY_RECORDED_MLUPS = {"FP32BF16": 18573.4, "FP32FP32": 15813.9}


def open_scene(kind, shape, policy, backend, device):
    """(stepper, prepare_fields()) of an open-boundary scene of open_bcs
    through the port's public API."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch import boundary, geometry
    from xlb_tpu_torch import velocity_set as vsets
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    vs_name, collision = OPEN_SCENES[kind]
    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=getattr(vsets, vs_name)(), default_backend=backend, default_precision_policy=policy)
    grid = xlb.grid_factory(shape, device=device)
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=open_bcs(kind, grid, boundary, geometry),
                                                collision_type=collision)
    return stepper, stepper.prepare_fields()


def open_kernels(stepper, store, shifted):
    """K1, K2 (k = 2) and K0 of an open-boundary scene, the aux field
    (a tuple: empty when no BC reads one) and the aux bytes the kernels
    read per step (the channels of each BC that reads them, at its voxels)."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream import kernel_collision_spec
    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_blocked import CollideStreamBlocked
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, build_aux_field

    vs, shape = stepper.velocity_set, stepper.grid.shape
    specs = [bc_to_spec(b, vs) for b in stepper.boundary_conditions]
    kw = dict(collision=kernel_collision_spec(stepper), bc_specs=specs, store_dtype=store, shifted=shifted,
              has_solids=stepper.has_solids)
    aux = build_aux_field(stepper)
    aux = () if aux is None else (torch.as_tensor(aux, device=stepper.grid.device),)
    return ((CollideStreamStep(vs, shape, **kw), CollideStreamKStep(vs, shape, steps=2, **kw),
             CollideStreamBlocked(vs, shape, **kw)), aux, specs)


def open_aux_bytes(specs, bc_mask, d):
    """Bytes of the aux field the kernels read in one step: at each voxel of
    a BC with a per-voxel prescription, its channels (d velocities, or the
    density)."""
    from xlb_tpu_torch.kernels.collide_stream import spec_uses_aux

    return sum(int((bc_mask == s["id"]).sum()) * (1 if s.get("value") == "aux_rho" else d) * 4
               for s in specs if spec_uses_aux(s))


def open_bound(vs, collision, f, mask, aux_bytes, shifted, steps=1):
    """(least ms, "bytes" or "operations") of ``steps`` open-scene steps:
    f and the mask read once, f written once, the aux bytes of the BCs that
    read it; the operations of the collision's body (zoo_flops; the
    epilogues at the BC voxels not counted)."""
    t_bytes = (2 * f.numel() * f.element_size() + mask.numel() * 4 + aux_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = steps * zoo_flops(vs, collision, shifted, False) * mask.numel() / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# K8 against its plain version, as [5]: df and dom_field
ADJ_DF_TOL, ADJ_DOM_TOL = dict(rtol=1e-4, atol=1e-6), dict(rtol=1e-4, atol=1e-7)


def torch_tier_vjp64(scene64, f, g, omega, shifted):
    """(df, dom_field) of float64 autograd through the TORCH tier's step of
    ``scene64`` = (FP64FP64 stepper, its fields) with a per-voxel omega
    field, at the store-form state ``f`` (plus the kernels' float32 weights
    when ``shifted``) with the cotangent ``g``."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream import f32_weights

    stepper, (_, _, bc_mask, missing_mask) = scene64
    fp = f.double()
    if shifted:
        fp = fp + torch.tensor(f32_weights(stepper.velocity_set), dtype=torch.float64, device=f.device).reshape(
            (-1,) + (1,) * (f.ndim - 1))
    om = torch.full(tuple(f.shape[1:]), float(omega), dtype=torch.float64, device=f.device)
    _, vjp = torch.func.vjp(lambda x, o: stepper._step_pull(x, x, bc_mask, missing_mask, o, 0)[1], fp, om)
    return vjp(g.double())


def k8_held(df, dom, pdf, pdom, ref64=None):
    """K8's (df, dom_field) against its plain version's (pdf, pdom)
    (ADJ_DF_TOL, ADJ_DOM_TOL) or, given ``ref64`` (float64 TORCH-tier
    autograd's), against that, no farther from it than twice the plain
    version plus the same atol. Returns (max |err|, largest tolerance
    share, the readings: the plain version's distance p1 / p2 from float64
    and the largest and the mean |df| / |dom_field| of the reference)."""
    if ref64 is None:
        e1, s1 = tolerance_share(df, pdf, **ADJ_DF_TOL)
        e2, s2 = tolerance_share(dom, pdom, **ADJ_DOM_TOL)
        return max(e1, e2), max(s1, s2), {}
    rdf, rdom = ref64
    e1, p1 = float((df.double() - rdf).abs().max()), float((pdf.double() - rdf).abs().max())
    e2, p2 = float((dom.double() - rdom).abs().max()), float((pdom.double() - rdom).abs().max())
    s1, s2 = e1 / (2 * p1 + ADJ_DF_TOL["atol"]), e2 / (2 * p2 + ADJ_DOM_TOL["atol"])
    readings = {"plain_df": p1, "plain_dom": p2, "df_max": float(rdf.abs().max()), "df_mean": float(rdf.abs().mean()),
                "dom_max": float(rdom.abs().max()), "dom_mean": float(rdom.abs().mean())}
    return max(e1, e2), max(s1, s2), readings


def k8_without(launch, adj, f, g, mask, omega, aux):
    """A planted fault for K8's limits: its plain version with the terms of
    one launch dropped, as a K8 that skipped that launch would drop them.
    ``launch`` "centred" (adjoint_centred_kernel): the epilogues' centred
    reads held constant outside the solid voxels; "boundary" (the split
    forms' boundary launch): the pulled populations and omega held constant
    at the voxels of an epilogue BC (``boundary_voxels``), so that their
    pushes and dom_field are 0. Returns (df, dom_field)."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream import bc_id_shift, pointwise_core

    vs, fc = adj.vs, f.detach().float()
    held = fc.clone()
    om = torch.full(tuple(mask.shape), float(np.float32(omega)), dtype=torch.float32, device=f.device)
    dims = tuple(range(vs.d))
    if launch == "centred":
        solid = (mask >> bc_id_shift(vs.q)) & (31 if vs.q == 27 else 0xFF) == (31 if vs.q == 27 else 255)
        bvox = torch.zeros_like(solid)
    else:
        solid, bvox = torch.ones(tuple(mask.shape), dtype=torch.bool, device=f.device), adj.boundary_voxels(mask)

    def step(x, o):
        def pulled(l, t):
            return torch.roll(x[l], shifts=tuple(int(c) for c in t), dims=dims)

        fs = [torch.where(bvox, torch.roll(held[l], shifts=tuple(int(c) for c in vs._c[:, l]), dims=dims),
                          pulled(l, vs._c[:, l])) for l in range(vs.q)]
        return torch.stack(pointwise_core(vs, adj.bc_specs, fs, lambda l: torch.where(solid, x[l], held[l]), mask,
                                          torch.where(bvox, om, o), adj.shifted, adj.has_solids, adj.collision,
                                          adj.force_vector, aux, pulled))

    _, vjp = torch.func.vjp(step, fc, om)
    return vjp(g)


def check_adjoint(stepper, f, mask, omega, aux, store, shifted, label, scene64=None, force_vector=None):
    """K8 in the scene's kExtOpen or kExtHybrid form (with ``force_vector``,
    a body force: its forced bulk) on the store-form state ``f`` with a
    seeded cotangent g = w N(0, 1), aux field included: against its plain
    version or, for D3Q27 KBC (``scene64``: its FP64FP64 TORCH-tier scene),
    against float64 TORCH-tier autograd (k8_held) -- KBC's float32 gradient
    is ill-conditioned, so the float32 plain version is no sharper a
    reference. The limit must fail a planted fault: K8 without its boundary
    launch (k8_without), and for KBC also without its centred one. Two
    calls, both split by voxel class (``split_launches``), must agree bit
    for bit. Returns (max |err|, largest tolerance share)."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream import kernel_collision_spec
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec

    vs = stepper.velocity_set
    adj = CollideStreamAdjoint(vs, tuple(mask.shape), collision=kernel_collision_spec(stepper), store_dtype=store,
                               bc_specs=[bc_to_spec(b, vs) for b in stepper.boundary_conditions], shifted=shifted,
                               has_solids=stepper.has_solids, force_vector=force_vector)
    check(adj.split, f"{label}: K8 did not select the kExtOpen / kExtHybrid form")
    gen = torch.Generator(device=f.device).manual_seed(20)
    w = torch.as_tensor(vs._w, dtype=torch.float32, device=f.device).reshape(-1, 1, 1, 1)
    g = (w * torch.randn(f.shape, generator=gen, device=f.device)).contiguous()
    split = CollideStreamAdjoint.split_launches
    df, dom = adj(f, g, mask, omega, *aux)
    df2, dom2 = adj(f, g, mask, omega, *aux)
    check(CollideStreamAdjoint.split_launches == split + 2, f"{label}: K8 did not run split by voxel class")
    same = torch.equal(df, df2) and torch.equal(dom, dom2)
    pdf, pdom = adj.plain(f, g, mask, omega, *aux)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(df).all() and torch.isfinite(dom).all()), f"{label}: non-finite K8 output")
    ref64 = None if scene64 is None else torch_tier_vjp64(scene64, f, g, omega, shifted)
    err, share, r = k8_held(df, dom, pdf, pdom, ref64)
    faults = {launch: k8_held(*k8_without(launch, adj, f, g, mask, omega, aux[0] if aux else None), pdf, pdom,
                              ref64)[1] for launch in (("boundary", "centred") if ref64 is not None else ("boundary",))}
    how = "vs plain"
    if ref64 is not None:
        how = (f"vs float64 (plain {r['plain_df']:.2e} / {r['plain_dom']:.2e}; |df| max {r['df_max']:.2e} mean "
               f"{r['df_mean']:.2e}, |dom| max {r['dom_max']:.2e} mean {r['dom_mean']:.2e})")
    print(f"    K8 {how}: max|err| {err:.2e} ({share:.3f} of tol); two calls bit-equal {same}; planted faults "
          + ", ".join(f"without the {k} launch {v:.1f} of tol" for k, v in faults.items()))
    for launch, fault in faults.items():
        check(fault > 1.0, f"{label}: the limit passes K8 without its {launch} launch")
    check(share <= 1.0, f"{label}: K8 disagrees with its reference")
    check(same, f"{label}: two K8 calls differ")
    return err, share


def compare_open(device):
    """[17]: K1, K2 (k = 2) and K0 against their plain versions on each
    open-boundary scene of OPEN_SCENES at the ragged OPEN_RAGGED (tile edges,
    and the periodic wrap at the open faces), f32 and bf16-shifted, from a
    seeded perturbed state (the scene's aux field passed to every call); K0
    == K1 and K2 == two K1 launches bit for bit; and K8 (check_adjoint).
    Returns {kernel: largest max |err|} and {kernel: largest tolerance
    share}."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.kernels.fused_step import pack_masks

    errs, shares = {"K1": 0.0, "K2": 0.0, "K0": 0.0, "K8": 0.0}, {"K1": 0.0, "K2": 0.0, "K0": 0.0, "K8": 0.0}
    for kind in OPEN_SCENES:
        stepper, (_, _, bc_mask, missing_mask) = open_scene(kind, OPEN_RAGGED, xlb.PrecisionPolicy.FP32FP32,
                                                            xlb.ComputeBackend.TORCH, device)
        scene64 = None
        if OPEN_SCENES[kind][1] == "KBC":
            scene64 = open_scene(kind, OPEN_RAGGED, xlb.PrecisionPolicy.FP64FP64, xlb.ComputeBackend.TORCH, device)
        vs = stepper.velocity_set
        mask = pack_masks(bc_mask, missing_mask)
        gen = torch.Generator(device=device).manual_seed(17)
        noise = torch.randn((vs.q,) + OPEN_RAGGED, generator=gen, device=device)
        w = torch.as_tensor(vs._w, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1)
        for store, shifted in ((torch.float32, False), (torch.bfloat16, True)):
            f = ((0.02 * w * noise) if shifted else (w * (1.0 + 0.05 * noise))).to(store).contiguous()
            (one, two, blocked), aux, _ = open_kernels(stepper, store, shifted)
            k1, k2, k0 = one(f, mask, OPEN_OMEGA, *aux), two(f, mask, OPEN_OMEGA, *aux), blocked(f, mask, OPEN_OMEGA, *aux)
            k11 = one(k1, mask, OPEN_OMEGA, *aux)
            p1 = one.plain(f, mask, OPEN_OMEGA, *aux)
            p2 = one.plain(p1, mask, OPEN_OMEGA, *aux)
            torch.cuda.synchronize()
            label = f"{kind} {'x'.join(map(str, OPEN_RAGGED))} {'f32' if store == torch.float32 else 'bf16-shifted'}"
            for t, what in ((k1, "K1"), (k2, "K2"), (k0, "K0")):
                check(bool(torch.isfinite(t.float()).all()), f"{label}: non-finite {what} output")
            found = {"K1": held(k1, p1, store), "K2": held(k2, p2, store), "K0": held(k0, p1, store)}
            same01, same2 = torch.equal(k0, k1), torch.equal(k2, k11)
            print(f"  {label}: " + ", ".join(f"{n} {e:.2e} ({sh:.3f} of tol)" for n, (e, sh) in found.items())
                  + f"; K0 == K1 {same01}, K2 == 2 K1 {same2}")
            check(max(sh for _, sh in found.values()) <= 1.0, f"{label}: a kernel disagrees with its plain version")
            check(same01 and same2, f"{label}: K0 differs from K1, or K2 from two K1 launches")
            del k1, k2, k0, k11, p1, p2
            found["K8"] = check_adjoint(stepper, f, mask, OPEN_OMEGA, aux, store, shifted, label, scene64)
            for n, (e, sh) in found.items():
                errs[n], shares[n] = max(errs[n], e), max(shares[n], sh)
            del f
        del stepper, scene64, bc_mask, missing_mask, mask, noise
        torch.cuda.empty_cache()
    return errs, shares


def open_tier_parity(stepper, fields, omega, label):
    """OPEN_PARITY_STEPS steps of stepper(...) (K1) against the TORCH tier
    on the card from the same state (rtol 1e-4). Returns max |err|."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    f_0, f_1, bc_mask, missing_mask = fields
    plain = IncompressibleNavierStokesStepper(stepper.grid, boundary_conditions=stepper.boundary_conditions,
                                              collision_type=stepper.collision_type,
                                              compute_backend=xlb.ComputeBackend.TORCH)
    a0, a1 = f_0.contiguous(), f_1.clone()
    b0, b1 = f_0.clone(), f_1.clone()
    for i in range(OPEN_PARITY_STEPS):
        a0, a1 = stepper(a0, a1, bc_mask, missing_mask, omega, i)
        a0, a1 = a1, a0
        b0, b1 = plain(b0, b1, bc_mask, missing_mask, omega, i)
        b0, b1 = b1, b0
    err, ok = within(a0, b0, rtol=1e-4, atol=1e-6)
    print(f"  {label}: {OPEN_PARITY_STEPS} steps of stepper(...), CUDA tier vs TORCH tier: max|err| {err:.3e} ok={ok}")
    check(ok, f"{label}: CUDA tier disagrees with the TORCH tier")
    return err


def open_scripts(device, torch_ref):
    """[17]: the torch forms of flow_past_sphere_3d.py (both inlets),
    windtunnel_3d.py and rotating_sphere_3d.py at their defaults, on the
    CUDA tier (build_multi_step windows: K2; stepper(...): K1) against the
    TORCH tier on the card (``torch_ref``: torch_tier_runs' record): the
    velocity field (rtol 1e-4, atol 1e-6), the drag history (1e-3
    relative), the Magnus asymmetry (the same sign) and the velocity field.
    Each CUDA run's launch counts are reset just before it and read just
    after. Returns (record, total launches)."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.examples.cfd import flow_past_sphere_3d, rotating_sphere_3d, windtunnel_3d

    totals = {name: 0 for name in zoo_counts(reset=True)}
    rec = {}

    def cuda_run(fn):
        zoo_counts(reset=True)
        out = fn()
        torch.cuda.synchronize()
        counts = zoo_counts()
        check(all(p == 0 for _, p in counts.values()), "a plain version ran on a script's CUDA-tier run")
        for k in totals:
            totals[k] += counts[k][0]
        return out, counts

    for inlet in ("parabolic", "uniform"):
        (u_c, counts) = cuda_run(lambda: flow_past_sphere_3d.run(inlet=inlet, backend="cuda", device=device))
        u_t = torch_ref[f"flow_past_sphere {inlet}"]
        err, ok = within(torch.from_numpy(u_c), torch.from_numpy(u_t), rtol=1e-4, atol=1e-6)
        nx, nyz = u_c.shape[1], u_c.shape[2]
        rec[f"flow_past_sphere {inlet}"] = {"max_u": float(np.abs(u_c).max()),
                                            "wake_ux": float(u_c[0, nx // 2, nyz // 2, nyz // 2]),
                                            "tier_err": err, "launches": counts}
        print(f"  flow_past_sphere_3d {inlet}: max|u| {np.abs(u_c).max():.5f}, wake u_x "
              f"{u_c[0, nx // 2, nyz // 2, nyz // 2]:.5f}; CUDA vs TORCH tier velocity max|err| {err:.3e} ok={ok}; "
              f"launches {counts}")
        check(bool(np.isfinite(u_c).all()) and ok, f"flow_past_sphere_3d {inlet}: non-finite, or the tiers disagree")
    # stepper(...) through K1 on the script's scene
    stepper, fields, omega = flow_past_sphere_3d.build(backend="cuda", device=device)
    (_, counts) = cuda_run(lambda: open_tier_parity(stepper, fields, omega, "flow_past_sphere_3d parabolic"))
    check(counts["CollideStreamStep"][0] == OPEN_PARITY_STEPS, "stepper(...) did not launch K1 once per step")
    del stepper, fields

    (cd_c, counts) = cuda_run(lambda: windtunnel_3d.run(backend="cuda", device=device))
    cd_t = torch_ref["windtunnel"]
    rel = float(np.max(np.abs(np.subtract(cd_c, cd_t)) / np.abs(cd_t)))
    rec["windtunnel"] = {"cd": cd_c, "cd_torch": cd_t, "cd_rel_err": rel, "launches": counts}
    print(f"  windtunnel_3d: Cd history {[round(c, 4) for c in cd_c]}, TORCH tier {[round(c, 4) for c in cd_t]}, "
          f"largest relative difference {rel:.3e}; launches {counts}")
    check(bool(np.all(np.isfinite(cd_c))) and rel <= 1e-3, "windtunnel_3d: the Cd histories of the tiers differ")

    ((asym_c, u_c), counts) = cuda_run(lambda: rotating_sphere_3d.run(backend="cuda", device=device,
                                                                       return_velocity=True))
    asym_t, u_t = torch_ref["rotating_sphere"]
    fluid = np.isfinite(u_t).all(axis=0) & np.isfinite(u_c).all(axis=0)
    err, ok = within(torch.from_numpy(u_c[:, fluid]), torch.from_numpy(u_t[:, fluid]), rtol=1e-4, atol=1e-6)
    rec["rotating_sphere"] = {"asymmetry": asym_c, "asymmetry_torch": asym_t, "tier_err": err, "launches": counts}
    print(f"  rotating_sphere_3d: Magnus asymmetry {asym_c:+.6f} (TORCH tier {asym_t:+.6f}); fluid velocity max|err| "
          f"{err:.3e} ok={ok}; launches {counts}")
    check(np.sign(asym_c) == np.sign(asym_t) and asym_c != 0.0 and ok, "rotating_sphere_3d: the tiers disagree")
    torch.cuda.empty_cache()
    for name in ("CollideStreamStep", "CollideStreamKStep"):
        check(totals[name] > 0, f"{name} was not launched on the open-boundary scripts")
    return rec, totals


def open_big(device):
    """[17]: the flow past a sphere at OPEN_BIG through the public API
    (flow_past_sphere_3d.build), FP32FP32 and FP32BF16: build_multi_step(
    OPEN_WINDOW), one warm-up window, best of OPEN_REPS (MLUPS), launch
    counts around the windows (no plain call); physics checks (finite, the
    inflow u_x at the inlet centre equals the profile, mean rho ~ 1); then
    K1, K2 and K0 on the final state in the window's store form against
    the plain version and timed (CUDA events) beside the bound (the aux
    bytes of the inlet voxels included). Returns {policy: record}."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.examples.cfd.flow_past_sphere_3d import build, inlet_profile, velocity
    from xlb_tpu_torch.examples.performance.mlups_2d import time_windows
    from xlb_tpu_torch.kernels.fused_step import pack_masks

    nx, nyz, _ = OPEN_BIG
    out = {}
    for policy in (xlb.PrecisionPolicy.FP32FP32, xlb.PrecisionPolicy.FP32BF16):
        t0 = time.perf_counter()
        stepper, fields, omega = build(nx=nx, nyz=nyz, backend="cuda", precision=policy.name, device=device)
        setup_s = time.perf_counter() - t0
        run = stepper.build_multi_step(OPEN_WINDOW)
        zoo_counts(reset=True)
        best, (f_0, f_1) = time_windows(run, fields, omega, 1, OPEN_REPS)
        counts = zoo_counts()
        check(counts["CollideStreamKStep"][0] == (1 + OPEN_REPS) * OPEN_WINDOW // 2,
              f"{policy.name}: {counts['CollideStreamKStep'][0]} K2 launches")
        check(all(p == 0 for _, p in counts.values()), f"{policy.name}: a plain version ran in the windows")
        mlups = float(np.prod(OPEN_BIG)) * OPEN_WINDOW / best / 1e6
        bc_mask, missing_mask = fields[2], fields[3]
        u = velocity(f_0)
        rho = f_0.float().sum(dim=0)
        fluid = bc_mask[0] == 0
        mean_rho = float(rho[fluid].mean())
        c = nyz // 2
        u_in, u_prof = float(u[0, 0, c, c]), float(inlet_profile(nyz, 0.04)[0, 0, c, c])
        print(f"  {'x'.join(map(str, OPEN_BIG))} {policy.name}: {mlups:.1f} MLUPS ({best / OPEN_WINDOW * 1e3:.4f} ms/step, "
              f"best of {OPEN_REPS} windows of {OPEN_WINDOW}; setup {setup_s:.1f} s); launches {counts}; inflow u_x at "
              f"the inlet centre {u_in:.6f} (profile {u_prof:.6f}), fluid mean rho {mean_rho:.6f}, max|u| "
              f"{np.abs(u).max():.5f}")
        check(bool(np.isfinite(u).all()), f"{policy.name}: non-finite velocity")
        check(abs(u_in - u_prof) <= 0.02 * u_prof, f"{policy.name}: the inflow at the inlet centre is off the profile")
        # the inlet adds mass until the flow reaches the outlet (u_in A t / V: 2.5% in the 800 steps at
        # 512x256x256): a bound on the start-up, not on steady state
        check(abs(mean_rho - 1.0) < 5e-2, f"{policy.name}: |mean rho - 1| >= 5e-2")
        del u, rho, f_1, fields, run
        torch.cuda.empty_cache()

        # the kernels at this shape, on the final state in the window's store form
        shifted = policy == xlb.PrecisionPolicy.FP32BF16
        store = torch.bfloat16 if shifted else torch.float32
        vs = stepper.velocity_set
        w = torch.as_tensor(vs._w, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1)
        f = ((f_0.float() - w) if shifted else f_0.float()).to(store).contiguous()
        del f_0
        mask = pack_masks(bc_mask, missing_mask)
        (one, two, blocked), aux, specs = open_kernels(stepper, store, shifted)
        aux_bytes = open_aux_bytes(specs, bc_mask, vs.d)
        rec = {"mlups": mlups, "ms_per_step": best / OPEN_WINDOW * 1e3, "launches": counts, "mean_rho": mean_rho,
               "inflow_ux": u_in, "aux_bytes": aux_bytes}
        with torch.no_grad():
            p1 = one.plain(f, mask, omega, *aux)
            k1 = one(f, mask, omega, *aux)
            e1, s1 = held(k1, p1, store)
            e0, s0 = held(blocked(f, mask, omega, *aux), p1, store)
            del k1
            p2 = one.plain(p1, mask, omega, *aux)
            del p1
            e2, s2 = held(two(f, mask, omega, *aux), p2, store)
            del p2
            torch.cuda.empty_cache()
            check(max(s1, s2, s0) <= 1.0, f"{policy.name}: a kernel disagrees with its plain version at {OPEN_BIG}")
            for name, kern, steps, e in (("K1", one, 1, e1), ("K2", two, 2, e2), ("K0", blocked, 1, e0)):
                r = {"max_abs_err": e, "ms": cuda_ms(lambda: kern(f, mask, omega, *aux), 20),
                     "plain_ms": cuda_ms(lambda: kern.plain(f, mask, omega, *aux), 1, warmup=False)}
                r["bound_ms"], r["bound_by"] = open_bound(vs, "BGK", f, mask, steps * aux_bytes, shifted, steps)
                rec[name] = r
                torch.cuda.empty_cache()
        print("    " + "; ".join(f"{n} {rec[n]['ms']:.4f} ms (plain {rec[n]['plain_ms']:.2f}, bound {rec[n]['bound_ms']:.4f} "
                                  f"by {rec[n]['bound_by']}, max|err| {rec[n]['max_abs_err']:.2e})" for n in ("K1", "K2", "K0")))
        out[policy.name] = rec
        del stepper, f, mask, aux, bc_mask, missing_mask, one, two, blocked
        torch.cuda.empty_cache()
    return out


HYBRID_RAGGED = (100, 52, 44)
HYBRID_OMEGA = 1.6
# each pair of HYBRID_PAIRS and method of HYBRID_METHODS in these hybrid_bcs variants: (wall distances, wall, tunnel)
HYBRID_VARIANTS = ((True, "static", "closed"), (False, "spin", "open"), (True, "spin", "open"))
HYBRID_2D_D = 20  # the Schafer-Turek scene at D = 20: 441x84 (ragged against K4's 32x48 tile)
ST_REFERENCE = {"cd_max": 3.2253, "cl_max": 0.9964, "st": 0.2994}  # xlb_tpu's run() at the defaults (its docstring)
SPHERE_CD_REFERENCE = 1.155  # xlb_tpu's sphere_drag_validation.run() at D = 24 (its docstring)
ST_PARITY_PERIODS = 2
SPHERE_BIG_D = 48  # the sphere-drag tunnel at 576x288x288 (47.8 M voxels)
SPHERE_BIG_WINDOW, SPHERE_BIG_REPS = 200, 2


def hybrid_scene(pair, method, use_dist, wall, tunnel, shape, device, policy="FP32FP32"):
    """(stepper, prepare_fields()) of a hybrid_bcs tunnel on the TORCH tier."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch import boundary, geometry
    from xlb_tpu_torch import velocity_set as vsets
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    vs_name, collision = pair
    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=getattr(vsets, vs_name)(), default_backend=xlb.ComputeBackend.TORCH,
             default_precision_policy=xlb.PrecisionPolicy[policy])
    grid = xlb.grid_factory(shape, device=device)
    bcs = hybrid_bcs(grid, boundary, geometry, method, use_dist, wall, tunnel)
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type=collision)
    return stepper, stepper.prepare_fields()


def perturbed(vs, shape, store, shifted, seed, device):
    """A seeded perturbed state in store form (bf16 deviation form when
    shifted)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn((vs.q,) + tuple(shape), generator=gen, device=device)
    w = torch.as_tensor(vs._w, dtype=torch.float32, device=device).reshape((-1,) + (1,) * vs.d)
    return ((0.02 * w * noise) if shifted else (w * (1.0 + 0.05 * noise))).to(store).contiguous()


def compare_hybrid(device):
    """[18]: K1, K2 (k = 2) and K0 (kExtHybrid) against their plain versions
    on the hybrid_bcs tunnels at HYBRID_RAGGED for each pair, method and
    variant, f32 and bf16-shifted, K0 == K1 and K2 == two K1 launches bit
    for bit, and K8 (check_adjoint); then K3 and K4 (k = 2, 8; the kExtHybrid 2D form) on the
    Schafer-Turek scene at D = HYBRID_2D_D for each method, K4 == k K3 bit
    for bit. Returns ({kernel: largest max |err|}, {kernel: largest
    tolerance share}, comparisons)."""
    import torch

    from xlb_tpu_torch.examples.cfd.cylinder_benchmark_schafer_turek import build
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep, CollideStream2DStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, build_aux_field, pack_masks

    errs = {k: 0.0 for k in ("K1", "K2", "K0", "K3", "K4", "K8")}
    shares = dict(errs)
    n = 0

    def note(found):
        for k, (e, sh) in found.items():
            errs[k], shares[k] = max(errs[k], e), max(shares[k], sh)

    for pair in HYBRID_PAIRS:
        for method in HYBRID_METHODS:
            for use_dist, wall, tunnel in HYBRID_VARIANTS:
                stepper, (_, _, bc_mask, missing_mask) = hybrid_scene(pair, method, use_dist, wall, tunnel,
                                                                      HYBRID_RAGGED, device)
                scene64 = None
                if pair[1] == "KBC":
                    scene64 = hybrid_scene(pair, method, use_dist, wall, tunnel, HYBRID_RAGGED, device, "FP64FP64")
                vs = stepper.velocity_set
                mask = pack_masks(bc_mask, missing_mask)
                for store, shifted in ((torch.float32, False), (torch.bfloat16, True)):
                    f = perturbed(vs, HYBRID_RAGGED, store, shifted, 18, device)
                    (one, two, blocked), aux, _ = open_kernels(stepper, store, shifted)
                    check(one.params.walled == 3, "the hybrid scene did not select the kExtHybrid form")
                    om = HYBRID_OMEGA
                    k1, k2, k0 = one(f, mask, om, *aux), two(f, mask, om, *aux), blocked(f, mask, om, *aux)
                    k11 = one(k1, mask, om, *aux)
                    p1 = one.plain(f, mask, om, *aux)
                    p2 = one.plain(p1, mask, om, *aux)
                    torch.cuda.synchronize()
                    found = {"K1": held(k1, p1, store), "K2": held(k2, p2, store), "K0": held(k0, p1, store)}
                    same = torch.equal(k0, k1) and torch.equal(k2, k11)
                    label = (f"{pair[0]} {pair[1]} {method} {'dist' if use_dist else 'halfway t'} {wall} {tunnel} "
                             f"{'f32' if store == torch.float32 else 'bf16-shifted'}")
                    print(f"  {label}: " + ", ".join(f"{k} {e:.2e} ({sh:.3f} of tol)" for k, (e, sh) in found.items())
                          + f"; K0 == K1 and K2 == 2 K1 {same}")
                    check(all(bool(torch.isfinite(t.float()).all()) for t in (k1, k2, k0)), f"{label}: non-finite")
                    check(max(sh for _, sh in found.values()) <= 1.0, f"{label}: a kernel disagrees with its plain version")
                    check(same, f"{label}: K0 differs from K1, or K2 from two K1 launches")
                    del k1, k2, k0, k11, p1, p2
                    found["K8"] = check_adjoint(stepper, f, mask, om, aux, store, shifted, label, scene64)
                    note(found)
                    n += 1
                del stepper, scene64, bc_mask, missing_mask, mask
        torch.cuda.empty_cache()
    for method in HYBRID_METHODS:
        stepper, (_, _, bc_mask, missing_mask), omega, _ = build(d=HYBRID_2D_D, hybrid_method=method, backend="torch",
                                                                  device=device)
        vs, shape = stepper.velocity_set, tuple(stepper.grid.shape)
        mask = pack_masks(bc_mask, missing_mask)
        specs = [bc_to_spec(b, vs) for b in stepper.boundary_conditions]
        aux = torch.as_tensor(build_aux_field(stepper), device=device).contiguous()
        for store, shifted in ((torch.float32, False), (torch.bfloat16, True)):
            f = perturbed(vs, shape, store, shifted, 19, device)
            kw = dict(bc_specs=specs, store_dtype=store, shifted=shifted, has_solids=stepper.has_solids)
            one = CollideStream2DStep(vs, shape, **kw)
            check(one.ext == 4, "the Schafer-Turek scene did not select the 2D kExtHybrid form")
            k3 = one(f, mask, omega, aux)
            found = {"K3": held(k3, one.plain(f, mask, omega, aux), store)}
            same = True
            for k in (2, 8):
                kstep = CollideStream2DKStep(vs, shape, steps=k, **kw)
                g = f
                for _ in range(k):
                    g = one(g, mask, omega, aux)
                k4 = kstep(f, mask, omega, aux)
                found[f"K4 k={k}"] = held(k4, kstep.plain(f, mask, omega, aux), store)
                same = same and torch.equal(k4, g)
            torch.cuda.synchronize()
            label = f"Schafer-Turek {'x'.join(map(str, shape))} {method} {'f32' if store == torch.float32 else 'bf16-shifted'}"
            print(f"  {label}: " + ", ".join(f"{k} {e:.2e} ({sh:.3f} of tol)" for k, (e, sh) in found.items())
                  + f"; K4 == k K3 {same}")
            check(max(sh for _, sh in found.values()) <= 1.0, f"{label}: a kernel disagrees with its plain version")
            check(same, f"{label}: K4 differs from k K3 launches")
            note({"K3": found["K3"], "K4": max(found["K4 k=2"], found["K4 k=8"], key=lambda x: x[1])})
            n += 1
    return errs, shares, n


def counts_2d(reset=False):
    """{kernel class name: (launches, plain calls)} of K3 and K4."""
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep, CollideStream2DStep

    kernels = (CollideStream2DStep, CollideStream2DKStep)
    if reset:
        for k in kernels:
            k.launches = k.plain_calls = 0
    return {k.__name__: (k.launches, k.plain_calls) for k in kernels}


def hybrid_scripts(device, smi, torch_ref):
    """[18]: the torch forms of cylinder_benchmark_schafer_turek.py and
    sphere_drag_validation.py at their defaults on the CUDA tier (launch
    counts reset just before and read just after each), their results
    against the published intervals; then CUDA against TORCH tier on the
    card: OPEN_PARITY_STEPS steps of stepper(...) (K1) on the sphere-drag
    tunnel (rtol 1e-4), the Schafer-Turek Cd / Cl history over
    ST_PARITY_PERIODS shedding periods from build()'s state, and
    windtunnel_3d.py --object-bc hybrid's Cd history (each within 1e-3 of
    the largest |value|; the TORCH tier's histories from ``torch_ref``,
    torch_tier_runs' record). Returns (record, {kernel: launches of the
    scripts' CUDA runs})."""
    import torch

    from xlb_tpu_torch.examples.cfd import cylinder_benchmark_schafer_turek as st
    from xlb_tpu_torch.examples.cfd import sphere_drag_validation as sd
    from xlb_tpu_torch.examples.cfd import windtunnel_3d

    rec, launches = {}, {}

    def counted(fn, counter):
        counter(reset=True)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = counter()
        check(all(p == 0 for _, p in counts.values()), "a plain version ran on a script's CUDA-tier run")
        for k, (n, _) in counts.items():
            launches[k] = launches.get(k, 0) + n
        return out, counts, seconds

    (cd_max, cl_max, strouhal), counts, seconds = counted(lambda: st.run(backend="cuda", device=device), counts_2d)
    gaps = {"cd_max": cd_max - ST_REFERENCE["cd_max"], "cl_max": cl_max - ST_REFERENCE["cl_max"],
            "st": strouhal - ST_REFERENCE["st"]}
    inside = all(lo <= v <= hi for v, (lo, hi) in zip((cd_max, cl_max, strouhal), st.INTERVALS.values()))
    rec["schafer_turek"] = {"cd_max": cd_max, "cl_max": cl_max, "st": strouhal, "gap_to_xlb_tpu": gaps,
                            "launches": counts, "seconds": seconds, "in_intervals": inside}
    print(f"  Schafer-Turek at its defaults (D=60, 1321x248, U 0.035, hybrid bounceback), CUDA tier, {smi}: Cd_max "
          f"{cd_max:.4f} (xlb_tpu {ST_REFERENCE['cd_max']}, {gaps['cd_max']:+.4f}), Cl_max {cl_max:.4f} "
          f"({ST_REFERENCE['cl_max']}, {gaps['cl_max']:+.4f}), St {strouhal:.4f} ({ST_REFERENCE['st']}, "
          f"{gaps['st']:+.4f}); published intervals {st.INTERVALS}: {'inside' if inside else 'OUTSIDE'}; "
          f"{seconds:.1f} s; launches {counts}")
    check(counts["CollideStream2DKStep"][0] > 0 and counts["CollideStream2DStep"][0] > 0,
          "the Schafer-Turek run did not launch K3 and K4")
    check(inside, "Schafer-Turek: Cd_max, Cl_max or St outside the published intervals")

    cd, counts, seconds = counted(lambda: sd.run(backend="cuda", device=device), zoo_counts)
    lo, hi = sd.CD_BAND
    rec["sphere_drag"] = {"cd": cd, "launches": counts, "seconds": seconds}
    print(f"  sphere drag at its defaults (D=24, 288x144x144, Re 100, hybrid bounceback), CUDA tier, {smi}: Cd {cd:.4f} "
          f"(band [{lo}, {hi}], xlb_tpu {SPHERE_CD_REFERENCE}, published {sd.CD_PUBLISHED[100.0]}); {seconds:.1f} s; "
          f"launches {counts}")
    check(counts["CollideStreamKStep"][0] > 0, "the sphere drag run did not launch K2")
    check(lo <= cd <= hi, f"sphere drag: Cd {cd:.4f} outside [{lo}, {hi}]")
    # stepper(...) through K1 on the script's tunnel, against the TORCH tier
    stepper, fields, omega, _ = sd.build(backend="cuda", device=device)
    err, counts, _ = counted(lambda: open_tier_parity(stepper, fields, omega, "sphere drag D=24"), zoo_counts)
    check(counts["CollideStreamStep"][0] == OPEN_PARITY_STEPS, "stepper(...) did not launch K1 once per step")
    rec["sphere_drag"]["tier_err"] = err
    del stepper, fields

    # CUDA against TORCH tier: the force history over ST_PARITY_PERIODS shedding periods from the same state
    n = ST_PARITY_PERIODS * st.period_steps(60, 0.035)
    hist = {"torch": torch_ref["schafer_turek history"]}
    hist["cuda"], counts, _ = counted(lambda: schafer_turek_history("cuda", device), counts_2d)
    check(counts["CollideStream2DStep"][0] == n, "stepper(...) did not launch K3 once per step")
    coef = 2.0 / (0.035**2 * 60)
    rel = [float(np.abs(hist["cuda"][:, a] - hist["torch"][:, a]).max() / np.abs(hist["torch"][:, a]).max())
           for a in range(2)]
    rec["schafer_turek_tiers"] = {"steps": n, "cd_rel_err": rel[0], "cl_rel_err": rel[1],
                                  "cd_last": coef * float(hist["cuda"][-1, 0]), "cl_last": coef * float(hist["cuda"][-1, 1])}
    print(f"  Schafer-Turek Cd / Cl over {n} steps ({ST_PARITY_PERIODS} periods), CUDA vs TORCH tier: largest "
          f"difference {rel[0]:.3e} / {rel[1]:.3e} of the largest |Cd| / |Cl| (Cd, Cl at the end "
          f"{rec['schafer_turek_tiers']['cd_last']:.4f}, {rec['schafer_turek_tiers']['cl_last']:.4f})")
    check(max(rel) <= 1e-3, "Schafer-Turek: the tiers' Cd / Cl histories differ")

    cd_c, counts, _ = counted(lambda: windtunnel_3d.run(object_bc="hybrid", backend="cuda", device=device), zoo_counts)
    cd_t = torch_ref["windtunnel hybrid"]
    rel = float(np.max(np.abs(np.subtract(cd_c, cd_t))) / np.max(np.abs(cd_t)))
    rec["windtunnel_hybrid"] = {"cd": cd_c, "cd_torch": cd_t, "cd_rel_err": rel, "launches": counts}
    print(f"  windtunnel_3d --object-bc hybrid: Cd history {[round(c, 4) for c in cd_c]}, TORCH tier "
          f"{[round(c, 4) for c in cd_t]}, largest difference {rel:.3e} of the largest |Cd|; launches {counts}")
    check(bool(np.all(np.isfinite(cd_c))) and rel <= 1e-3, "windtunnel_3d hybrid: the tiers' Cd histories differ")
    torch.cuda.empty_cache()
    return rec, launches


def schafer_turek_history(backend, device):
    """The Cd / Cl force history of ST_PARITY_PERIODS shedding periods of
    stepper(...) on ``backend``'s tier from the Schafer-Turek torch form's
    build() state (D = 60)."""
    from xlb_tpu_torch.examples.cfd import cylinder_benchmark_schafer_turek as st
    from xlb_tpu_torch.ops import MomentumTransfer

    stepper, fields, omega, bc_cyl = st.build(backend=backend, device=device)
    n = ST_PARITY_PERIODS * st.period_steps(60, 0.035)
    return st.force_history(stepper, fields, omega, MomentumTransfer(bc_cyl), n)[1]


def hybrid_2d_times(device):
    """[18]: K3 and K4 (k = 8) in their kExtHybrid form at the
    Schafer-Turek scene's shape (D=60, 1321x248) on its initial state,
    f32 and bf16-shifted: against the plain version and timed (CUDA
    events) beside the bound (the aux bytes of the inlet and the cylinder's
    voxels included). Returns {kernel: {label: record}}."""
    import torch

    from xlb_tpu_torch.examples.cfd.cylinder_benchmark_schafer_turek import build
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep, CollideStream2DStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, build_aux_field, pack_masks

    stepper, (f_0, _, bc_mask, missing_mask), omega, _ = build(backend="cuda", device=device)
    vs, shape = stepper.velocity_set, tuple(stepper.grid.shape)
    mask = pack_masks(bc_mask, missing_mask)
    specs = [bc_to_spec(b, vs) for b in stepper.boundary_conditions]
    aux = torch.as_tensor(build_aux_field(stepper), device=device).contiguous()
    aux_bytes = hybrid_aux_bytes(specs, bc_mask, vs)
    w = torch.as_tensor(vs._w, dtype=torch.float32, device=device).reshape(-1, 1, 1)
    out = {"K3": {}, "K4": {}}
    for store, shifted in ((torch.float32, False), (torch.bfloat16, True)):
        f = ((f_0.float() - w) if shifted else f_0.float()).to(store).contiguous()
        kw = dict(bc_specs=specs, store_dtype=store, shifted=shifted, has_solids=stepper.has_solids)
        label = "f32" if store == torch.float32 else "bf16-shifted"
        for name, kern, k in (("K3", CollideStream2DStep(vs, shape, **kw), 1),
                              ("K4", CollideStream2DKStep(vs, shape, steps=8, **kw), 8)):
            e, share = held(kern(f, mask, omega, aux), kern.plain(f, mask, omega, aux), store)
            check(share <= 1.0, f"Schafer-Turek {label}: {name} disagrees with its plain version")
            r = {"max_abs_err": e, "ms": cuda_ms(lambda: kern(f, mask, omega, aux), 50),
                 "plain_ms": cuda_ms(lambda: kern.plain(f, mask, omega, aux), 1, warmup=False)}
            t_bytes = (2 * f.numel() * f.element_size() + mask.numel() * 4 + aux_bytes) / HBM_BYTES_PER_S * 1e3
            t_ops = k * FLOPS_PER_VOXEL["collide_stream_2d_step"][int(shifted)] * mask.numel() / F32_FLOPS_PER_S * 1e3
            r["bound_ms"], r["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            out[name][label] = r
        print(f"  Schafer-Turek {'x'.join(map(str, shape))} {label}: " + "; ".join(
            f"{n} {out[n][label]['ms']:.4f} ms (plain {out[n][label]['plain_ms']:.3f}, bound {out[n][label]['bound_ms']:.4f} "
            f"by {out[n][label]['bound_by']}, max|err| {out[n][label]['max_abs_err']:.2e})" for n in ("K3", "K4")))
    return out


def hybrid_aux_bytes(specs, bc_mask, vs):
    """Bytes of the aux field the kernels read in one step: at each voxel of
    a BC that reads it, its channels (a hybrid BC's q weights and, with a
    per-voxel wall, d velocities; another BC's d velocities or density)."""
    from xlb_tpu_torch.kernels.collide_stream import spec_uses_aux

    total = 0
    for s in specs:
        if not spec_uses_aux(s):
            continue
        if s["kind"] == "hybrid":
            ch = (vs.q if s["use_dist"] else 0) + (vs.d if s["mw"] == "aux" else 0)
        else:
            ch = 1 if s.get("value") == "aux_rho" else vs.d
        total += int((bc_mask == s["id"]).sum()) * ch * 4
    return total


def hybrid_big(device):
    """[18]: the sphere-drag tunnel at D = SPHERE_BIG_D (576x288x288) through
    sphere_drag_validation.build under FP32FP32 and FP32BF16: the setup's
    seconds (WINDING voxelization, wall distances, masks, aux field),
    build_multi_step(SPHERE_BIG_WINDOW), one warm-up window, best of
    SPHERE_BIG_REPS (MLUPS), launch counts (no plain call), physics
    checks; then K1, K2 and K0 on the final state against the plain
    version and timed (CUDA events) beside the bound (the aux bytes of the
    hybrid voxels included). Returns {policy: record}."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.examples.cfd.sphere_drag_validation import build
    from xlb_tpu_torch.examples.performance.mlups_2d import time_windows
    from xlb_tpu_torch.kernels.fused_step import build_aux_field, pack_masks

    out = {}
    for policy in (xlb.PrecisionPolicy.FP32FP32, xlb.PrecisionPolicy.FP32BF16):
        timings = {}
        stepper, fields, omega, _ = build(d=SPHERE_BIG_D, backend="cuda", precision=policy.name, device=device,
                                          timings=timings)
        shape = tuple(stepper.grid.shape)
        t0 = time.perf_counter()
        build_aux_field(stepper)
        timings["aux"] = time.perf_counter() - t0
        run = stepper.build_multi_step(SPHERE_BIG_WINDOW)
        zoo_counts(reset=True)
        best, (f_0, f_1) = time_windows(run, fields, omega, 1, SPHERE_BIG_REPS)
        counts = zoo_counts()
        check(counts["CollideStreamKStep"][0] == (1 + SPHERE_BIG_REPS) * SPHERE_BIG_WINDOW // 2,
              f"{policy.name}: {counts['CollideStreamKStep'][0]} K2 launches")
        check(all(p == 0 for _, p in counts.values()), f"{policy.name}: a plain version ran in the windows")
        mlups = float(np.prod(shape)) * SPHERE_BIG_WINDOW / best / 1e6
        bc_mask, missing_mask = fields[2], fields[3]
        fl = f_0.float()
        rho = fl.sum(dim=0)
        fluid = bc_mask[0] == 0
        mean_rho = float(rho[fluid].mean())
        finite = bool(torch.isfinite(fl).all())
        del fl, rho, f_1, fields, run
        torch.cuda.empty_cache()
        print(f"  sphere-drag tunnel {'x'.join(map(str, shape))} {policy.name}: {mlups:.1f} MLUPS "
              f"({best / SPHERE_BIG_WINDOW * 1e3:.4f} ms/step, best of {SPHERE_BIG_REPS} windows of {SPHERE_BIG_WINDOW}); "
              f"setup s: " + ", ".join(f"{k} {v:.1f}" for k, v in timings.items())
              + f"; launches {counts}; fluid mean rho {mean_rho:.6f}, finite {finite}")
        check(finite and abs(mean_rho - 1.0) < 5e-2, f"{policy.name}: non-finite, or |mean rho - 1| >= 5e-2")

        shifted = policy == xlb.PrecisionPolicy.FP32BF16
        store = torch.bfloat16 if shifted else torch.float32
        vs = stepper.velocity_set
        w = torch.as_tensor(vs._w, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1)
        f = ((f_0.float() - w) if shifted else f_0.float()).to(store).contiguous()
        del f_0
        mask = pack_masks(bc_mask, missing_mask)
        (one, two, blocked), aux, specs = open_kernels(stepper, store, shifted)
        aux_bytes = hybrid_aux_bytes(specs, bc_mask, vs)
        rec = {"mlups": mlups, "ms_per_step": best / SPHERE_BIG_WINDOW * 1e3, "launches": counts, "mean_rho": mean_rho,
               "setup_s": timings, "aux_bytes": aux_bytes}
        with torch.no_grad():
            p1 = one.plain(f, mask, omega, *aux)
            e1, s1 = held(one(f, mask, omega, *aux), p1, store)
            e0, s0 = held(blocked(f, mask, omega, *aux), p1, store)
            p2 = one.plain(p1, mask, omega, *aux)
            del p1
            e2, s2 = held(two(f, mask, omega, *aux), p2, store)
            del p2
            torch.cuda.empty_cache()
            check(max(s1, s2, s0) <= 1.0, f"{policy.name}: a kernel disagrees with its plain version at {shape}")
            for name, kern, steps, e in (("K1", one, 1, e1), ("K2", two, 2, e2), ("K0", blocked, 1, e0)):
                r = {"max_abs_err": e, "ms": cuda_ms(lambda: kern(f, mask, omega, *aux), 10),
                     "plain_ms": cuda_ms(lambda: kern.plain(f, mask, omega, *aux), 1, warmup=False)}
                r["bound_ms"], r["bound_by"] = open_bound(vs, "BGK", f, mask, aux_bytes, shifted, steps)
                rec[name] = r
                torch.cuda.empty_cache()
        print("    " + "; ".join(f"{n} {rec[n]['ms']:.4f} ms (plain {rec[n]['plain_ms']:.2f}, bound {rec[n]['bound_ms']:.4f} "
                                  f"by {rec[n]['bound_by']}, max|err| {rec[n]['max_abs_err']:.2e})" for n in ("K1", "K2", "K0"))
              + f"; aux bytes per step {aux_bytes}")
        out[policy.name] = rec
        del stepper, f, mask, aux, bc_mask, missing_mask, one, two, blocked
        torch.cuda.empty_cache()
    return out


# [19]: gradients through the open boundaries and curved walls
GRAD_SMALL, GRAD_STEPS = (64, 32, 32), 4
TRAIN_OPEN_WINDOW = 8


def open_window_gradients(device):
    """[19]: gradients of sum(out^2) through build_multi_step(GRAD_STEPS) on
    the CUDA tier (K2 forward; K1 replay and K8, once per step) against
    TORCH-tier autograd on the card, FP32FP32, from a seeded 5%
    perturbation, at GRAD_SMALL: the flow past a sphere (open_bcs "sphere":
    the regularized inlet through aux, the outflow, halfway walls and
    sphere) and the open hybrid tunnel (bounceback_regularized with wall
    distances and a spinning wall, free-slip walls, regularized inlet and
    outlet). d f_0 rtol 2e-4, atol 1e-6; d omega rtol 2e-3 (xlb_tpu's
    tolerances for its window). Returns {scene: (d f_0 max |err|, d omega
    relative error)}."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.fused_step import build_fused_window

    out = {}
    for label, make in (
        ("sphere", lambda: open_scene("sphere", GRAD_SMALL, xlb.PrecisionPolicy.FP32FP32, xlb.ComputeBackend.TORCH,
                                      device)),
        ("hybrid", lambda: hybrid_scene(("D3Q19", "BGK"), "bounceback_regularized", True, "spin", "open", GRAD_SMALL,
                                        device)),
    ):
        stepper, (f_0, _, bc_mask, missing_mask) = make()
        grads = {}
        for tier, run in (("cuda", build_fused_window(stepper, GRAD_STEPS)),
                          ("torch", stepper.build_multi_step(GRAD_STEPS))):
            f = perturbed_start(f_0, 21)
            om = torch.tensor(ADJ_OMEGA, device=device, requires_grad=True)
            k8 = CollideStreamAdjoint.launches
            (run(f, f, bc_mask, missing_mask, om)[0].float() ** 2).sum().backward()
            check(CollideStreamAdjoint.launches - k8 == (GRAD_STEPS if tier == "cuda" else 0),
                  f"{label}: K8 did not run once per step")
            grads[tier] = (f.grad, float(om.grad))
        (df_c, dw_c), (df_t, dw_t) = grads["cuda"], grads["torch"]
        e1, ok1 = within(df_c, df_t, rtol=2e-4, atol=1e-6)
        e2 = abs(dw_c - dw_t) / abs(dw_t)
        print(f"  {label} {'x'.join(map(str, GRAD_SMALL))}, {GRAD_STEPS} FP32FP32 steps, CUDA tier vs TORCH tier "
              f"autograd: d f_0 max|err| {e1:.3e} ok={ok1}; d omega {dw_c:.6e} vs {dw_t:.6e} ({e2:.2e})")
        check(ok1 and e2 <= 2e-3, f"{label}: CUDA-tier window gradients disagree with TORCH-tier autograd")
        out[label] = (e1, e2)
        del stepper, f_0, f, grads, df_c, df_t
        torch.cuda.empty_cache()
    return out


def adjoint_plain_in_slabs(adj, f, g, mask, omega, aux, rows):
    """K8's plain version over x-slabs of ``rows`` rows, for a scene whose
    whole autograd graph does not fit in the card's memory: the step reads
    no farther than one voxel, so each slab is taken with two rows of halo
    on each side (periodic), the cotangent zeroed on the outermost row of
    each side (whose outputs wrap inside the slab), and the inner rows kept.
    Returns (df, dom_field), as the plain version's."""
    import torch

    X = f.shape[1]
    df, dom = torch.empty_like(g), torch.empty(tuple(mask.shape), dtype=torch.float32, device=g.device)
    for x0 in range(0, X, rows):
        x1 = min(x0 + rows, X)
        idx = torch.arange(x0 - 2, x1 + 2, device=f.device) % X
        gs = g[:, idx].contiguous()
        gs[:, 0] = 0.0
        gs[:, -1] = 0.0
        pdf, pdom = adj.plain(f[:, idx].contiguous(), gs, mask[idx].contiguous(), omega,
                              *(() if aux is None else (aux[:, idx].contiguous(),)))
        df[:, x0:x1], dom[x0:x1] = pdf[:, 2:-2], pdom[2:-2]
        del gs, pdf, pdom
    return df, dom


def adjoint_timing(stepper, bc_mask, missing_mask, f, omega, shifted, label, scene64=None):
    """K8 (and its plain version) on the store-form state ``f`` of a scene
    with a seeded cotangent: K8 held to its plain version on these inputs
    (k8_held; ``scene64``, the FP64FP64 TORCH-tier scene of a D3Q27 KBC
    one: against float64 autograd) and timed (CUDA events) beside its
    bound: f, g and the mask read once, df and dom written once, the aux
    bytes of the BCs that read them (hybrid_aux_bytes); the operations of
    the hand-derived BGK transpose (FLOPS_PER_VOXEL, the epilogues' passes
    at BC voxels not counted), and the share of voxels the boundary
    launch transposes beside it (each launch's ms: --k8). Where the plain
    version's autograd graph over the whole scene does not fit in the
    card's memory beside the scene, it is taken in slabs
    (adjoint_plain_in_slabs), and its time is that of the slabs, as the
    record says. Returns a record."""
    import torch

    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream import kernel_collision_spec
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, build_aux_field, pack_masks

    vs = stepper.velocity_set
    mask = pack_masks(bc_mask, missing_mask)
    specs = [bc_to_spec(b, vs) for b in stepper.boundary_conditions]
    adj = CollideStreamAdjoint(vs, tuple(mask.shape), collision=kernel_collision_spec(stepper), bc_specs=specs,
                               store_dtype=f.dtype, shifted=shifted, has_solids=stepper.has_solids)
    aux = build_aux_field(stepper)
    aux = () if aux is None else (torch.as_tensor(aux, device=f.device),)
    gen = torch.Generator(device=f.device).manual_seed(23)
    w = torch.as_tensor(vs._w, dtype=torch.float32, device=f.device).reshape(-1, 1, 1, 1)
    g = (w * torch.randn(f.shape, generator=gen, device=f.device)).contiguous()
    aux_bytes = hybrid_aux_bytes(specs, bc_mask, vs)
    rec = {"ms": cuda_ms(lambda: adj(f, g, mask, omega, *aux), 10), "aux_bytes": aux_bytes,
           "boundary_share": adj.boundary_share(mask)}
    rec["bound_ms"], rec["bound_by"] = k8_bound(f, g, mask, aux_bytes, shifted)
    df, dom = adj(f, g, mask, omega, *aux)
    check(bool(torch.isfinite(df).all() and torch.isfinite(dom).all()), f"{label}: non-finite K8 output")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pdf = pdom = None
    try:  # its outputs for the check, timed
        start.record()
        pdf, pdom = adj.plain(f, g, mask, omega, *aux)
        end.record()
        torch.cuda.synchronize()
        plain = "plain"
    except torch.cuda.OutOfMemoryError:
        pass  # the failed graph is freed once the handler has ended
    if pdf is None:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # the slabs' peak, not the failed whole graph's
        rows = 64
        rec["plain_slabs"] = f"out of device memory over the whole scene: in x-slabs of {rows} rows"
        start.record()
        pdf, pdom = adjoint_plain_in_slabs(adj, f, g, mask, omega, aux[0] if aux else None, rows)
        end.record()
        torch.cuda.synchronize()
        plain = f"plain (out of memory whole) in x-slabs of {rows} rows"
    rec["plain_ms"] = start.elapsed_time(end)
    plain += f" {rec['plain_ms']:.2f} ms"
    plain += f", peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB"
    ref64 = None if scene64 is None else torch_tier_vjp64(scene64, f, g, omega, shifted)
    rec["max_abs_err"], rec["tolerance_share"], readings = k8_held(df, dom, pdf, pdom, ref64)
    rec.update(readings)
    del df, dom, pdf, pdom, ref64
    torch.cuda.empty_cache()
    print(f"    {label}: K8 {rec['ms']:.4f} ms per call ({plain}; bound {rec['bound_ms']:.4f} ms by "
          f"{rec['bound_by']}; aux bytes {aux_bytes}; boundary voxels {100 * rec['boundary_share']:.3f}%); "
          f"vs {'float64' if scene64 else 'plain'} max|err| "
          f"{rec['max_abs_err']:.2e} ({rec['tolerance_share']:.3f} of tol)"
          + (f"; plain {readings['plain_df']:.2e} / {readings['plain_dom']:.2e} from float64" if readings else ""))
    check(rec["tolerance_share"] <= 1.0, f"{label}: K8 disagrees with its reference on the final state")
    return rec


def train_open(device):
    """[19]: training through the open boundaries and curved walls on the
    CUDA tier, as [6] trains the cavity (train_omega: 5 Adam iterations on
    omega through build_multi_step(TRAIN_OPEN_WINDOW), K2 forward, K1
    replay and K8 once per step): the flow past a sphere at OPEN_BIG
    (flow_past_sphere_3d.build) under FP32FP32 and FP32BF16; the
    sphere-drag tunnel at D = SPHERE_BIG_D (sphere_drag_validation.build)
    under FP32BF16, and FP32FP32 when its fifteen float32 fields fit in
    the card's memory; windtunnel_3d.py --object-bc hybrid at its defaults
    (D3Q27 KBC, Tao's closure; K8 in forward mode). Launch counts reset
    before and read after each run (K8 once per step, no plain call); then
    K8 on the window's final state against its plain version (float64
    autograd on the KBC tunnel) and its bound (adjoint_timing).
    Returns {run: record}."""
    import torch

    from xlb_tpu_torch.examples.cfd import flow_past_sphere_3d, sphere_drag_validation, windtunnel_3d
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint

    nx, nyz, _ = OPEN_BIG
    d48 = (12 * SPHERE_BIG_D, 6 * SPHERE_BIG_D, 6 * SPHERE_BIG_D)
    free, total = torch.cuda.mem_get_info()
    runs = [(f"sphere {'x'.join(map(str, OPEN_BIG))} {p}", p,
             lambda p=p: flow_past_sphere_3d.build(nx=nx, nyz=nyz, backend="cuda", precision=p, device=device)[:2])
            for p in ("FP32FP32", "FP32BF16")]
    runs += [(f"sphere-drag D={SPHERE_BIG_D} {p}", p,
              lambda p=p: sphere_drag_validation.build(d=SPHERE_BIG_D, backend="cuda", precision=p, device=device)[:2])
             for p in ("FP32BF16", "FP32FP32") if p == "FP32BF16" or 15 * 19 * 4 * np.prod(d48) < 0.9 * total]
    runs.append(("windtunnel --object-bc hybrid FP32FP32", "FP32FP32",
                 lambda: windtunnel_3d.build(object_bc="hybrid", backend="cuda", device=device)[:2]))
    # D3Q27 KBC's K8 is held to float64 TORCH-tier autograd (check_adjoint)
    scenes64 = {runs[-1][0]: lambda: windtunnel_3d.build(object_bc="hybrid", backend="torch", precision="FP64FP64",
                                                         device=device)[:2]}
    out = {}
    for label, policy, make in runs:
        t0 = time.perf_counter()
        stepper, fields = make()
        setup_s = time.perf_counter() - t0
        f_0, _, bc_mask, missing_mask = fields
        f0 = perturbed_start(f_0, 22)
        del f_0, fields
        run = stepper.build_multi_step(TRAIN_OPEN_WINDOW)
        zoo_counts(reset=True)
        CollideStreamAdjoint.launches = CollideStreamAdjoint.plain_calls = 0
        rec = train_omega(run, f0, bc_mask, missing_mask, label, TRAIN_OPEN_WINDOW)
        counts = dict(zoo_counts(), CollideStreamAdjoint=(CollideStreamAdjoint.launches, CollideStreamAdjoint.plain_calls))
        print(f"  {label}: setup {setup_s:.1f} s; launches (launches, plain calls) {counts}")
        check(counts["CollideStreamAdjoint"] == (TRAIN_ITERS * TRAIN_OPEN_WINDOW, 0), f"{label}: K8 launches")
        check(counts["CollideStreamKStep"][0] > 0 and counts["CollideStreamStep"][0] > 0
              and all(p == 0 for _, p in counts.values()), f"{label}: the window did not run through K2 and K1 alone")
        rec.update(setup_s=setup_s, launches=counts, shape=list(stepper.grid.shape), policy=policy)
        shifted = policy == "FP32BF16"
        with torch.no_grad():
            f, _ = run(f0.detach(), f0.detach(), bc_mask, missing_mask, rec["omega"][-1])
            w = torch.as_tensor(stepper.velocity_set._w, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1)
            f = ((f.float() - w) if shifted else f.float()).to(torch.bfloat16 if shifted else torch.float32).contiguous()
        del f0, run
        torch.cuda.empty_cache()
        scene64 = scenes64[label]() if label in scenes64 else None
        rec["K8"] = adjoint_timing(stepper, bc_mask, missing_mask, f, rec["omega"][-1], shifted, label, scene64)
        del scene64
        out[label] = rec
        del stepper, f, bc_mask, missing_mask
        torch.cuda.empty_cache()
    return out


def k8_bound(f, g, mask, aux_bytes, shifted):
    """(least ms, "bytes" or "operations") of one K8 call: f, g and the mask
    read once, df and dom written once, the aux bytes of the BCs that read
    them; the operations of the hand-derived BGK transpose
    (FLOPS_PER_VOXEL, the epilogues' passes at BC voxels not counted)."""
    t_bytes = (f.numel() * f.element_size() + 2 * g.numel() * 4 + 2 * mask.numel() * 4 + aux_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_VOXEL["collide_stream_adjoint"][int(shifted)] * mask.numel() / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k8_launch_ms(call, reps=3):
    """{K8 launch (k8_launch_name): device ms per call} from one
    torch.profiler trace of ``reps`` calls of ``call``, as the mean of the
    launches the trace holds (a fresh trace may miss its first one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    launches = {}
    for e in prof.key_averages():
        name = k8_launch_name(e.key)
        if name is not None and e.device_time_total > 0:
            launches[name] = launches.get(name, 0.0) + e.device_time_total / 1e3 / e.count
    return launches


def k8_launch_name(key):
    """The K8 launch ("adjoint", "boundary", "centred", "staging") of a
    profiler key, or None: the boundary launch is adjoint_centred_kernel's
    phase with its seventh template argument true."""
    import re

    m = re.search(r"xlb::adjoint(_centred|_staging)?_kernel<([^>]*)>", key)
    if m is None:
        return None
    if m.group(1) == "_centred":
        args = m.group(2).split(", ")
        return "boundary" if len(args) == 7 and args[-1] == "true" else "centred"
    return "staging" if m.group(1) else "adjoint"


BENCH_SPHERE = "sphere_open_768x192x192"  # lbm_bench's training scene
K8_CONTROL_CALLS = 20


def bench_sphere(device, walled=False):
    """(stepper, bc_mask, missing_mask) of lbm_bench's flow past a sphere
    (configs/BENCH_SPHERE) through the port's public API, FP32FP32; with
    ``walled``, the control: the same grid and solid ball, and every BC
    voxel (the channel walls, the inlet and outlet faces, the sphere's
    halfway shell) fullway, so K8 runs its walled (kExtNone) form. The
    control's stepper keeps the open scene's BC list (its mask is remapped);
    k8_scene takes its BC specs from ``walled``."""
    import importlib.util

    root = Path(__file__).resolve().parent / "lbm_bench" / "configs"
    spec = importlib.util.spec_from_file_location("k8_bench_config", root / f"{BENCH_SPHERE}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = json.loads((root / f"{BENCH_SPHERE}.json").read_text())
    stepper, bc_mask, missing_mask = mod.program_scene(cfg, mod.boundaries(cfg), "FP32FP32", device, "TORCH")
    if walled:
        walls = stepper.boundary_conditions[0]
        for bc in stepper.boundary_conditions[1:]:
            bc_mask[bc_mask == bc.id] = walls.id
    return stepper, bc_mask, missing_mask


def k8_scene(label, stepper, bc_mask, missing_mask, walled_only=False):
    """One --k8 scene's record: K8 (f32, seeded state and cotangent) per call
    (cuda_ms), each launch's device ms from one torch.profiler trace of
    three calls (k8_launch_name), the bound (k8_bound), the share of voxels
    the boundary launch transposes, and the launch shapes (resident blocks
    per SM, registers, local bytes). ``walled_only``: the BC specs of the
    fullway walls alone (bench_sphere's control). Returns (record, the
    call: a function of no arguments)."""
    import torch

    from xlb_tpu_torch.kernels import _cuda
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream import kernel_collision_spec
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, build_aux_field, pack_masks

    vs, device = stepper.velocity_set, bc_mask.device
    shape = tuple(stepper.grid.shape)
    bcs = stepper.boundary_conditions[:1] if walled_only else stepper.boundary_conditions
    specs = [bc_to_spec(b, vs) for b in bcs]
    mask = pack_masks(bc_mask, missing_mask)
    adj = CollideStreamAdjoint(vs, shape, collision=kernel_collision_spec(stepper), has_solids=stepper.has_solids,
                               bc_specs=specs)
    aux = None if walled_only else build_aux_field(stepper)
    aux = () if aux is None else (torch.as_tensor(aux, device=device),)
    f = perturbed(vs, shape, torch.float32, False, 3, device)
    gen = torch.Generator(device=device).manual_seed(20)
    w = torch.as_tensor(vs._w, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1)
    g = (w * torch.randn(f.shape, generator=gen, device=device)).contiguous()

    def call():
        return adj(f, g, mask, ADJ_OMEGA, *aux)

    ms, launches = cuda_ms(call, 10), k8_launch_ms(call)
    bound, by = k8_bound(f, g, mask, hybrid_aux_bytes(specs, bc_mask, vs), False)
    rec = {"shape": list(shape), "walled": adj.params.walled, "ms": ms, "launches_ms": launches, "bound_ms": bound,
           "bound_by": by, "boundary_share": adj.boundary_share(mask),
           "launch_shape": adj.launch_shape(_cuda.load_library())}
    print(f"K8 {label} {'x'.join(map(str, shape))} f32 (walled {rec['walled']}): {ms:.4f} ms per call, bound {bound:.4f}"
          f" ms by {by} ({100 * bound / ms:.1f}%); launches "
          + "; ".join(f"{k} {v:.4f}" for k, v in launches.items())
          + f" ms; boundary voxels {100 * rec['boundary_share']:.3f}%; (blocks/SM, registers, local B) "
          + "; ".join(f"{k} {v}" for k, v in rec["launch_shape"].items()), flush=True)
    return rec, call


def k8_alternating(calls, n):
    """Device ms of each of ``calls`` (functions of no arguments), taken in
    turns n times (CUDA events around each call): a list of n per call."""
    import torch

    times = [[] for _ in calls]
    for _ in range(n):
        for i, fn in enumerate(calls):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[i].append(start.elapsed_time(end))
    return times


def k8_launches(device):
    """``--k8``: K8 (f32) scene by scene (k8_scene): at 512x256x256 the
    256^3 cavity's BC set (its zoo form), the same with one do-nothing
    voxel (the kExtOpen form with almost no BC voxel: its base cost), and
    open_bcs' "outflow2", "zouhe" and "sphere" scenes; lbm_bench's flow past
    a sphere (bench_sphere) and its walled control, then the two in turns,
    K8_CONTROL_CALLS calls each (k8_alternating); the hybrid sphere-drag
    tunnel at D = SPHERE_BIG_D and windtunnel_3d.py --object-bc hybrid
    (D3Q27 KBC). One line per scene. Returns {scene: record}."""
    import statistics

    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary import DoNothingBC
    from xlb_tpu_torch.examples.cfd import sphere_drag_validation, windtunnel_3d
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    P, B = xlb.PrecisionPolicy.FP32FP32, xlb.ComputeBackend.TORCH

    def with_do_nothing():
        stepper, _ = cavity(OPEN_BIG, P, B, device)
        bcs = list(stepper.boundary_conditions) + [DoNothingBC(indices=[[5], [5], [5]])]
        stepper = IncompressibleNavierStokesStepper(stepper.grid, boundary_conditions=bcs)
        return stepper, stepper.prepare_fields()

    def fields(make):
        return lambda: (lambda st, fl: (st, fl[2], fl[3]))(*make()[:2])

    scenes = [("cavity", fields(lambda: cavity(OPEN_BIG, P, B, device)), False),
              ("cavity + one do-nothing voxel", fields(with_do_nothing), False)]
    scenes += [(kind, fields(lambda kind=kind: open_scene(kind, OPEN_BIG, P, B, device)), False)
               for kind in ("outflow2", "zouhe", "sphere")]
    scenes += [("bench sphere", lambda: bench_sphere(device), False),
               ("bench sphere walled control", lambda: bench_sphere(device, walled=True), True),
               (f"hybrid sphere-drag D={SPHERE_BIG_D}",
                fields(lambda: sphere_drag_validation.build(d=SPHERE_BIG_D, backend="torch", device=device)), False),
               ("windtunnel --object-bc hybrid (D3Q27 KBC)",
                fields(lambda: windtunnel_3d.build(object_bc="hybrid", backend="torch", device=device)), False)]
    out, control = {}, {}
    for label, make, walled_only in scenes:
        stepper, bc_mask, missing_mask = make()
        out[label], call = k8_scene(label, stepper, bc_mask, missing_mask, walled_only)
        if label.startswith("bench sphere"):
            control[label] = call
        del stepper, bc_mask, missing_mask, call
        if len(control) == 2:
            (a, ca), (b, cb) = control.items()
            ta, tb = k8_alternating([ca, cb], K8_CONTROL_CALLS)
            ma, mb = statistics.median(ta), statistics.median(tb)
            out["control"] = {a: ta, b: tb, "ratio": ma / mb}
            print(f"K8 control, {K8_CONTROL_CALLS} calls each in turns (CUDA events): {a} median {ma:.4f} ms (mean "
                  f"{statistics.fmean(ta):.4f}), {b} median {mb:.4f} ms (mean {statistics.fmean(tb):.4f}); the "
                  f"walled form {ma / mb:.3f}x faster", flush=True)
            control.clear()
        torch.cuda.empty_cache()
    return out


# [20]: thermal convection and Shan-Chen multiphase -- K1 and K3's field modes (ade, extern_force)
# xlb_tpu's own numbers: the jnp tier's run() of examples/cfd/rayleigh_benard_2d.py (Nusselt number per
# window of 500) and multiphase_droplet_2d.py ((R, dp, |u|max, rho_min, rho_max) per radius, sigma, the
# Laplace fit's residual) at their defaults, JAX on the CPU (JAX_PLATFORMS=cpu)
RB_REFERENCE = {
    False: [4.686615867798986, 1.0215925112566562, -2.5382509682703818, 2.3258750472570995, 5.1678376151330045,
            4.673081149548953, 4.631260360116496, 5.816937009312578],
    True: [2.8131374866976855, 3.5011567328518685, 2.498722259340606, 1.6722067949310953, 1.4761826360883432,
           2.846772589556977, 4.531127563484688, 4.28101333531135],
}
DROPLET_REFERENCE = {
    "sigma": 0.05503674153888224, "resid": 0.01098620192074827,
    "rows": [[9.507891862878783, 0.00572562962770462, 0.004772797226905823, 0.16328608989715576, 1.9825626611709595],
             [13.81976597885342, 0.004043057560920715, 0.00543183833360672, 0.16116471588611603, 1.9683289527893066],
             [17.787636910694122, 0.00313379243016243, 0.005854792892932892, 0.16004985570907593, 1.9606075286865234]],
}
FIELD_SMALL_2D, FIELD_SMALL_3D = (200, 136), (100, 52, 44)
FIELD_OMEGA = 1.3
THERMAL_2D, RA_2D = (4096, 2048), 1e8
THERMAL_3D, RA_3D = (512, 512, 128), 1e6
SC_3D = (256, 256, 256)
PRANDTL, BETA = 0.71, 5e-4
FIELD_WINDOW, FIELD_REPS = 100, 3
FIELD_PARITY_STEPS = 10
# a bf16 thermal run's mass drift against the TORCH tier's on the same scene: same sign, within this factor
# (measured on an H100: ratios 1.0015 at 4096x2048, 0.960 at 512x512x128, over 400 coupled steps)
BF16_DRIFT_RATIO = 1.25
# the scripts against xlb_tpu's numbers: the Nusselt number per window to 0.01 (the port's TORCH tier on the
# CPU stays within 1.2e-4 of xlb_tpu over the 4000 steps; the convection rolls amplify float32 roundoff);
# per droplet R (from the liquid area: a cell of area moves it by ~1 / (2 pi R), <= 0.017 here), dp and
# |u|max, the densities; sigma
RB_NU_ATOL = 0.01
DROPLET_TOL = (("R", 0, 0.02), ("dp", 1e-3, 1e-6), ("|u|max", 1e-3, 1e-6), ("rho_min", 1e-4, 0),
               ("rho_max", 1e-4, 0))
DROPLET_SIGMA_RTOL = 1e-3


def thermal_3d_scene(shape, rayleigh, policy, backend, device):
    """(thermal stepper, (f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g),
    omega, omega_phi): rayleigh_benard_2d.py's scene in 3D -- D3Q19 BGK,
    halfway floor and ceiling (z) for f, a hot floor and a cold ceiling
    (EquilibriumBC on g), periodic in x and y, gravity -z, the parameters
    from (Ra, Pr = 0.71, beta = 5e-4) over L = nz - 2; phi starts linear
    across the layer with a 1% perturbation."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary import EquilibriumBC, HalfwayBounceBackBC
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.models import (AdvectionDiffusionStepper, IncompressibleNavierStokesStepper, ThermalNSEStepper,
                                      omega_from_diffusivity)
    from xlb_tpu_torch.velocity_set import D3Q19

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D3Q19(), default_backend=backend, default_precision_policy=policy)
    grid = xlb.grid_factory(shape, device=device)
    box = grid.bounding_box_indices()
    nx, ny, nz = shape
    nu = np.sqrt(PRANDTL * BETA * (nz - 2) ** 3 / rayleigh)
    omega, omega_phi = 1.0 / (3.0 * nu + 0.5), omega_from_diffusivity(nu / PRANDTL)
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top")], axis=1), axis=1)
    nse = IncompressibleNavierStokesStepper(grid, boundary_conditions=[HalfwayBounceBackBC(indices=walls.tolist())])
    ade = AdvectionDiffusionStepper(grid, boundary_conditions=[
        EquilibriumBC(rho=1.0, u=(0.0, 0.0, 0.0), indices=box["bottom"]),
        EquilibriumBC(rho=0.0, u=(0.0, 0.0, 0.0), indices=box["top"])])
    thermal = ThermalNSEStepper(nse, ade, beta=BETA, gravity=(0.0, 0.0, -1.0))
    f_0, f_1, bc_f, miss_f = nse.prepare_fields()
    x, y, z = np.meshgrid(np.arange(nx) / nx, np.arange(ny) / ny, np.arange(nz) / (nz - 1.0), indexing="ij")
    phi0 = (1.0 - z) + 0.01 * np.sin(2 * np.pi * 3 * x) * np.sin(2 * np.pi * 2 * y) * np.sin(np.pi * z)
    g_0, g_1, bc_g, miss_g = ade.prepare_fields(phi_init=phi0.astype(np.float32))
    return thermal, (f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g), omega, omega_phi


def shan_chen_scene(shape, policy, backend, device, seed=11, bcs=None, psi_wall=None):
    """(Shan-Chen stepper, (f_0, f_1, bc_mask, missing_mask)): G = -5, BGK,
    from the rest state of rho = 0.7 (1 + 0.01 N(0, 1)) (seeded),
    periodic unless ``bcs(grid, boundary)`` gives walls;
    tests/models/test_multiphase.py's phase separation at ``shape``."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch import boundary
    from xlb_tpu_torch import velocity_set as vsets
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper, ShanChenMultiphaseStepper

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    vs = vsets.D2Q9() if len(shape) == 2 else vsets.D3Q19()
    xlb.init(velocity_set=vs, default_backend=backend, default_precision_policy=policy)
    grid = xlb.grid_factory(shape, device=device)
    nse = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs(grid, boundary) if bcs else ())
    sc = ShanChenMultiphaseStepper(nse, G=-5.0, psi_wall=psi_wall)
    _, _, bc_mask, missing_mask = nse.prepare_fields()
    gen = torch.Generator(device=device).manual_seed(seed)
    rho0 = 0.7 * (1.0 + 0.01 * torch.randn(shape, generator=gen, device=device))
    w = torch.as_tensor(vs._w, dtype=torch.float32, device=device).reshape((-1,) + (1,) * len(shape))
    f_0 = (w * rho0[None]).to(nse.precision_policy.store_dtype).contiguous()
    return sc, (f_0, torch.zeros_like(f_0), bc_mask, missing_mask)


def field_counts(reset=False):
    """{"K1 ade": (launches, plain calls of the class), ...}: the field
    modes' launches by mode, and the kernels' plain calls."""
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DStep
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep

    out = {}
    for name, cls in (("K1", CollideStreamStep), ("K3", CollideStream2DStep)):
        if reset:
            cls.plain_calls = 0
            cls.field_launches = dict.fromkeys(cls.field_launches, 0)
        for mode, n in cls.field_launches.items():
            out[f"{name} {mode}"] = (n, cls.plain_calls)
    return out


def ade_flops(vs):
    """Float32 operations per voxel of the advection-diffusion body
    (collide_stream.cuh::ade_physics): phi, per opposite pair c_l . u and
    its two linear equilibria, the BGK relaxation of every direction."""
    pairs = [l for l in range(vs.q) if vs._opp_indices[l] > l]
    return (vs.q - 1) + sum(int(np.count_nonzero(vs._c[:, l])) - 1 + 6 for l in pairs) + 1 + 3 * vs.q


def hydrostatic_start(thermal, state):
    """The full-width thermal runs' start: phi_ref at the layer's mean
    scalar (1/2) and f_0 = f_1 at rest in hydrostatic balance with the
    buoyancy of the initial phi, rho = exp(3 sum F) along gravity's axis
    (cs^2 = 1/3; the exact-difference force F is the velocity gained per
    step), scaled to a mean of 1. From a uniform rest state the layer's
    column would accelerate until a sound wave crossed it (~3500 steps at
    4096x2048). Returns the new state."""
    import torch

    thermal.phi_ref = 0.5
    f_0, _, g_0, *rest = state
    force = thermal.buoyancy(thermal.ade.phi(g_0))
    axis = int(np.argmax(np.abs(thermal.gravity)))
    rho = torch.exp(3.0 * torch.cumsum(force[axis].double(), dim=axis))
    rho = (rho / rho.mean()).float()
    vs = thermal.nse.velocity_set
    w = torch.as_tensor(vs._w, dtype=torch.float32, device=rho.device).reshape((-1,) + (1,) * vs.d)
    f_0 = (w * rho[None]).to(f_0.dtype).contiguous()
    return (f_0, f_0.clone(), g_0, *rest)


def field_bound(kernel, f, mask, aux_bytes):
    """(least ms, "bytes" or "operations") of one field-mode step: f and the
    mask read once, f written once, the field's d channels and the BCs'
    aux bytes (at their voxels) read once; the body's operations
    (zoo_flops with the force for extern_force, ade_flops for ade)."""
    from xlb_tpu_torch.kernels.collide_stream import split_collision

    vs, voxels = kernel.vs, mask.numel()
    t_bytes = (2 * f.numel() * f.element_size() + voxels * 4 * (1 + vs.d) + aux_bytes) / HBM_BYTES_PER_S * 1e3
    name, _ = split_collision(kernel.collision)
    flops = ade_flops(vs) if kernel.field == "ade" else zoo_flops(vs, name, False, True)
    t_ops = flops * voxels / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def field_case(stepper, field, store, seed, device):
    """A field-mode kernel of ``stepper``'s scene (``fused_step._FieldStep``'s
    kernel) and its inputs: a seeded perturbed state in ``store``, the
    packed mask, the aux field (a seeded field -- an advecting velocity of
    0.03 N(0, 1), or a force of 1e-3 N(0, 1) -- then the BCs' channels),
    and the BCs' aux bytes per step."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream import kernel_collision_spec
    from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DStep
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, build_aux_field, pack_masks

    vs, shape = stepper.velocity_set, tuple(stepper.grid.shape)
    specs = [bc_to_spec(b, vs) for b in stepper.boundary_conditions]
    collision = "BGK" if field == "ade" else kernel_collision_spec(stepper)
    cls = CollideStream2DStep if vs.d == 2 else CollideStreamStep
    kernel = cls(vs, shape, collision=collision, bc_specs=specs, store_dtype=store, field=field)
    fields = stepper.prepare_fields()
    bc_mask, missing_mask = fields[2], fields[3]
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = 0.03 if field == "ade" else 1e-3
    aux = [scale * torch.randn((vs.d,) + shape, generator=gen, device=device)]
    bc_aux = build_aux_field(stepper)
    if bc_aux is not None:
        aux.append(torch.as_tensor(bc_aux, device=device))
    aux = torch.cat(aux).contiguous()
    f = perturbed(vs, shape, store, False, seed + 1, device)
    return kernel, f, pack_masks(bc_mask, missing_mask), aux, hybrid_aux_bytes(specs, bc_mask, vs)


def held_field(kernel, f, mask, aux, label, time_them=False):
    """Hold a field-mode kernel against its plain version (held: f32 rtol
    1e-5 / atol 1e-6, bf16 8 ulps) and two launches against each other bit
    for bit; with ``time_them`` also the kernel's and the plain version's
    ms (CUDA events). Returns the record."""
    import torch

    out = kernel(f, mask, FIELD_OMEGA, aux)
    check(torch.equal(out, kernel(f, mask, FIELD_OMEGA, aux)), f"{label}: two launches differ")
    ref = kernel.plain(f, mask, FIELD_OMEGA, aux)
    err, share = held(out, ref, kernel.store_dtype)
    check(share <= 1.0, f"{label}: kernel vs plain max|err| {err:.3e} ({share:.3f} of tol)")
    rec = {"max_abs_err": err, "tolerance_share": share}
    if time_them:
        rec["ms"] = cuda_ms(lambda: kernel(f, mask, FIELD_OMEGA, aux), 10)
        rec["plain_ms"] = cuda_ms(lambda: kernel.plain(f, mask, FIELD_OMEGA, aux), 1, warmup=False)
    return rec


def field_cases(device, shape_2d=FIELD_SMALL_2D, shape_3d=FIELD_SMALL_3D, d_st=20):
    """[(label, TORCH-tier stepper, field mode)] of every new form: K3 ade on
    the 2D thermal scene's g BCs (equilibrium floor and ceiling, the
    halfway obstacle) and on a Zou-He pressure face with a halfway
    obstacle, extern_force on the thermal scene's f BCs (halfway) and, in
    its kExtHybrid form, on the Schafer-Turek scene at D = ``d_st``; K1
    ade on the 3D thermal scene and on Zou-He / regularized / do-nothing /
    equilibrium faces (kExtOpen), extern_force on the 3D thermal scene
    (walled), on the flow past a sphere (kExtOpen: the aux inlet, the
    outflow) and the open hybrid tunnel (kExtHybrid), and D3Q27 KBC's
    three forms."""

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch import boundary
    from xlb_tpu_torch.examples.cfd import cylinder_benchmark_schafer_turek as st
    from xlb_tpu_torch.geometry.distances import implicit_link_distances
    from xlb_tpu_torch.examples.cfd import rayleigh_benard_2d as rb
    from xlb_tpu_torch.models import AdvectionDiffusionStepper, IncompressibleNavierStokesStepper

    torch_tier = xlb.ComputeBackend.TORCH
    f32 = xlb.PrecisionPolicy.FP32FP32

    def ade_open(grid):
        box_ne = grid.bounding_box_indices(remove_edges=True)
        return [boundary.ZouHeBC("pressure", prescribed_value=1.2, indices=box_ne["left"]),
                boundary.RegularizedBC("pressure", prescribed_value=0.9, indices=box_ne["right"]),
                boundary.DoNothingBC(indices=box_ne["front"]),
                boundary.EquilibriumBC(rho=0.5, u=(0.0, 0.0, 0.0), indices=box_ne["back"])]

    def zouhe_obstacle(grid):
        nx, ny = grid.shape
        box_ne = grid.bounding_box_indices(remove_edges=True)
        xx, yy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        circ = np.stack(np.nonzero((xx - nx / 2) ** 2 + (yy - ny / 2) ** 2 <= (ny / 7) ** 2))
        return [boundary.ZouHeBC("pressure", prescribed_value=1.5, indices=box_ne["left"]),
                boundary.HalfwayBounceBackBC(indices=circ.tolist())]

    def init(vs_name, shape):
        from xlb_tpu_torch import velocity_set as vsets
        from xlb_tpu_torch.boundary.registry import boundary_condition_registry

        xlb.DefaultConfig.reset()
        boundary_condition_registry.reset()
        xlb.init(velocity_set=getattr(vsets, vs_name)(), default_backend=torch_tier, default_precision_policy=f32)
        return xlb.grid_factory(shape, device=device)

    cases = []
    thermal, *_ = rb.build(*shape_2d, backend="torch", obstacle=True, device=device)
    cases += [("K3 ade thermal", thermal.ade, "ade"), ("K3 extern_force thermal", thermal.nse, "extern_force")]
    grid = init("D2Q9", shape_2d)
    cases.append(("K3 ade zouhe+obstacle", AdvectionDiffusionStepper(grid, zouhe_obstacle(grid)), "ade"))
    nx, ny, _, _ = st.geometry(d_st)
    grid = init("D2Q9", (nx, ny))
    bcs = st.schafer_turek_bcs(grid, boundary, implicit_link_distances, d_st,
                               hybrid_method="bounceback_regularized")
    cases.append((f"K3 extern_force hybrid Schafer-Turek D={d_st}",
                  IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs), "extern_force"))
    thermal3, *_ = thermal_3d_scene(shape_3d, RA_3D, f32, torch_tier, device)
    cases += [("K1 ade thermal 3D", thermal3.ade, "ade"), ("K1 extern_force thermal 3D", thermal3.nse, "extern_force")]
    grid = init("D3Q19", shape_3d)
    cases.append(("K1 ade open (kExtOpen)", AdvectionDiffusionStepper(grid, ade_open(grid)), "ade"))
    for pair, scene in ((("D3Q19", "BGK"), "sphere"), (("D3Q27", "KBC"), "rotating")):
        stepper, _ = open_scene(scene, shape_3d, f32, torch_tier, device)
        cases.append((f"K1 extern_force {pair[0]} {pair[1]} {scene} (kExtOpen)", stepper, "extern_force"))
        stepper, _ = hybrid_scene(pair, "bounceback_regularized", True, "spin", "open", shape_3d, device)
        cases.append((f"K1 extern_force {pair[0]} {pair[1]} hybrid tunnel (kExtHybrid)", stepper, "extern_force"))
    grid = init("D3Q27", shape_3d)
    box = grid.bounding_box_indices()
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top")], axis=1), axis=1)
    cases.append(("K1 extern_force D3Q27 KBC halfway walls",
                  IncompressibleNavierStokesStepper(grid, [boundary.HalfwayBounceBackBC(indices=walls.tolist())],
                                                    collision_type="KBC"), "extern_force"))
    return cases


def compare_field(device):
    """Every case of field_cases (200x136, 100x52x44, Schafer-Turek at D =
    20) against its plain version, f32 and bf16, each two launches bit for
    bit. Returns {form: record}."""
    import torch

    records = {}
    for i, (label, stepper, field) in enumerate(field_cases(device)):
        for store in (torch.float32, torch.bfloat16):
            kernel, f, mask, aux, _ = field_case(stepper, field, store, 100 + i, device)
            name = f"{label} {'f32' if store == torch.float32 else 'bf16'}"
            records[name] = rec = held_field(kernel, f, mask, aux, name)
            print(f"  {name}: max|err| {rec['max_abs_err']:.3e} ({rec['tolerance_share']:.3f} of tol), bit-equal")
    return records


def thermal_tier_parity(device):
    """FIELD_PARITY_STEPS coupled steps of the CUDA tier against the TORCH
    tier on the card (rtol 1e-4; atol 1e-4 of the largest |value|): the 2D
    thermal scene with its obstacle at 200x136, the 3D one at 100x52x44,
    Shan-Chen in 2D (a 96^2 droplet on a halfway floor, psi_wall 0.85) and
    in 3D (64^3 periodic). Returns {scene: (max|err| f, max|err| g)}."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.examples.cfd import rayleigh_benard_2d as rb

    f32 = xlb.PrecisionPolicy.FP32FP32
    out = {}

    def close(a, b, label):
        a, b = a.float(), b.float()
        err = float((a - b).abs().max())
        check(within(a, b, 1e-4, 1e-4 * float(b.abs().max()))[1], f"{label}: CUDA vs TORCH tier max|err| {err:.3e}")
        return err

    for label, build in (
        ("thermal 2D 200x136 + obstacle",
         lambda be: rb.build(*FIELD_SMALL_2D, backend=be, obstacle=True, device=device)[:4]),
        ("thermal 3D 100x52x44",
         lambda be: thermal_3d_scene(FIELD_SMALL_3D, RA_3D, f32, xlb.ComputeBackend[be.upper()], device)),
    ):
        res = []
        for be in ("cuda", "torch"):
            thermal, state, omega, omega_phi = build(be)
            f, _, g, _ = thermal.build_multi_step(FIELD_PARITY_STEPS)(*state, omega, omega_phi)
            res.append((f, g))
        out[label] = (close(res[0][0], res[1][0], label + " f"), close(res[0][1], res[1][1], label + " g"))
        print(f"  {label}: CUDA vs TORCH tier after {FIELD_PARITY_STEPS} coupled steps, max|err| f {out[label][0]:.3e}, "
              f"g {out[label][1]:.3e}")

    def floor(grid, bnd):
        nx = grid.shape[0]
        return [bnd.HalfwayBounceBackBC(indices=[list(range(nx)), [0] * nx])]

    for label, shape, bcs, psi_wall in (("Shan-Chen 2D 96^2 droplet floor", (96, 96), floor, 0.85),
                                        ("Shan-Chen 3D 64^3", (64, 64, 64), None, None)):
        res = []
        for be in (xlb.ComputeBackend.CUDA, xlb.ComputeBackend.TORCH):
            sc, fields = shan_chen_scene(shape, f32, be, device, bcs=bcs, psi_wall=psi_wall)
            if be == xlb.ComputeBackend.CUDA:
                check(sc._fused_nse is not None, f"{label}: the CUDA tier has no fused forced step")
            res.append(sc.build_multi_step(FIELD_PARITY_STEPS)(*fields, 1.0)[0])
        out[label] = (close(res[0], res[1], label), None)
        print(f"  {label}: CUDA vs TORCH tier after {FIELD_PARITY_STEPS} steps, max|err| {out[label][0]:.3e}")
    return out


def script_runs(device, backend):
    """rayleigh_benard_2d.py (with and without --obstacle) and
    multiphase_droplet_2d.py at their defaults, in their torch form, on
    ``backend``'s tier on the card: {"rb obstacle=False": Nusselt numbers,
    "rb obstacle=True": ..., "droplets": (rows, sigma, residual), "seconds":
    {run: s}}; on the CUDA tier also "launches": {run: field_counts()}."""
    from xlb_tpu_torch.examples.cfd import multiphase_droplet_2d as md
    from xlb_tpu_torch.examples.cfd import rayleigh_benard_2d as rb

    out = {"seconds": {}, "launches": {}}
    runs = [(f"rb obstacle={o}", lambda o=o: rb.run(backend=backend, obstacle=o, device=device).tolist())
            for o in (False, True)]
    runs.append(("droplets", lambda: (lambda s, r, rows: (rows, s, r))(*md.run(backend=backend, device=device))))
    for label, run in runs:
        field_counts(reset=True)
        t0 = time.perf_counter()
        out[label] = run()
        out["seconds"][label] = time.perf_counter() - t0
        out["launches"][label] = field_counts()
    return out


def torch_tier_runs(device):
    """The TORCH tier's side, on the card, of the comparisons of the CUDA
    tier against the TORCH tier in [17] (flow_past_sphere_3d.py with both
    inlets, windtunnel_3d.py, rotating_sphere_3d.py at their defaults),
    [18] (the Schafer-Turek force history, windtunnel_3d.py --object-bc
    hybrid) and [20] (script_runs). Returns {run: result, "seconds": {run:
    s}}."""
    from xlb_tpu_torch.examples.cfd import flow_past_sphere_3d, rotating_sphere_3d, windtunnel_3d

    runs = [(f"flow_past_sphere {inlet}",
             lambda inlet=inlet: flow_past_sphere_3d.run(inlet=inlet, backend="torch", device=device))
            for inlet in ("parabolic", "uniform")]
    runs += [("windtunnel", lambda: windtunnel_3d.run(backend="torch", device=device)),
             ("rotating_sphere", lambda: rotating_sphere_3d.run(backend="torch", device=device, return_velocity=True)),
             ("schafer_turek history", lambda: schafer_turek_history("torch", device)),
             ("windtunnel hybrid", lambda: windtunnel_3d.run(object_bc="hybrid", backend="torch", device=device)),
             ("scripts", lambda: script_runs(device, "torch"))]
    out = {"seconds": {}}
    for name, run in runs:
        t0 = time.perf_counter()
        out[name] = run()
        out["seconds"][name] = time.perf_counter() - t0
    return out


def start_torch_tier(path):
    """torch_tier_runs in a second process (``--torch-tier PATH``), which
    pickles its record to ``path``: those runs are bound by the host's
    launches of small torch operations, and the card idles while the
    kernels build, so they run beside the build. Returns the process."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--torch-tier", str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def torch_tier_result(proc, path):
    """The record of start_torch_tier's process, once it has ended (the
    file is removed)."""
    import pickle

    out, _ = proc.communicate(timeout=1200)
    check(proc.returncode == 0, f"the TORCH-tier runs failed:\n{out[-3000:]}")
    with open(path, "rb") as fh:
        rec = pickle.load(fh)
    path.unlink()
    return rec


def field_scripts(device, torch_runs):
    """The scripts of script_runs on the CUDA tier (launches counted: one of
    each mode per coupled step, no plain call) and, from ``torch_runs``
    (script_runs' record on the TORCH tier), on the TORCH tier, against
    xlb_tpu's numbers (RB_REFERENCE, DROPLET_REFERENCE) within RB_NU_ATOL
    and DROPLET_TOL, and the two tiers against each other as tight."""
    runs = {"cuda": script_runs(device, "cuda"), "torch": torch_runs}
    rec = {}
    for obstacle in (False, True):
        label = f"rb obstacle={obstacle}"
        ref = np.asarray(RB_REFERENCE[obstacle])
        nus = {be: np.asarray(r[label]) for be, r in runs.items()}
        counts = runs["cuda"]["launches"][label]
        check(counts["K3 ade"][0] == 4000 and counts["K3 extern_force"][0] == 4000 and counts["K3 ade"][1] == 0,
              f"Rayleigh-Benard obstacle={obstacle}: launches {counts}")
        for be, nu in nus.items():
            print(f"  rayleigh_benard_2d obstacle={obstacle} [{be}] in {runs[be]['seconds'][label]:.1f} s: Nu "
                  f"{np.round(nu, 4).tolist()}")
        for be, nu in list(nus.items()) + [("cuda vs torch", nus["cuda"] - nus["torch"] + ref)]:
            err = float(np.abs(nu - ref).max())
            check(err <= RB_NU_ATOL, f"Rayleigh-Benard obstacle={obstacle} [{be}]: Nu {nu} vs {ref} (max {err:.3e})")
        rec[label] = {"nu_cuda": nus["cuda"].tolist(), "nu_torch": nus["torch"].tolist(), "nu_xlb_tpu": ref.tolist(),
                      "max_err_xlb_tpu": float(np.abs(nus["cuda"] - ref).max()),
                      "max_err_tiers": float(np.abs(nus["cuda"] - nus["torch"]).max()),
                      "seconds": {be: r["seconds"][label] for be, r in runs.items()}}
    ref_rows = np.asarray(DROPLET_REFERENCE["rows"])

    def droplets_close(rows, ref, sigma, sigma_ref, label):
        for col, (name, rtol, atol) in enumerate(DROPLET_TOL):
            check(np.allclose(rows[:, col], ref[:, col], rtol=rtol, atol=atol),
                  f"{label}: {name} {rows[:, col]} vs {ref[:, col]}")
        check(abs(sigma / sigma_ref - 1.0) <= DROPLET_SIGMA_RTOL, f"{label}: sigma {sigma} vs {sigma_ref}")

    counts = runs["cuda"]["launches"]["droplets"]
    check(counts["K3 extern_force"][0] == 3 * 1200 and counts["K3 ade"][1] == 0, f"droplets: launches {counts}")
    for be, r in runs.items():
        rows, sigma, resid = r["droplets"]
        rows = np.asarray(rows)
        droplets_close(rows, ref_rows, sigma, DROPLET_REFERENCE["sigma"], f"droplets [{be}] vs xlb_tpu")
        print(f"  multiphase_droplet_2d [{be}] in {r['seconds']['droplets']:.1f} s: sigma {sigma:.6f} (xlb_tpu "
              f"{DROPLET_REFERENCE['sigma']:.6f}), residual {resid:.4f}")
        rec[f"droplets {be}"] = {"sigma": sigma, "resid": resid, "rows": rows.tolist(),
                                 "max_err_xlb_tpu": float(np.abs(rows - ref_rows).max()),
                                 "seconds": r["seconds"]["droplets"]}
    (rows_c, sigma_c, _), (rows_t, sigma_t, _) = runs["cuda"]["droplets"], runs["torch"]["droplets"]
    droplets_close(np.asarray(rows_c), np.asarray(rows_t), sigma_c, sigma_t, "droplets: CUDA vs TORCH tier")
    return rec


def thermal_conservation(thermal, f, mass0, label, witness=None):
    """Physics checks of a thermal state: finite f, f's mass (halfway walls,
    periodic sides) conserved to 1e-5 relative, max|u| < 0.1. In bf16
    storage, unshifted as xlb_tpu's forced step stores it, every population
    is rounded to 8 bits every step and the mass drifts with the rounding:
    there the drift must have the sign of ``witness``, the TORCH tier's
    drift over the same steps of the same scene (thermal_witness_drift),
    and lie within BF16_DRIFT_RATIO of it either way."""
    import torch

    f32 = f.float()
    check(bool(torch.isfinite(f32).all()), f"{label}: non-finite f")
    mass = float(f32.double().sum())
    rho, u = thermal.nse.macroscopic(f32)
    umax = float(u.abs().max())
    drift = mass / mass0 - 1.0
    if f.dtype == torch.float32:
        check(abs(drift) < 1e-5, f"{label}: mass {mass} vs {mass0}")
    else:
        ratio = drift / witness if witness else float("inf")
        check(1.0 / BF16_DRIFT_RATIO <= ratio <= BF16_DRIFT_RATIO,
              f"{label}: mass drift {drift:.4e}, the TORCH tier's {witness:.4e} (ratio {ratio:.3f})")
    check(umax < 0.1, f"{label}: max|u| {umax}")
    return umax, drift


def thermal_big_scene(label, pol, backend, device):
    """(thermal stepper, hydrostatic_start's state, omega, omega_phi) of
    field_big's thermal run ``label`` under the policy ``pol`` on
    ``backend``'s tier."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.examples.cfd import rayleigh_benard_2d as rb

    if label.startswith("thermal 2D"):
        thermal, state, omega, omega_phi, _, _ = rb.build(*THERMAL_2D, rayleigh=RA_2D, backend=backend.name.lower(),
                                                          device=device, precision=pol)
    else:
        thermal, state, omega, omega_phi = thermal_3d_scene(THERMAL_3D, RA_3D, xlb.PrecisionPolicy[pol], backend,
                                                            device)
    return thermal, hydrostatic_start(thermal, state), omega, omega_phi


def thermal_witness_drift(label, pol, device, steps):
    """The relative mass drift of the TORCH tier (the plain steps) over
    ``steps`` coupled steps of field_big's thermal run ``label`` under
    ``pol``, from the same start as the CUDA tier's run. Returns (drift,
    seconds)."""
    import torch

    import xlb_tpu_torch as xlb

    t0 = time.perf_counter()
    thermal, (f_0, f_1, g_0, g_1, *masks), omega, omega_phi = thermal_big_scene(label, pol, xlb.ComputeBackend.TORCH,
                                                                                device)
    mass0 = float(f_0.float().double().sum())
    window = thermal.build_multi_step(FIELD_WINDOW)
    with torch.no_grad():
        for _ in range(steps // FIELD_WINDOW):
            f_0, f_1, g_0, g_1 = window(f_0, f_1, g_0, g_1, *masks, omega, omega_phi)
    drift = float(f_0.float().double().sum()) / mass0 - 1.0  # (the read waits for the card)
    return drift, time.perf_counter() - t0


def field_big(device, smi):
    """The full-width runs: 2D thermal convection at 4096x2048 (Ra 1e8) and
    3D Rayleigh-Benard at 512x512x128 (Ra 1e6) under FP32FP32 and
    FP32BF16, Shan-Chen phase separation at 256^3 under FP32FP32. Each: one
    warm-up window of FIELD_WINDOW coupled steps, then the best of
    FIELD_REPS (MLUPS = voxels x steps / s / 1e6, ms per coupled step), the
    launches over the timed windows (one of each mode per step, no plain
    call), physics checks, peak device memory; then on the final state each
    kernel against its plain version (and two launches bit for bit), timed
    beside its bound, and the glue's share of a step. Before each FP32BF16
    thermal run, the TORCH tier runs the same scene for as many steps: its
    mass drift is the witness thermal_conservation holds the run's against."""
    import torch

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.kernels.fused_step import _FieldStep, pack_masks

    cuda = xlb.ComputeBackend.CUDA
    out = {}

    def timed(run, fields):
        """The best of FIELD_REPS windows after a warm-up one, from the state
        in the list ``fields``, which it empties: the caller then holds no
        reference to the first state while the windows run (the measured
        peak is the run's)."""
        state = tuple(fields)
        fields.clear()
        state = run(*state)  # warm-up
        torch.cuda.synchronize()
        field_counts(reset=True)
        best = float("inf")
        for _ in range(FIELD_REPS):
            t0 = time.perf_counter()
            state = run(*state)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best, state

    for label, policies in (("thermal 2D 4096x2048", ("FP32FP32", "FP32BF16")),
                            ("thermal 3D 512x512x128", ("FP32FP32", "FP32BF16"))):
        for pol in policies:
            torch.cuda.empty_cache()
            witness = None
            if pol == "FP32BF16":  # the TORCH tier's drift over the same steps, before the CUDA tier's run
                witness, witness_s = thermal_witness_drift(label, pol, device, (1 + FIELD_REPS) * FIELD_WINDOW)
                print(f"  {label} {pol} [torch]: mass drift {witness:.4e} over {(1 + FIELD_REPS) * FIELD_WINDOW} "
                      f"coupled steps ({witness_s:.1f} s)")
                torch.cuda.empty_cache()
            thermal, (*fields, bc_f, miss_f, bc_g, miss_g), omega, omega_phi = thermal_big_scene(label, pol, cuda,
                                                                                                  device)
            mass0 = float(fields[0].double().sum())
            shape = tuple(thermal.nse.grid.shape)
            voxels = int(np.prod(shape))
            window = thermal.build_multi_step(FIELD_WINDOW)

            def run(f_0, f_1, g_0, g_1):
                return window(f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g, omega, omega_phi)

            torch.cuda.reset_peak_memory_stats()  # the run's peak, not the setup's
            best, (f_0, f_1, g_0, g_1) = timed(run, fields)
            counts = field_counts()
            k = "K3" if len(shape) == 2 else "K1"
            check(counts[f"{k} ade"][0] == FIELD_REPS * FIELD_WINDOW
                  and counts[f"{k} extern_force"][0] == FIELD_REPS * FIELD_WINDOW and counts[f"{k} ade"][1] == 0,
                  f"{label} {pol}: launches {counts}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            umax, dmass = thermal_conservation(thermal, f_0, mass0, f"{label} {pol}", witness)
            check(bool(torch.isfinite(g_0.float()).all()), f"{label} {pol}: non-finite g")
            ms_step = best / FIELD_WINDOW * 1e3
            mlups = voxels * FIELD_WINDOW / best / 1e6
            # the two kernels on the final state: the forced step's force and the ADE step's velocity as the step
            # computes them
            force = thermal.buoyancy(thermal.ade.phi(g_0))
            _, u = thermal.nse.macroscopic(f_0.float())
            rec = {"mlups": mlups, "ms_per_step": ms_step, "peak_gib": peak, "max_u": umax, "mass_drift": dmass,
                   "mass_drift_torch_tier": witness,
                   "launches": {m: counts[f"{k} {m}"][0] for m in ("ade", "extern_force")}}
            kernel_ms = 0.0
            for field, stepper, f, bc, miss, aux in (("extern_force", thermal.nse, f_0, bc_f, miss_f, force),
                                                     ("ade", thermal.ade, g_0, bc_g, miss_g, u)):
                step = _FieldStep(stepper, field, "BGK")
                mask = pack_masks(bc, miss)
                aux = aux.float().contiguous()
                r = held_field(step.kernel, f.contiguous(), mask, aux, f"{label} {pol} {k} {field}", time_them=True)
                r["bound_ms"], r["bound_by"] = field_bound(step.kernel, f, mask, 0)
                kernel_ms += r["ms"]
                rec[field] = r
                del step, mask
            rec["glue_share"] = (ms_step - kernel_ms) / ms_step
            out[f"{label} {pol}"] = rec
            print(f"  {label} {pol}: {mlups:.1f} MLUPS, {ms_step:.4f} ms per coupled step (best of {FIELD_REPS} "
                  f"windows of {FIELD_WINDOW}); {k} extern_force {rec['extern_force']['ms']:.4f} ms (bound "
                  f"{rec['extern_force']['bound_ms']:.4f}, plain {rec['extern_force']['plain_ms']:.2f}), {k} ade "
                  f"{rec['ade']['ms']:.4f} ms (bound {rec['ade']['bound_ms']:.4f}, plain {rec['ade']['plain_ms']:.2f}); "
                  f"glue {rec['glue_share']:.1%} of a step; launches {rec['launches']}; max|u| {umax:.4f}, mass drift "
                  f"{dmass:.4e}; peak {peak:.2f} GiB; {smi}")
            del thermal, window, f_0, f_1, g_0, g_1, force, u
    torch.cuda.empty_cache()
    sc, fields = shan_chen_scene(SC_3D, xlb.PrecisionPolicy.FP32FP32, cuda, device)
    check(sc._fused_nse is not None, "Shan-Chen 256^3: the CUDA tier has no fused forced step")
    window = sc.build_multi_step(FIELD_WINDOW)
    *fields, bc_mask, missing_mask = fields
    mass0 = float(fields[0].double().sum())
    torch.cuda.reset_peak_memory_stats()
    best, (f_0, f_1) = timed(lambda a, b: window(a, b, bc_mask, missing_mask, 1.0), fields)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = field_counts()
    check(counts["K1 extern_force"][0] == FIELD_REPS * FIELD_WINDOW and counts["K1 ade"][1] == 0,
          f"Shan-Chen 256^3: launches {counts}")
    f32 = f_0.float()
    check(bool(torch.isfinite(f32).all()), "Shan-Chen 256^3: non-finite f")
    dmass = float(f32.double().sum()) / mass0 - 1.0
    rho, u_true = sc.macroscopic(f32)
    umax = float(u_true.abs().max())
    check(abs(dmass) < 1e-5 and umax < 0.1, f"Shan-Chen 256^3: mass drift {dmass}, max|u| {umax}")
    separated = (float(rho.max()), float(rho.min()))
    ms_step = best / FIELD_WINDOW * 1e3
    step = _FieldStep(sc.nse, "extern_force", "BGK")
    du = sc.interaction_du(torch.sum(f32, dim=0, keepdim=True), bc_mask)
    mask = pack_masks(bc_mask, missing_mask)
    r = held_field(step.kernel, f_0, mask, du.contiguous(), "Shan-Chen 256^3 K1 extern_force", time_them=True)
    r["bound_ms"], r["bound_by"] = field_bound(step.kernel, f_0, mask, 0)
    rec = {"mlups": int(np.prod(SC_3D)) * FIELD_WINDOW / best / 1e6, "ms_per_step": ms_step,
           "peak_gib": peak, "max_u": umax, "mass_drift": dmass,
           "rho_range": separated, "launches": {"extern_force": counts["K1 extern_force"][0]}, "extern_force": r,
           "glue_share": (ms_step - r["ms"]) / ms_step}
    out["Shan-Chen 3D 256^3 FP32FP32"] = rec
    print(f"  Shan-Chen 3D 256^3 FP32FP32: {rec['mlups']:.1f} MLUPS, {ms_step:.4f} ms per step; K1 extern_force "
          f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.2f}); glue {rec['glue_share']:.1%}; "
          f"rho in [{separated[1]:.3f}, {separated[0]:.3f}] after {(1 + FIELD_REPS) * FIELD_WINDOW} steps; max|u| "
          f"{umax:.4f}, mass drift {dmass:.2e}; peak {rec['peak_gib']:.2f} GiB; {smi}")
    return out


def field_kernel_records(kernels, field):
    """Add to K1's and K3's records of the kernels line a "field" entry per
    mode ([20]): launches over the full-width runs, the largest error and
    tolerance share over every comparison, times at the full-width FP32FP32
    runs (K3: the 2D thermal; K1 ade: the 3D thermal; K1 extern_force:
    Shan-Chen at 256^3)."""
    for rec in kernels:
        short = {"collide_stream_step": "K1", "collide_stream_2d_step": "K3"}.get(rec["name"])
        if not short:
            continue
        rec["field"] = {}
        for mode in ("ade", "extern_force"):
            runs = {label: r for label, r in field["big"].items() if mode in r
                    and (label.startswith("thermal 2D") if short == "K3" else not label.startswith("thermal 2D"))}
            compared = [r for label, r in field["kernels"].items() if label.startswith(f"{short} {mode}")]
            compared += [r[mode] for r in runs.values()]
            timed_label = {("K3", "ade"): "thermal 2D 4096x2048 FP32FP32",
                           ("K3", "extern_force"): "thermal 2D 4096x2048 FP32FP32",
                           ("K1", "ade"): "thermal 3D 512x512x128 FP32FP32",
                           ("K1", "extern_force"): "Shan-Chen 3D 256^3 FP32FP32"}[(short, mode)]
            timed = field["big"][timed_label][mode]
            rec["field"][mode] = {
                "launches": sum(r["launches"][mode] for r in runs.values()),
                "max_abs_err": max(r["max_abs_err"] for r in compared),
                "tolerance_share": max(r["tolerance_share"] for r in compared),
                "timed_on": timed_label, **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}


def field_path(device, smi, torch_runs):
    """Phase [20]: compare_field, thermal_tier_parity, field_scripts (the
    TORCH tier's runs from ``torch_runs``), field_big. Returns their
    records."""
    return {"kernels": sub(compare_field, device), "tier_parity": sub(thermal_tier_parity, device),
            "scripts": sub(field_scripts, device, torch_runs), "big": sub(field_big, device, smi)}


def sub(fn, *args):
    """fn(*args), printing its seconds (the parts of a long phase)."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"    ({fn.__name__}: {time.perf_counter() - t0:.1f} s)")
    return out


def build_seconds(log):
    """{source: seconds from the start of the build} of _cuda's build log."""
    import re

    return {m.group(1): float(m.group(2)) for m in re.finditer(r"^# (\S+): ([0-9.]+) s$", log or "", re.M)}


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
    if "--ptxas" in sys.argv:  # this tree's ptxas report, entry by entry
        _cuda.load_library()
        print("PTXAS " + json.dumps({name: list(rest) for name, *rest in _cuda.ptxas_report()}))
        return 0
    if "--k8" in sys.argv:  # with --out PATH, the records as JSON there too
        _cuda.load_library()
        rec = k8_launches(device)
        if "--out" in sys.argv:
            Path(sys.argv[sys.argv.index("--out") + 1]).write_text(json.dumps(rec, indent=1))
        return 0
    if "--torch-tier" in sys.argv:  # start_torch_tier's process
        import pickle

        rec = torch_tier_runs(device)
        with open(sys.argv[sys.argv.index("--torch-tier") + 1], "wb") as fh:
            pickle.dump(rec, fh)
        return 0
    if "--probes" in sys.argv:  # phase [16] alone
        _cuda.load_library()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(smi)
        n_cmp, errs = compare_probes(device)
        runs, counts, plain_ms, roofline = probe_path(device)
        inter = probe_interleaved(device)
        print(json.dumps({"kernels": probe_records(runs, counts, plain_ms, n_cmp, errs, inter),
                          "copy_roofline": roofline}))
        return 0
    if "--field" in sys.argv:  # phase [20] alone
        _cuda.load_library()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(smi)
        print(json.dumps(field_path(device, smi, script_runs(device, "torch"))))
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
    # the TORCH tier's runs of [17], [18] and [20], beside the build
    path = _cuda.BUILD_ROOT.parent / "chip_smoke" / f"torch_tier.{os.getpid()}.pkl"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch_tier = start_torch_tier(path)
    try:
        return run_phases(device, kind, smi, torch_tier, path, t_start)
    finally:
        if torch_tier.poll() is None:
            torch_tier.kill()
            torch_tier.wait()
        path.unlink(missing_ok=True)


def run_phases(device, kind, smi, torch_tier, path, t_start):
    """Phases [2]-[21] of main (``torch_tier``: start_torch_tier's process,
    writing to ``path``, whose record the build waits for)."""
    import torch

    from xlb_tpu_torch.kernels import _cuda

    t0 = time.perf_counter()
    _cuda.load_library()
    phase_s = {"2": time.perf_counter() - t0}
    print(f"[2] kernels built and loaded in {phase_s['2']:.1f} s")
    torch_ref = torch_tier_result(torch_tier, path)
    phase_s["2 wait"] = time.perf_counter() - t0 - phase_s["2"]
    runs = ", ".join(f"{k} {v:.1f} s" for k, v in torch_ref["seconds"].items())
    print(f"    the TORCH tier's runs beside it ({runs}); then waited {phase_s['2 wait']:.1f} s for them")
    marks = [("2", time.perf_counter())]

    def mark(label):
        """Close the running phase (print and record its seconds) and open ``label``."""
        now = time.perf_counter()
        prev, t_prev = marks[-1]
        if prev != "2":
            phase_s[prev] = now - t_prev
            print(f"  [{prev}] in {phase_s[prev]:.1f} s")
        marks.append((label, time.perf_counter()))

    slowest = sorted(build_seconds(_cuda.build_log()).items(), key=lambda kv: -kv[1])[:6]
    print("    the build's slowest sources: " + ", ".join(f"{k} {v:.1f} s" for k, v in slowest))
    for line in ptxas_summary(_cuda.ptxas_report()):
        print("    " + line)

    mark("3")
    print("[3] kernels against their plain versions")
    compare_kernels(SMALL, device, seed=0, time_them=False)
    compare_kernels(SMALL, device, seed=2, time_them=False, solid=True)
    big = compare_kernels((N_MAIN,) * 3, device, seed=1, time_them=True)
    many_bcs = {"3d": compare_many_bcs_3d(SMALL, device, seed=7)}

    mark("4")
    print(f"[4] main path at {N_MAIN}^3, {smi}")
    perf, counts = main_path(device)
    print(f"  launch counts (launches, plain calls): {counts}")
    for name, (launches, plain_calls) in counts.items():
        check(launches > 0, f"{name} was not launched on the main path")
        check(plain_calls == 0, f"{name}'s plain version ran on the main path")

    mark("5")
    print("[5] the adjoint kernel against its plain version")
    compare_adjoint(SMALL, device, seed=3, time_them=False, solid=True)
    compare_adjoint(SMALL, device, seed=4, time_them=False, solid=False)
    big["collide_stream_adjoint"] = compare_adjoint((N_MAIN,) * 3, device, seed=6, time_them=True, solid=False)

    mark("6")
    print(f"[6] training path at {N_MAIN}^3, {smi}")
    gradient_parity(device)
    training, train_counts = training_path(device)
    print(f"  launch counts (launches, plain calls): {train_counts}")
    for name, (launches, plain_calls) in train_counts.items():
        check(launches > 0, f"{name} was not launched on the training path")
        check(plain_calls == 0, f"{name}'s plain version ran on the training path")
    check(train_counts["CollideStreamAdjoint"][0] == 2 * TRAIN_ITERS * TRAIN_WINDOW, "adjoint launches != W per backward")

    mark("7")
    print("[7] the 2D kernels against their plain versions")
    big_2d = compare_kernels_2d("halfway_cavity", SMALL_2D, device, seed=11)
    for more in (compare_kernels_2d("cylinder", CYL_SHAPE, device, seed=12, inout="zouhe"),
                 compare_kernels_2d("cylinder", CYL_SHAPE, device, seed=12, inout="regularized"),
                 compare_kernels_2d("many_bcs", SMALL_2D, device, seed=14),
                 compare_kernels_2d("cavity", (N_2D, N_2D), device, seed=9, steps=K_SWEEP_2D, time_them=True)):
        for name, recs in more.items():
            big_2d[name].update(recs)

    mark("8")
    print(f"[8] 2D main path at {N_2D}^2, {smi}")
    perf_2d, counts_2d = main_path_2d(device)
    print(f"  launch counts (launches, plain calls): {counts_2d}")
    for name, (launches, plain_calls) in counts_2d.items():
        check(launches > 0, f"{name} was not launched on the 2D main path")
        check(plain_calls == 0, f"{name}'s plain version ran on the 2D main path")

    mark("9")
    print(f"[9] the cylinder at its script's defaults, {smi}")
    cylinder, cyl_counts = cylinder_path(device)
    print(f"  launch counts (launches, plain calls): {cyl_counts}")
    for name, (launches, plain_calls) in cyl_counts.items():
        check(launches > 0 and plain_calls == 0, f"{name}: not launched, or its plain version ran, on the cylinder")

    mark("10")
    print("[10] the multires kernels against their plain versions at the benchmark's shapes")
    big_mres = compare_kernels_mres(device, seed=41, solid=False, time_them=True)
    for name, recs in compare_kernels_mres(device, seed=42, solid=True, time_them=False).items():
        big_mres[name].update(recs)

    mark("11")
    print(f"[11] the bench.py multires scenes (mlups_3d_multires.py, FUSION_AT_FINEST), {smi}")
    perf_mres, counts_mres, tiers_mres, parity_mres = mres_main_path(device)
    print(f"  launch counts of the timed windows (launches, plain calls): {counts_mres}")
    check(counts_mres["CollideThenStream"][0] > 0 and counts_mres["CollideThenStream pair"][0] > 0,
          "the collide-then-stream kernel was not launched on the multires main path")
    check(counts_mres["CollideThenStream"][1] == 0, "the collide-then-stream plain version ran on the multires main path")

    mark("12")
    print("[12] the walled 2-level cavity under FUSION_AT_FINEST_SFV_ALL")
    walled, counts_walled = mres_walled_path(device)
    print(f"  launch counts (launches, plain calls): {counts_walled}")
    for name, (launches, plain_calls) in counts_walled.items():
        check(launches > 0 and plain_calls == 0, f"{name}: not launched, or its plain version ran, on the walled cavity")

    mark("13")
    print("[13] the collision zoo's kernels (K1, K2, K0) against their plain versions")
    big_zoo = sub(compare_zoo, device)

    mark("14")
    print(f"[14] mlups_3d.py's cavity at {N_MAIN}^3 for every collision, through K1, K2 and K0, {smi}")
    perf_zoo, counts_zoo, parity_zoo = zoo_main_path(device)
    print(f"  launches over the timed routes: {counts_zoo}")

    mark("15")
    print(f"[15] the turbulent channel (turbulent_channel_3d.py), {smi}")
    channel, counts_chan = channel_path(device)
    print(f"  launch counts of the run() window (launches, plain calls): {counts_chan}")
    zoo_adjoint = sub(compare_zoo_adjoint, device)
    zoo_grads = sub(zoo_gradients, device)

    mark("16")
    print(f"[16] the copy-bandwidth probes (K9-K12: memory_bandwidth.py, dma_experiments.py), {smi}")
    n_cmp, probe_errs = compare_probes(device)
    probes, probe_counts, probe_plain_ms, roofline = probe_path(device)
    probe_inter = probe_interleaved(device)

    mark("17")
    print(f"[17] the open-boundary path (flows past a sphere: K1, K2, K0 with kExtOpen), {smi}")
    open_errs, open_shares = sub(compare_open, device)
    open_rec, open_counts = sub(open_scripts, device, torch_ref)
    open_perf = sub(open_big, device)
    print(f"  launches over the scripts' CUDA-tier runs: {open_counts}")
    for rec in open_perf.values():  # the byte bound at [16]'s measured copy roofline, over the kernel time
        for name in ("K1", "K2", "K0"):
            rec[name]["roofline_share"] = rec[name]["bound_ms"] * HBM_BYTES_PER_S / (roofline["GBps"] * 1e9) / rec[name]["ms"]
    print(f"  the open kernels at {'x'.join(map(str, OPEN_BIG))} against the measured copy roofline "
          f"({roofline['GBps']:.1f} GB/s): " + "; ".join(f"{pol} {n} {rec[n]['roofline_share']:.3f}"
                                                     for pol, rec in open_perf.items() for n in ("K1", "K2", "K0")))
    print("  [4]'s cavity MLUPS, this run / recorded in PERF.md: "
          + ", ".join(f"{k} {perf[k][0]:.1f} / {v} ({perf[k][0] / v - 1:+.2%})" for k, v in CAVITY_RECORDED_MLUPS.items()))

    mark("18")
    print(f"[18] the curved-wall path (HybridBC: K1, K2, K0 with kExtHybrid; K3, K4 with the 2D aux form), {smi}")
    hybrid_errs, hybrid_shares, n_hybrid = sub(compare_hybrid, device)
    hybrid_rec, hybrid_counts = sub(hybrid_scripts, device, smi, torch_ref)
    hybrid_2d = sub(hybrid_2d_times, device)
    hybrid_perf = sub(hybrid_big, device)
    print(f"  launches over the scripts' CUDA-tier runs: {hybrid_counts}")
    for rec in hybrid_perf.values():  # the byte bound at [16]'s measured copy roofline, over the kernel time
        for name in ("K1", "K2", "K0"):
            rec[name]["roofline_share"] = rec[name]["bound_ms"] * HBM_BYTES_PER_S / (roofline["GBps"] * 1e9) / rec[name]["ms"]
    print(f"  the hybrid kernels at the D={SPHERE_BIG_D} tunnel against the measured copy roofline "
          f"({roofline['GBps']:.1f} GB/s): " + "; ".join(f"{pol} {n} {rec[n]['roofline_share']:.3f}"
                                                     for pol, rec in hybrid_perf.items() for n in ("K1", "K2", "K0")))
    print(f"  {n_hybrid} kernel comparisons")

    mark("19")
    print(f"[19] gradients through the open boundaries and curved walls (K8's kExtOpen and kExtHybrid forms), {smi}")
    print(f"  K8 against its plain version (float64 TORCH-tier autograd for D3Q27 KBC), in [17] and [18]: open "
          f"max|err| {open_errs['K8']:.3e} ({open_shares['K8']:.3f} of tol), hybrid {hybrid_errs['K8']:.3e} "
          f"({hybrid_shares['K8']:.3f} of tol); two calls bit-equal on each")
    window_grads = sub(open_window_gradients, device)
    open_train = sub(train_open, device)
    for rec in open_train.values():  # the byte bound at [16]'s measured copy roofline, over the kernel time
        k8 = rec["K8"]
        k8["roofline_share"] = k8["bound_ms"] * HBM_BYTES_PER_S / (roofline["GBps"] * 1e9) / k8["ms"]
    print(f"  K8 on the final states against the measured copy roofline ({roofline['GBps']:.1f} GB/s): "
          + "; ".join(f"{label} {rec['K8']['roofline_share']:.3f}" for label, rec in open_train.items()))

    mark("20")
    print(f"[20] thermal convection and Shan-Chen multiphase (K1, K3: the ade and extern_force modes), {smi}")
    field = field_path(device, smi, torch_ref["scripts"])
    mark("21")

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
    kernels += probe_records(probes, probe_counts, probe_plain_ms, n_cmp, probe_errs, probe_inter)
    check(len(kernels) == 13, f"the kernels line lists {len(kernels)} kernels, not K0-K12")
    for rec in kernels:  # the open-boundary path's K1, K2, K0: 512^2 x 256 flow past a sphere, FP32FP32's f32 form
        short = {"collide_stream_step": "K1", "collide_stream_kstep": "K2", "collide_stream_blocked": "K0"}.get(rec["name"])
        if short:
            big_open = open_perf["FP32FP32"][short]
            rec["open"] = {"launches": open_counts[{"K1": "CollideStreamStep", "K2": "CollideStreamKStep",
                                                    "K0": "CollideStreamBlocked"}[short]],
                           "max_abs_err": max(open_errs[short], big_open["max_abs_err"],
                                              open_perf["FP32BF16"][short]["max_abs_err"]),
                           "tolerance_share": open_shares[short],
                           **{k: big_open[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "roofline_share")},
                           "ms_bf16": open_perf["FP32BF16"][short]["ms"],
                           "bound_ms_bf16": open_perf["FP32BF16"][short]["bound_ms"]}
    for rec in kernels:  # the curved-wall path's kernels: K1, K2 at the D=48 sphere-drag tunnel, FP32FP32's f32 form
        short = {"collide_stream_step": "K1", "collide_stream_kstep": "K2", "collide_stream_blocked": "K0",
                 "collide_stream_2d_step": "K3", "collide_stream_2d_kstep": "K4"}.get(rec["name"])
        if short:
            cls = {"K1": "CollideStreamStep", "K2": "CollideStreamKStep", "K0": "CollideStreamBlocked",
                   "K3": "CollideStream2DStep", "K4": "CollideStream2DKStep"}[short]
            rec["hybrid"] = {"launches": hybrid_counts.get(cls, 0), "max_abs_err": hybrid_errs[short],
                             "tolerance_share": hybrid_shares[short]}
            if short in ("K1", "K2", "K0"):  # the D=48 sphere-drag tunnel, f32 and bf16-shifted
                big_h = hybrid_perf["FP32FP32"][short]
                rec["hybrid"].update({k: big_h[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "roofline_share")},
                                     ms_bf16=hybrid_perf["FP32BF16"][short]["ms"],
                                     bound_ms_bf16=hybrid_perf["FP32BF16"][short]["bound_ms"])
            else:  # the Schafer-Turek scene, D=60
                two_d = hybrid_2d[short]
                rec["hybrid"].update({k: two_d["f32"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                                     ms_bf16=two_d["bf16-shifted"]["ms"], bound_ms_bf16=two_d["bf16-shifted"]["bound_ms"])
    k8 = next(rec for rec in kernels if rec["name"] == "collide_stream_adjoint")
    for form, errs, shares, prefixes in (("open", open_errs, open_shares, ("sphere ",)),
                                         ("hybrid", hybrid_errs, hybrid_shares, ("sphere-drag ", "windtunnel "))):
        # launches over the form's training runs; errors and tolerance shares over [17] / [18] and the runs'
        # final states; times on the largest scene's final state, f32 where it ran
        recs = {label: rec for label, rec in open_train.items() if label.startswith(prefixes)}
        f32 = next((r for label, r in recs.items() if label.startswith(prefixes[0]) and label.endswith("FP32FP32")),
                   None)
        bf16 = next(r for label, r in recs.items() if label.startswith(prefixes[0]) and label.endswith("FP32BF16"))
        timed = (f32 or bf16)["K8"]
        k8[form] = {"launches": sum(r["launches"]["CollideStreamAdjoint"][0] for r in recs.values()),
                    "max_abs_err": max([errs["K8"]] + [r["K8"]["max_abs_err"] for r in recs.values()]),
                    "tolerance_share": max([shares["K8"]] + [r["K8"]["tolerance_share"] for r in recs.values()]),
                    "store": "float32" if f32 else "bf16-shifted",
                    **{key: timed[key] for key in ("ms", "plain_ms", "plain_slabs", "bound_ms", "bound_by",
                                                   "roofline_share") if key in timed},
                    "ms_bf16": bf16["K8"]["ms"], "bound_ms_bf16": bf16["K8"]["bound_ms"]}
    field_kernel_records(kernels, field)
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
                      "probes": probes, "probes_interleaved": probe_inter,
                      "copy_roofline": roofline, "open_scripts": open_rec, "open_big": open_perf,
                      "hybrid_scripts": hybrid_rec, "hybrid_2d": hybrid_2d, "hybrid_big": hybrid_perf,
                      "open_window_gradients": window_grads, "open_training": open_train, "field": field,
                      "phase_seconds": phase_s}))
    print(f"[21] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
