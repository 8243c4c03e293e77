#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (xlb_tpu_torch) on one card.

    python3 chip_smoke.py

1. Device: requires CUDA; prints the card's name and power limit.
2. Builds the CUDA kernels from xlb_tpu_torch/csrc with nvcc (sm_90a) and
   prints the build time and the ptxas register/spill report.
3. Holds each kernel against its plain torch version on a seeded,
   perturbed 64x48x40 lid-driven cavity (non-cubic: tile edges and
   periodic wrap are exercised), again with a solid block (cell type 255,
   has_solids) in it, then at 256^3, where it also times kernel and plain
   version (CUDA events) beside the kernel's bound.
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
7. Prints a JSON line of the card, MLUPS, training times and each
   kernel's per-dtype errors and times, then the kernels' JSON line, then
   the result line {"ok": true, "device": {...}} last.

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
}


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


def bound(name, tensors, voxels, shifted):
    """(least ms the card could take, "bytes" or "operations") for a kernel
    that reads its inputs once and writes its outputs once (``tensors``)
    and does FLOPS_PER_VOXEL operations on each of ``voxels``."""
    t_bytes = sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_VOXEL[name][int(shifted)] * voxels / F32_FLOPS_PER_S * 1e3
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
        f_0, f_1 = run(f_0, f_1, bc_mask, missing_mask, OMEGA)  # warm-up window
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            f_0, f_1 = run(f_0, f_1, bc_mask, missing_mask, OMEGA)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from xlb_tpu_torch.kernels import _cuda

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    _cuda.load_library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in (_cuda.build_log() or "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    " + line.strip())

    print("[3] kernels against their plain versions")
    compare_kernels(SMALL, device, seed=0, time_them=False)
    compare_kernels(SMALL, device, seed=2, time_them=False, solid=True)
    big = compare_kernels((N_MAIN,) * 3, device, seed=1, time_them=True)

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

    kernels = []
    for name, cls, source, rep, launches in (
        ("collide_stream_step", "CollideStreamStep", "xlb_tpu_torch/csrc/collide_stream.cu",
         "xlb_tpu/kernels/collide_stream_dma.py:237", counts),
        ("collide_stream_kstep", "CollideStreamKStep", "xlb_tpu_torch/csrc/collide_stream.cu",
         "xlb_tpu/kernels/collide_stream_2step.py:309", counts),
        ("collide_stream_adjoint", "CollideStreamAdjoint", "xlb_tpu_torch/csrc/adjoint_step.cu",
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
    print(json.dumps({"card": smi, "mlups": {k: v[0] for k, v in perf.items()},
                      "ms_per_step": {k: v[1] for k, v in perf.items()}, "training": training,
                      "kernel_variants": big}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
