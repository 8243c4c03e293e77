"""Forward windows back to back: the scene stepped through the callable of
``IncompressibleNavierStokesStepper.build_multi_step(steps)``, each window
taking the state the last one returned.

Set-up builds the scene, makes the seeded initial populations and runs one
window on them (the warm-up: every kernel of the window built and loaded).
The measured window then starts again from the seeded populations and
enqueues windows while its time lasts, one window ahead of the card at
most; it ends in a synchronize. ``mlups``: all voxel-steps of the windows
over all of that time. With ``--trace 1`` the profiler covers windows
1 .. ``trace_windows`` (after a synchronize; that run's rate is not
reported).

The check: the window whose index the seed draws from 0, 1, 2 is held
(its input and its output, no copy); once the window has closed, the
reference runs the same number of steps from that input in the storage
form the traffic states. Window 0 starts from the seeded populations; a
later one from the state the program's earlier windows produced. The
reference is the one the configuration names.
"""

import time

import torch

from lbm_bench import inputs
from lbm_bench.bench import counter_delta, sizes

CHECKED_WINDOWS = 3  # the checked window is drawn from the first three


def run(ctx):
    p, cfg, system = ctx.traffic, ctx.cfg, ctx.system
    shape = tuple(cfg["shape"])
    boundaries = ctx.config.boundaries(cfg)
    omega = ctx.config.omega(cfg)
    with ctx.span("setup.scene"):
        stepper, bc_mask, missing = system.scene(ctx.config, cfg, boundaries, p["policy"])
    f_init = inputs.populations(ctx.reference, shape, ctx.seed, 0, cfg["initial_flow"], system.device)
    window = system.window(stepper, p["steps"])
    before = system.counters()
    with ctx.span("setup.first_window"):
        warm, _ = window(f_init, f_init, bc_mask, missing, omega)
        del warm
    launches = counter_delta(system.counters(), before)

    checked = ctx.seed % CHECKED_WINDOWS
    trace_from, trace_to = 1, 1 + int(p["trace_windows"]) if ctx.trace else 0
    held, traced = {}, None
    f, previous, i = f_init, None, 0
    del f_init
    t0 = ctx.start_window()
    while True:
        if i == trace_from and ctx.trace:
            from lbm_bench.trace import profiled

            tracing = profiled(system.sync)
            traced = tracing.__enter__()
        t = time.perf_counter()
        out, _ = window(f, f, bc_mask, missing, omega)
        if i == 0:  # the card idle when it starts: the host's own cost of a window call
            ctx.spans["fwd.enqueue"] = [time.perf_counter() - t]
        if i == checked:
            held = {"f_in": f, "f_out": out}
        f = out
        del out
        marker = system.event()
        if previous is not None:
            previous.synchronize()
        previous = marker
        i += 1
        if i == trace_to and ctx.trace:
            tracing.__exit__(None, None, None)
        if time.perf_counter() - t0 >= ctx.seconds and i > checked and i >= trace_to:
            break
    system.sync()
    elapsed = time.perf_counter() - t0
    voxels = 1
    for s in shape:
        voxels *= s
    measured = {
        "end_to_end": {"mlups": voxels * p["steps"] * i / elapsed / 1e6},
        "attempted": i,
        "first_step_at": t0,
        "launches": launches,
        "sizes": sizes(cfg, p, boundaries, launches),
        "trace": traced.trace if traced is not None else None,
    }
    materials = dict(held, shape=shape, boundaries=boundaries, omega=omega, steps=p["steps"], storage=p["storage"])
    return measured, materials


def check(ctx, m):
    """The numbers the cell's limits hold: the window's output against the
    reference's from the same input."""
    ref, cfg = ctx.reference, ctx.cfg
    lat = ref.Lattice(m["shape"], m["boundaries"], m["f_in"].device, cfg["velocity_set"], cfg["collision"])
    want = ref.window(lat, m["f_in"], m["steps"], m["omega"], m["storage"])
    del lat
    return compare(m["f_out"], want, ref.W)


def compare(f, ref, w):
    """{"f_max_abs": the largest |f - ref| over every voxel and population,
    "f_rel_l2": ||f - ref|| / ||ref - w||} (``w`` the rest state's
    weights)."""
    worst = torch.zeros((), dtype=torch.float32, device=ref.device)
    num = torch.zeros((), dtype=torch.float64, device=ref.device)
    den = torch.zeros((), dtype=torch.float64, device=ref.device)
    for l in range(ref.shape[0]):
        d = f[l].float() - ref[l]
        worst = torch.maximum(worst, d.abs().max())  # NaN stays NaN
        num += torch.sum(d.double() ** 2)
        den += torch.sum((ref[l].double() - float(w[l])) ** 2)
    return {"f_max_abs": float(worst), "f_rel_l2": float(torch.sqrt(num / den))}
