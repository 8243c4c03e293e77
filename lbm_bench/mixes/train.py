"""Training through the window: Adam on omega, fitting the output of
``build_multi_step(steps)`` to a seeded target field.

One training step: the state (requiring grad) through the window, the
loss mean((out - target)^2), ``loss.backward()`` (the program's adjoint:
the window's replay and K8), Adam's step, omega projected back into
``omega_range``; the next step starts from this step's output. Set-up
builds the scene, the seeded initial state and target, omega and Adam,
and drives the first ``checked`` steps through that same step (the first
is the warm-up); the measured window continues with the same objects.
``train_mlups``: window steps x voxels x the steps completed in the
window over all of its time. With ``--trace 1`` the profiler covers
steps 1 .. ``trace_iterations`` of the window (that run's rate is not
reported).

The check: the reference follows the first ``checked`` steps from the
same seeded state, target, omega and Adam, with autograd through its own
steps. Compared: each step's loss; the first gradient of omega as Adam
got it (its first moment after one step over 1 - beta1); omega's change
after the ``checked`` steps; the first step's gradient of the initial
state; the first step's window output, voxel by voxel.
"""

import time

import torch

from lbm_bench import inputs
from lbm_bench.bench import counter_delta, sizes


def fields(ctx, device):
    """(the seeded initial populations, the seeded target), float32."""
    cfg, shape = ctx.cfg, tuple(ctx.cfg["shape"])
    return (inputs.populations(ctx.reference, shape, ctx.seed, 0, cfg["initial_flow"], device),
            inputs.populations(ctx.reference, shape, ctx.seed, 1, cfg["target_flow"], device))


class Trainer:
    """omega, Adam and the training step around a differentiable window
    ``window(f, f, *masks, omega) -> (out, out)``."""

    def __init__(self, window, masks, target, p, device):
        self.window, self.masks, self.target = window, masks, target
        self.omega = torch.tensor(float(p["omega0"]), dtype=torch.float32, device=device, requires_grad=True)
        self.opt = torch.optim.Adam([self.omega], lr=float(p["lr"]))
        self.lo, self.hi = p["omega_range"]

    def step(self, f, counters=None):
        """One training step from state ``f``: (the window's output, the loss,
        the gradient of ``f``). With ``counters`` (a callable), the launches
        of the window's forward call are kept in ``forward_launches``."""
        f_in = f.detach().requires_grad_(True)
        before = counters() if counters else None
        out, _ = self.window(f_in, f_in, *self.masks, self.omega)
        if counters:
            self.forward_launches = counter_delta(counters(), before)
        loss = torch.mean((out - self.target) ** 2)
        loss.backward()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            self.omega.clamp_(self.lo, self.hi)
        return out.detach(), loss.detach(), f_in.grad

    def first_gradient(self):
        """omega's gradient at the first step, from Adam's first moment."""
        state = self.opt.state[self.omega]
        return float(state["exp_avg"]) / (1.0 - self.opt.param_groups[0]["betas"][0])


def follow(trainer, f, n, counters=None):
    """The first ``n`` steps: {"loss": [...], "grad": first gradient of omega,
    "change": omega's change, "df0": the first step's gradient of f, "out1":
    the first step's window output}."""
    omega0 = float(trainer.omega.detach())
    rec = {"loss": []}
    for i in range(n):
        f, loss, df = trainer.step(f, counters if i == 0 else None)
        rec["loss"].append(float(loss))
        if i == 0:
            rec["grad"], rec["df0"], rec["out1"] = trainer.first_gradient(), df, f
    rec["change"] = float(trainer.omega.detach()) - omega0
    return f, rec


def run(ctx):
    p, cfg, system = ctx.traffic, ctx.cfg, ctx.system
    shape = tuple(cfg["shape"])
    boundaries = ctx.config.boundaries(cfg)
    with ctx.span("setup.scene"):
        stepper, bc_mask, missing = system.scene(ctx.config, cfg, boundaries, p["policy"])
    f, target = fields(ctx, system.device)
    trainer = Trainer(system.window(stepper, p["steps"]), (bc_mask, missing), target, p, system.device)
    before = system.counters()
    with ctx.span("setup.first_window"):
        f, first = follow(trainer, f, 1, system.counters)
    launches = counter_delta(system.counters(), before)
    f, rest = follow(trainer, f, int(p["checked"]) - 1)
    record = dict(first, loss=first["loss"] + rest["loss"], change=first["change"] + rest["change"])

    trace_from, trace_to = 1, 1 + int(p["trace_iterations"]) if ctx.trace else 0
    traced, previous, i = None, None, 0
    t0 = ctx.start_window()
    while True:
        if i == trace_from and ctx.trace:
            from lbm_bench.trace import profiled

            tracing = profiled(system.sync)
            traced = tracing.__enter__()
        f, _, _ = trainer.step(f)
        marker = system.event()
        if previous is not None:
            previous.synchronize()
        previous = marker
        i += 1
        if i == trace_to and ctx.trace:
            tracing.__exit__(None, None, None)
        if time.perf_counter() - t0 >= ctx.seconds and i >= trace_to:
            break
    system.sync()
    elapsed = time.perf_counter() - t0
    voxels = 1
    for s in shape:
        voxels *= s
    measured = {
        "end_to_end": {"train_mlups": voxels * p["steps"] * i / elapsed / 1e6},
        "attempted": i,
        "first_step_at": t0,
        "launches": launches,
        "sizes": sizes(cfg, p, boundaries, trainer.forward_launches),
        "trace": traced.trace if traced is not None else None,
    }
    return measured, {"record": record, "shape": shape, "boundaries": boundaries}


def check(ctx, m):
    """The numbers the cell's limits hold, against the reference's own
    first steps."""
    p, rec, ref, cfg = ctx.traffic, m["record"], ctx.reference, ctx.cfg
    device = rec["df0"].device
    lat = ref.Lattice(m["shape"], m["boundaries"], device, cfg["velocity_set"], cfg["collision"])
    f, target = fields(ctx, device)

    def window(f_in, _f, omega):
        out = ref.steps_autograd(lat, f_in, int(p["steps"]), omega)
        return out, out

    _, want = follow(Trainer(window, (), target, p, device), f, int(p["checked"]))
    return compare(rec, want)


def compare(got, want):
    """{"loss_gap": the largest relative gap of a step's loss, "grad_gap":
    of omega's first gradient, "change_gap": of omega's change (both signed:
    a gradient or a step of the wrong sign reads about 2), "df0_rel_l2":
    ||df0 - df0_ref|| / ||df0_ref||, "out1_max_abs": the largest gap of the
    first window's output}."""
    d = got["df0"].float() - want["df0"]
    out1 = torch.zeros((), device=d.device)
    for a, b in zip(got["out1"], want["out1"]):
        out1 = torch.maximum(out1, (a.float() - b).abs().max())  # NaN stays NaN
    return {
        "out1_max_abs": float(out1),
        "loss_gap": float(torch.tensor([abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])]).max()),
        "grad_gap": abs(got["grad"] - want["grad"]) / abs(want["grad"]),
        "change_gap": abs(got["change"] - want["change"]) / abs(want["change"]),
        "df0_rel_l2": float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(want["df0"])),
    }
