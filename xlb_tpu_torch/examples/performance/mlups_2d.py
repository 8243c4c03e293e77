"""2D MLUPS benchmark, the port of ``examples/performance/mlups_2d.py``.

    python -m xlb_tpu_torch.examples.performance.mlups_2d [edge] [num_steps] [--backend torch|cuda]

The 2D lid-driven cavity, D2Q9, BGK, omega 1.6: fullway walls, an
equilibrium lid u = (0.02, 0). ``--backend cuda`` (the default) runs the
fused window (``kernels.fused_step.build_fused_window``: K4 at k =
``--temporal-steps``, 8 by default, K3 for the remainder); ``torch`` runs
``num_steps`` TORCH-tier steps. One window per dispatch: ``warmup``
windows, then the best of ``reps``, host clock around work that ends in a
synchronize; MLUPS = edge^2 x num_steps / s / 1e6.
"""

import argparse
import time

import numpy as np
import torch


def make_window(stepper, num_steps, backend_tier, **fused):
    """``run(f_0, f_1, bc_mask, missing_mask, omega) -> (f_0, f_1)`` of
    ``num_steps`` steps: the fused window ("cuda", ``fused`` passed on to
    ``build_fused_window``) or a loop of TORCH-tier steps ("torch")."""
    if backend_tier == "cuda":
        from xlb_tpu_torch.kernels.fused_step import build_fused_window

        return build_fused_window(stepper, num_steps, **fused)
    if backend_tier != "torch":
        raise ValueError(f"backend must be 'torch' or 'cuda', got {backend_tier!r}")

    def run_window(f_0, f_1, bc_mask, missing_mask, omega):
        for i in range(num_steps):
            f_0, f_1 = stepper(f_0, f_1, bc_mask, missing_mask, omega, i)
            f_0, f_1 = f_1, f_0
        return f_0, f_1

    return run_window


def time_windows(run_window, fields, omega, warmup, reps):
    """``warmup`` windows (at least one), then the best of ``reps`` on the
    host clock around work that ends in a synchronize. Returns (seconds,
    (f_0, f_1) after the last window)."""
    f_0, f_1, bc_mask, missing_mask = fields
    cuda = f_0.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(f_0.device)

    for _ in range(max(1, warmup)):
        f_0, f_1 = run_window(f_0, f_1, bc_mask, missing_mask, omega)
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        f_0, f_1 = run_window(f_0, f_1, bc_mask, missing_mask, omega)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best, (f_0, f_1)


def benchmark(n, num_steps, backend_tier, precision, warmup, reps, temporal_steps=None, device="cuda"):
    """MLUPS of the 2D cavity at n^2 (see the module docstring)."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary import EquilibriumBC, FullwayBounceBackBC
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.velocity_set import D2Q9

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D2Q9(), default_backend=xlb.ComputeBackend.TORCH,
             default_precision_policy=xlb.PrecisionPolicy[precision])
    grid = xlb.grid_factory((n, n), device=device)
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right")], axis=1), axis=1)
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(0.02, 0.0), indices=box_ne["top"]),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    fields = stepper.prepare_fields()
    fused = {} if backend_tier == "torch" else {"temporal_steps": temporal_steps}
    best, _ = time_windows(make_window(stepper, num_steps, backend_tier, **fused), fields, 1.6, warmup, reps)
    mlups = n * n * num_steps / best / 1e6
    print(f"D2Q9 BGK {precision} tier={backend_tier} {n}^2 on {grid.device}: "
          f"{mlups:.1f} MLUPS ({best / num_steps * 1e3:.3f} ms/step, {reps} reps)")
    return mlups


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="2D lid-driven cavity MLUPS benchmark")
    p.add_argument("edge", type=int, nargs="?", default=2048)
    p.add_argument("num_steps", type=int, nargs="?", default=500)
    p.add_argument("--backend", choices=["torch", "cuda"], default="cuda")
    p.add_argument("--precision", default="FP32FP32")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--temporal-steps", type=int, default=None, help="LBM steps per fetch of K4 (default 8)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    benchmark(args.edge, args.num_steps, args.backend, args.precision, args.warmup, args.reps, args.temporal_steps,
              args.device)
