"""3D MLUPS benchmark, the port of ``examples/performance/mlups_3d.py``.

    python -m xlb_tpu_torch.examples.performance.mlups_3d [cube_edge] [num_steps] [--backend torch|cuda]
        [--velocity-set D3Q19|D3Q27] [--collision BGK|KBC|...] [--window] [--temporal-steps K]
        [--kernel dma|blocked] [--tile TX TY TZ]

The 3D lid-driven cavity (fullway walls, an equilibrium lid u = (0.02,
0, 0), omega 1.9) for a (velocity set, collision) pair. ``--backend cuda``
(the default) runs the fused step once per step, or with ``--window`` the
fused window (``build_fused_window``: with ``--kernel dma`` groups of
``--temporal-steps`` steps through K2, 2 by default, 1 for K1 alone; with
``--kernel blocked`` K0 on ``--tile``'s box); ``torch`` runs TORCH-tier
steps. ``warmup`` windows, then the best of ``reps``, host clock around
work that ends in a synchronize; MLUPS = edge^3 x num_steps / s / 1e6.
"""

import argparse

import numpy as np

from xlb_tpu_torch.examples.performance.mlups_2d import make_window, time_windows


def benchmark(cube_edge, num_steps, backend_tier, velocity_set_name, collision, precision, warmup, reps, tile=None,
              window=False, temporal_steps=None, kernel="dma", device="cuda"):
    """MLUPS of the 3D cavity at cube_edge^3 (see the module docstring)."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch import velocity_set as vsets
    from xlb_tpu_torch.boundary import EquilibriumBC, FullwayBounceBackBC
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=getattr(vsets, velocity_set_name)(), default_backend=xlb.ComputeBackend.TORCH,
             default_precision_policy=xlb.PrecisionPolicy[precision])
    n = cube_edge
    grid = xlb.grid_factory((n, n, n), device=device)
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1
    )
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(0.02, 0.0, 0.0), indices=box_ne["top"]),
    ]
    # PowerLawBGK needs a consistency; mildly shear-thinning defaults for benching
    params = {"consistency": 0.05, "power_index": 0.8} if collision == "PowerLawBGK" else None
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type=collision,
                                                collision_params=params)
    fields = stepper.prepare_fields()

    if backend_tier == "cuda" and window:
        run_window = make_window(stepper, num_steps, "cuda", temporal_steps=temporal_steps, kernel=kernel, tile=tile)
    elif backend_tier == "cuda":
        from xlb_tpu_torch.kernels.fused_step import build_fused_step

        step = build_fused_step(stepper, kernel=kernel, tile=tile)

        def run_window(f_0, f_1, bc_mask, missing_mask, omega):
            for i in range(num_steps):
                f_0, f_1 = step(f_0, f_1, bc_mask, missing_mask, omega, i)
                f_0, f_1 = f_1, f_0
            return f_0, f_1
    else:
        run_window = make_window(stepper, num_steps, backend_tier)

    best, _ = time_windows(run_window, fields, 1.9, warmup, reps)
    mlups = n**3 * num_steps / best / 1e6
    mode = "window" if (backend_tier == "cuda" and window) else "per-step"
    print(f"{velocity_set_name} {collision} {precision} tier={backend_tier} ({mode}, kernel={kernel}) {n}^3 on "
          f"{grid.device}: {mlups:.1f} MLUPS ({best / num_steps * 1e3:.3f} ms/step, {reps} reps)")
    return mlups


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="3D lid-driven cavity MLUPS benchmark")
    p.add_argument("cube_edge", type=int, nargs="?", default=256)
    p.add_argument("num_steps", type=int, nargs="?", default=50)
    p.add_argument("--backend", choices=["torch", "cuda"], default="cuda")
    p.add_argument("--velocity-set", choices=["D3Q19", "D3Q27"], default="D3Q19")
    p.add_argument("--collision", choices=["BGK", "KBC", "SmagorinskyLESBGK", "TRT", "MRT", "PowerLawBGK"],
                   default="BGK")
    p.add_argument("--precision", default="FP32FP32")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--kernel", choices=["dma", "blocked"], default="dma",
                   help="dma: K1 (and K2 in windows); blocked: K0, one launch per step")
    p.add_argument("--tile", type=int, nargs=3, default=None, help="(TX, TY, TZ) box of --kernel blocked")
    p.add_argument("--window", action="store_true", help="run the fused window (k-step groups, shifted storage)")
    p.add_argument("--temporal-steps", type=int, default=None, help="LBM steps per pass in --window mode (default 2)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    benchmark(args.cube_edge, args.num_steps, args.backend, args.velocity_set, args.collision, args.precision,
              args.warmup, args.reps, tuple(args.tile) if args.tile else None, window=args.window,
              temporal_steps=args.temporal_steps, kernel=args.kernel, device=args.device)
