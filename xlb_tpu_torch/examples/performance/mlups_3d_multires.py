"""Multires MLUPS benchmark, the port of
``examples/performance/mlups_3d_multires.py``: weighted lattice updates per
second of a refined cavity.

    python -m xlb_tpu_torch.examples.performance.mlups_3d_multires [--coarse-edge 64] [--levels 2]
        [--box-frac 0.5] [--mres-perf-optimization fusion_at_finest]

Nested boxes of ``box_frac`` of their parent (8-cell multiples, centred)
over a coarse_edge^3 level, D3Q19 BGK, omega 1.6 at the finest level,
through ``MultiresSimulationManager.run(num_coarse_steps, window=...)``:
one warm-up window, then the best of ``reps``, host clock around work that
ends in a synchronize; weighted MLUPS = sum_l cells_l 2^(L-1-l) x steps /
s / 1e6. ``--mesh`` (a sharded run) is not ported yet.
"""

import argparse
import time

import torch

from xlb_tpu_torch.mres_perf_optimization_type import MresPerfOptimizationType


def build_grid(coarse_edge, box_frac, levels, device="cuda"):
    """The script's grid: nested boxes of ``box_frac`` of their parent
    (8-cell multiples), centred."""
    from xlb_tpu_torch.grid.multires import MultiresGrid

    shape = (coarse_edge,) * 3
    boxes, parent = [], shape
    for _ in range(levels - 1):
        extent = tuple(min(p, max(8, int(p * box_frac) // 8 * 8)) for p in parent)
        boxes.append((tuple((s - e) // 2 for s, e in zip(parent, extent)), extent))
        parent = tuple(2 * e for e in extent)
    return MultiresGrid(shape, boxes=boxes, device=device)


def run(coarse_edge=64, box_frac=0.5, levels=2, num_coarse_steps=20, reps=3, mres_perf="naive_collide_stream",
        precision="FP32FP32", mesh_shape=None, device="cuda"):
    """Weighted MLUPS of the refined cavity (see the module docstring)."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.helper import MultiresSimulationManager
    from xlb_tpu_torch.velocity_set import D3Q19

    if mesh_shape is not None and mesh_shape[0] * mesh_shape[1] > 1:
        raise NotImplementedError("a device mesh (multires over several cards) is not ported yet")
    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend.TORCH,
             default_precision_policy=getattr(xlb.PrecisionPolicy, precision))
    grid = build_grid(coarse_edge, box_frac, levels, device)
    strategy = MresPerfOptimizationType.from_string(mres_perf)
    sim = MultiresSimulationManager(grid, omega_finest=1.6, mres_perf_opt=strategy)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sim.run(num_coarse_steps, window=num_coarse_steps)  # warm-up
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        sim.run(num_coarse_steps, window=num_coarse_steps)
        sync()
        best = min(best, time.perf_counter() - t0)
    updates = grid.weighted_updates_per_coarse_step()
    mlups = updates * num_coarse_steps / best / 1e6
    print(f"multires {grid.num_levels} levels, coarse {coarse_edge}^3, {strategy.value}, {precision} on {device}: "
          f"{mlups:.1f} MLUPS ({updates / 1e6:.2f}M updates/coarse step)")
    return mlups


if __name__ == "__main__":
    parser = MresPerfOptimizationType.build_arg_parser(argparse.ArgumentParser())
    parser.add_argument("--coarse-edge", type=int, default=64)
    parser.add_argument("--box-frac", type=float, default=0.5,
                        help="refined-box edge as a fraction of the parent (1.0 = full-domain refinement)")
    parser.add_argument("--levels", type=int, default=2)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--precision", default="FP32FP32",
                        help="PrecisionPolicy name (FP32BF16 runs the deviation-form 16-bit kernels)")
    parser.add_argument("--mesh", type=int, nargs=2, default=None, metavar=("PX", "PY"),
                        help="device-mesh shape (multires over several cards: not ported yet)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    run(coarse_edge=args.coarse_edge, box_frac=args.box_frac, levels=args.levels, num_coarse_steps=args.steps,
        mres_perf=args.mres_perf_optimization, precision=args.precision, mesh_shape=args.mesh, device=args.device)
