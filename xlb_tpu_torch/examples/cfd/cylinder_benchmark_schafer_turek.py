"""Schafer-Turek 2D-2 cylinder benchmark (Cd_max, Cl_max, Strouhal), the
port of ``examples/cfd/cylinder_benchmark_schafer_turek.py``.

    python -m xlb_tpu_torch.examples.cfd.cylinder_benchmark_schafer_turek [--d 60] [--u-mean 0.035]
        [--cylinder-bc hybrid|staircase] [--hybrid-method bounceback] [--backend cuda|torch]

A channel of height 4.1 D and length 22 D, a cylinder of diameter D at
(2 D, 2 D), Re = U D / nu = 100 with a parabolic inlet of mean velocity U:
D2Q9 BGK, a RegularizedBC velocity inlet whose profile rides the aux field,
a RegularizedBC pressure outlet, halfway walls, and a HybridBC cylinder with
its exact per-link circle distances (``implicit_link_distances``); drag and
lift by momentum exchange after every step of the measured window. The
published intervals (Schafer & Turek 1996): Cd_max in [3.22, 3.24], Cl_max
in [0.99, 1.01], St in [0.295, 0.305].

``--backend cuda`` (the default) runs the transient in
``build_multi_step`` windows (K4 at k = 8) and the measured steps through
``stepper(...)`` (K3); ``torch`` runs the TORCH tier.
"""

import argparse

import numpy as np

INTERVALS = {"cd_max": (3.22, 3.24), "cl_max": (0.99, 1.01), "st": (0.295, 0.305)}


def geometry(d):
    """(nx, ny, centre x, centre y) of the channel and the cylinder in
    lattice units: halfway walls put the physical walls half a cell inside
    the outermost rows, so ny - 2 cells span 4.1 D."""
    return int(22.0 * d) + 1, int(4.1 * d) + 2, 2.0 * d, 2.0 * d + 0.5


def schafer_turek_bcs(grid, bnd, implicit_link_distances, d=60, u_mean=0.035, cylinder_bc="hybrid",
                      hybrid_method="bounceback"):
    """The benchmark's BCs on ``grid`` from a package's BC classes
    (``bnd``, its ``boundary`` module) and its ``implicit_link_distances``:
    [walls, inlet, outlet, cylinder]."""
    nx, ny, cx, cy = geometry(d)
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    X, Y = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    cyl_idx = np.array(np.nonzero((X - cx) ** 2 + (Y - cy) ** 2 <= (d / 2.0) ** 2))
    walls = np.unique(np.concatenate([np.asarray(box["bottom"]), np.asarray(box["top"])], axis=1), axis=1)

    # parabolic inlet u(y) = 4 u_max y (H - y) / H^2, u_max = 1.5 u_mean, y from the physical walls
    y_phys = np.arange(ny) - 0.5
    H = ny - 2.0
    prescribed = np.zeros((2, 1, ny))
    prescribed[0, 0] = np.clip(4.0 * 1.5 * u_mean * y_phys * (H - y_phys) / H**2, 0.0, None)

    if cylinder_bc == "staircase":
        bc_cyl = bnd.HalfwayBounceBackBC(indices=cyl_idx.tolist())
    else:
        bc_cyl = bnd.HybridBC(bc_method=hybrid_method, indices=cyl_idx.tolist())
        shell = bc_cyl.pad_indices()

        def inside(pts):
            return (pts[:, 0] - cx) ** 2 + (pts[:, 1] - cy) ** 2 <= (d / 2.0) ** 2

        bc_cyl.set_link_distances(shell, implicit_link_distances(inside, shell.astype(np.float64),
                                                                 bc_cyl.velocity_set._c))
    return [bnd.HalfwayBounceBackBC(indices=walls.tolist()),
            bnd.RegularizedBC("velocity", profile=lambda: prescribed, indices=box_ne["left"]),
            bnd.RegularizedBC("pressure", prescribed_value=1.0, indices=box_ne["right"]),
            bc_cyl]


def build(d=60, re=100.0, u_mean=0.035, collision="BGK", cylinder_bc="hybrid", hybrid_method="bounceback",
          backend="cuda", precision="FP32FP32", device="cuda"):
    """The scene through the public API: (stepper, prepare_fields(), omega,
    the cylinder's BC)."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch import boundary
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.geometry.distances import implicit_link_distances
    from xlb_tpu_torch.helper.initializers import CustomInitializer
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.velocity_set import D2Q9

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D2Q9(), default_backend=xlb.ComputeBackend[backend.upper()],
             default_precision_policy=xlb.PrecisionPolicy[precision])
    nx, ny, _, _ = geometry(d)
    grid = xlb.grid_factory((nx, ny), device=device)
    bcs = schafer_turek_bcs(grid, boundary, implicit_link_distances, d, u_mean, cylinder_bc, hybrid_method)
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type=collision)
    fields = stepper.prepare_fields(initializer=CustomInitializer(rho_0=1.0, u_0=(u_mean, 0.0)))
    nu = u_mean * d / re
    return stepper, fields, 1.0 / (3.0 * nu + 0.5), bcs[-1]


def period_steps(d, u_mean):
    """The nominal shedding period in steps (St ~ 0.3), which sets the run
    lengths."""
    return int(d / (0.3 * u_mean))


def force_history(stepper, fields, omega, momentum_transfer, n_steps):
    """``n_steps`` steps of ``stepper(...)``, the momentum-exchange force
    after each. Returns (the fields after them, forces (n_steps, 2) float64
    NumPy); the forces stay on the device until the end."""
    import torch

    f_0, f_1, bc_mask, missing_mask = fields
    forces = torch.empty((n_steps, 2), dtype=torch.float32, device=f_0.device)
    for t in range(n_steps):
        a, b = stepper(f_0, f_1, bc_mask, missing_mask, omega, t)
        f_0, f_1 = b, a
        forces[t] = momentum_transfer(f_0, f_1, bc_mask, missing_mask)
    return (f_0, f_1, bc_mask, missing_mask), forces.double().cpu().numpy()


def coefficients(forces, d, u_mean):
    """(Cd_max, Cl_max, St, Cd history, Cl history) of a force history."""
    coef = 2.0 / (u_mean**2 * d)  # rho = 1
    cd, cl = coef * forces[:, 0], coef * forces[:, 1]
    # Strouhal from the mean interval between rising zero crossings of Cl
    sgn = np.signbit(cl - cl.mean())
    rising = np.nonzero(sgn[:-1] & ~sgn[1:])[0]
    if len(rising) < 3:
        raise RuntimeError("no periodic lift signal: the shedding is not established")
    strouhal = d / (float(np.diff(rising).mean()) * u_mean)
    return float(cd.max()), float(cl.max()), strouhal, cd, cl


def run(d=60, re=100.0, u_mean=0.035, transient_periods=60, measure_periods=15, collision="BGK",
        cylinder_bc="hybrid", hybrid_method="bounceback", verbose=True, backend="cuda", device="cuda"):
    """Returns (cd_max, cl_max, strouhal) over the measured window, as the
    reference's ``run``."""
    from xlb_tpu_torch.ops import MomentumTransfer

    stepper, fields, omega, bc_cyl = build(d, re, u_mean, collision, cylinder_bc, hybrid_method, backend,
                                           device=device)
    period = period_steps(d, u_mean)
    chunk = 10 * period
    warm = stepper.build_multi_step(chunk)
    f_0, f_1, bc_mask, missing_mask = fields
    for _ in range(max(1, transient_periods * period // chunk)):
        f_0, f_1 = warm(f_0, f_1, bc_mask, missing_mask, omega)
    _, forces = force_history(stepper, (f_0, f_1, bc_mask, missing_mask), omega, MomentumTransfer(bc_cyl),
                              measure_periods * period)
    cd_max, cl_max, strouhal, _, _ = coefficients(forces, d, u_mean)
    if verbose:
        nx, ny, _, _ = geometry(d)
        print(f"Schafer-Turek 2D-2 [{backend}] (D={d}, {nx}x{ny}, Re={re}, {collision}, cylinder={cylinder_bc}):")
        print(f"  Cd_max = {cd_max:.4f}   (benchmark 3.2200 - 3.2400)")
        print(f"  Cl_max = {cl_max:.4f}   (benchmark 0.9900 - 1.0100)")
        print(f"  St     = {strouhal:.4f}   (benchmark 0.2950 - 0.3050)")
    return cd_max, cl_max, strouhal


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--d", type=int, default=60, help="cylinder diameter in lattice units")
    p.add_argument("--u-mean", type=float, default=0.035, help="mean inlet velocity (lattice units)")
    p.add_argument("--re", type=float, default=100.0)
    p.add_argument("--collision", default="BGK")
    p.add_argument("--cylinder-bc", default="hybrid", choices=["staircase", "hybrid"])
    p.add_argument("--hybrid-method", default="bounceback",
                   choices=["bounceback", "bounceback_regularized", "bounceback_grads", "nonequilibrium_regularized"])
    p.add_argument("--transient-periods", type=int, default=60)
    p.add_argument("--measure-periods", type=int, default=15)
    p.add_argument("--backend", choices=["cuda", "torch"], default="cuda")
    args = p.parse_args()
    run(d=args.d, re=args.re, u_mean=args.u_mean, collision=args.collision, cylinder_bc=args.cylinder_bc,
        hybrid_method=args.hybrid_method, transient_periods=args.transient_periods,
        measure_periods=args.measure_periods, backend=args.backend)
