"""2D Rayleigh-Benard convection, the port of ``examples/cfd/rayleigh_benard_2d.py``.

    python -m xlb_tpu_torch.examples.cfd.rayleigh_benard_2d [--nx 128] [--ny 64] [--ra 5e4]
        [--steps 4000] [--obstacle] [--backend cuda|torch]

Boussinesq-coupled NSE + advection-diffusion (``models/ade.py``): a fluid
layer heated from below (Dirichlet phi = 1) and cooled from above (phi =
0), halfway no-slip walls, periodic sides; ``--obstacle`` adds an
adiabatic halfway cylinder at the centre. Above the critical Rayleigh
number (~1708) convection rolls form and the Nusselt number rises above
1; it is printed after each window of 500 coupled steps.
``--backend cuda`` (the default) runs the CUDA tier (per coupled step one
launch of K3's forced mode and one of its advection-diffusion mode),
``torch`` the TORCH tier.
"""

import argparse

import numpy as np


def build(nx=128, ny=64, rayleigh=5e4, prandtl=0.71, beta=5e-4, backend="cuda", obstacle=False, device="cuda",
          precision="FP32FP32"):
    """The scene through the public API: (thermal stepper, its fields
    (f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g), omega, omega_phi,
    the diffusivity D, L)."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary import EquilibriumBC, HalfwayBounceBackBC
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.models import (AdvectionDiffusionStepper, IncompressibleNavierStokesStepper, ThermalNSEStepper,
                                      omega_from_diffusivity)
    from xlb_tpu_torch.velocity_set import D2Q9

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D2Q9(), default_backend=xlb.ComputeBackend[backend.upper()],
             default_precision_policy=xlb.PrecisionPolicy[precision])
    grid = xlb.grid_factory((nx, ny), device=device)
    box = grid.bounding_box_indices()

    # lattice parameters from (Ra, Pr): Ra = beta g dT L^3 / (nu D), Pr = nu / D
    L, dT, g_mag = ny - 2, 1.0, 1.0
    nu = np.sqrt(prandtl * beta * g_mag * dT * L**3 / rayleigh)
    D = nu / prandtl
    omega = 1.0 / (3.0 * nu + 0.5)
    omega_phi = omega_from_diffusivity(D)
    print(f"Ra={rayleigh:.0f} Pr={prandtl}: nu={nu:.4f} (omega={omega:.3f}), D={D:.4f} (omega_phi={omega_phi:.3f})")

    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top")], axis=1), axis=1)
    nse_bcs = [HalfwayBounceBackBC(indices=walls.tolist())]
    ade_bcs = [
        EquilibriumBC(rho=1.0, u=(0.0, 0.0), indices=box["bottom"]),  # hot floor
        EquilibriumBC(rho=0.0, u=(0.0, 0.0), indices=box["top"]),  # cold ceiling
    ]
    if obstacle:
        # an adiabatic cylinder at the centre: no-slip for the flow, zero
        # flux (reflection) for the scalar
        r = ny / 8
        ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        circ_idx = np.stack(np.nonzero((ii - nx / 2) ** 2 + (jj - ny / 2) ** 2 <= r**2))
        nse_bcs.append(HalfwayBounceBackBC(indices=circ_idx.tolist()))
        ade_bcs.append(HalfwayBounceBackBC(indices=circ_idx.tolist()))
    nse = IncompressibleNavierStokesStepper(grid, boundary_conditions=nse_bcs)
    ade = AdvectionDiffusionStepper(grid, boundary_conditions=ade_bcs)
    thermal = ThermalNSEStepper(nse, ade, beta=beta, gravity=(0.0, -g_mag))

    f_0, f_1, bc_f, miss_f = nse.prepare_fields()
    yy = np.broadcast_to((np.arange(ny) / (ny - 1.0))[None, :], (nx, ny))
    xx = np.broadcast_to((np.arange(nx) / nx)[:, None], (nx, ny))
    phi0 = (1.0 - yy) + 0.01 * np.sin(2 * np.pi * 3 * xx) * np.sin(np.pi * yy)
    g_0, g_1, bc_g, miss_g = ade.prepare_fields(phi_init=phi0.astype(np.float32))
    return thermal, (f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g), omega, omega_phi, D, L


def nusselt(thermal, f_0, g_0, D, L, dT=1.0):
    """(Nu, max|u|, u_y finite): 1 + <u_y phi> / (D dT / L) over the rows
    between the walls, in NumPy float32 as the reference computes it."""
    from xlb_tpu_torch.ops.macroscopic import density, velocity

    f = f_0.float()
    u = velocity(f, density(f), thermal.nse.velocity_set._c).cpu().numpy()
    phi_np = thermal.ade.phi(g_0)[0].cpu().numpy()
    uy = u[1]
    conv = float((uy[:, 1:-1] * phi_np[:, 1:-1]).mean())
    return 1.0 + conv / (D * dT / L), float(np.abs(u).max()), bool(np.isfinite(uy).all())


def run(nx=128, ny=64, rayleigh=5e4, prandtl=0.71, num_steps=4000, window=500, beta=5e-4, backend="cuda",
        obstacle=False, device="cuda"):
    """Run the scene in windows of ``window`` coupled steps and return the
    Nusselt number after each, as the reference's ``run``."""
    thermal, state, omega, omega_phi, D, L = build(nx, ny, rayleigh, prandtl, beta, backend, obstacle, device)
    f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g = state
    step_window = thermal.build_multi_step(window)
    nusselts = []
    for start in range(0, num_steps, window):
        f_0, f_1, g_0, g_1 = step_window(f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g, omega, omega_phi, start)
        nu_number, umax, finite = nusselt(thermal, f_0, g_0, D, L)
        nusselts.append(nu_number)
        print(f"  step {start + window}: max|u|={umax:.4f}  Nu={nu_number:.3f}")
        assert finite, "velocity field blew up"
    return np.asarray(nusselts)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=128)
    p.add_argument("--ny", type=int, default=64)
    p.add_argument("--ra", type=float, default=5e4)
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--backend", choices=["cuda", "torch"], default="cuda")
    p.add_argument("--obstacle", action="store_true", help="an adiabatic cylinder in the cavity")
    a = p.parse_args()
    run(nx=a.nx, ny=a.ny, rayleigh=a.ra, num_steps=a.steps, backend=a.backend, obstacle=a.obstacle)
