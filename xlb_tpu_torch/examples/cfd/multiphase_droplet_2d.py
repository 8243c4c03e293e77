"""Shan-Chen static droplets and the Laplace law, the port of
``examples/cfd/multiphase_droplet_2d.py``.

    python -m xlb_tpu_torch.examples.cfd.multiphase_droplet_2d [--n 96] [--steps 1200] [--backend cuda|torch]

Liquid droplets of several radii relax in vapour at G = -5
(``models/multiphase.py``); the pressure jump dp across the interface
follows dp = sigma / R in 2D, so the slope of dp against 1/R through the
origin is the surface tension. Prints per radius the measured R, dp, the
spurious-current level |u|max and the coexistence densities, then sigma
and the fit's residual. ``--backend cuda`` (the default) runs the CUDA
tier (K3's forced mode, one launch per step), ``torch`` the TORCH tier.
"""

import argparse

import numpy as np
import torch


def droplet(n, radius, nse, device):
    """Rest-state populations w_l rho(x) of a tanh droplet of ``radius``."""
    x = np.arange(n) - n / 2 + 0.5
    xx, yy = np.meshgrid(x, x, indexing="ij")
    r = np.sqrt(xx**2 + yy**2)
    rho0 = 0.16 + 0.5 * (1.9 - 0.16) * (1.0 - np.tanh((r - radius) / 2.0))
    w = np.asarray(nse.velocity_set._w, np.float32).reshape(-1, 1, 1)
    return torch.from_numpy((w * rho0[None]).astype(np.float32)).to(device)


def run(n=96, radii=(10.0, 14.0, 18.0), G=-5.0, num_steps=1200, backend="cuda", device="cuda"):
    """Relax one droplet per radius and fit the Laplace law; returns
    (sigma, residual, [(R, dp, |u|max, rho_min, rho_max) per radius]), as
    the reference's ``run``."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper, ShanChenMultiphaseStepper
    from xlb_tpu_torch.velocity_set import D2Q9

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D2Q9(), default_backend=xlb.ComputeBackend[backend.upper()],
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)
    results = []
    for radius in radii:
        grid = xlb.grid_factory((n, n), device=device)
        nse = IncompressibleNavierStokesStepper(grid, boundary_conditions=())
        sc = ShanChenMultiphaseStepper(nse, G=G)
        f_0 = droplet(n, radius, nse, grid.device)
        f_1 = torch.zeros_like(f_0)
        _, _, bc_mask, missing_mask = nse.prepare_fields()
        f_0, f_1 = sc.build_multi_step(num_steps)(f_0, f_1, bc_mask, missing_mask, 1.0)

        rho, u_true = sc.macroscopic(f_0)
        p = sc.pressure(rho)[0].cpu().numpy()
        rho_np = rho[0].cpu().numpy()
        dp = float(p[n // 2, n // 2] - p[2, 2])
        # the radius from the liquid area (rho above the mean of the phases)
        area = float((rho_np > 0.5 * (rho_np.max() + rho_np.min())).sum())
        r_meas = float(np.sqrt(area / np.pi))
        umax = float(torch.abs(u_true).max())
        results.append((r_meas, dp, umax, float(rho_np.min()), float(rho_np.max())))
        print(f"R={r_meas:6.2f}  dp={dp:.5f}  |u|max={umax:.4f}  rho=[{rho_np.min():.3f}, {rho_np.max():.3f}]")

    # Laplace fit: dp = sigma / R through the origin
    inv_r = np.array([1.0 / r for r, *_ in results])
    dps = np.array([dp for _, dp, *_ in results])
    sigma = float((inv_r @ dps) / (inv_r @ inv_r))
    resid = float(np.abs(dps - sigma * inv_r).max() / dps.max())
    print(f"surface tension sigma = {sigma:.5f} (Laplace fit residual {resid:.1%})")
    return sigma, resid, results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"))
    args = ap.parse_args()
    run(n=args.n, num_steps=args.steps, backend=args.backend)
