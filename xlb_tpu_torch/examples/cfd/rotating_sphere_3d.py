"""Flow past a rotating sphere, the port of ``examples/cfd/rotating_sphere_3d.py``.

    python -m xlb_tpu_torch.examples.cfd.rotating_sphere_3d [--nx 96] [--nyz 48] [--steps 600]
        [--collision KBC|BGK] [--backend cuda|torch]

D3Q27 KBC (D3Q19 BGK selectable); an EquilibriumBC inlet, an
ExtrapolationOutflowBC outlet, fullway walls, and halfway bounce-back on
the voxelized sphere with the rotational wall velocity u_wall = Omega x
(x - c) as a ``profile(coords)`` (the aux field's velocity channels on
the CUDA tier). Windows of 100 steps, the first a warm-up; prints MLUPS,
then the Magnus asymmetry of u_x above and below the sphere.
``--backend cuda`` (the default) runs ``build_multi_step`` on the CUDA
tier; ``torch`` the TORCH tier.
"""

import argparse
import time

import numpy as np
import torch


def build(nx=96, nyz=48, re=100.0, u_in=0.03, rot_rate=0.005, collision="KBC", backend="cuda", device="cuda"):
    """The scene through the public API: (stepper, prepare_fields(), omega, centre, radius)."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary import EquilibriumBC, ExtrapolationOutflowBC, FullwayBounceBackBC, HalfwayBounceBackBC
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.geometry import solid_voxel_indices, sphere_triangles, voxelize
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.utils import omega_from_reynolds
    from xlb_tpu_torch.velocity_set import D3Q19, D3Q27

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D3Q27() if collision == "KBC" else D3Q19(),
             default_backend=xlb.ComputeBackend[backend.upper()],
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)
    grid = xlb.grid_factory((nx, nyz, nyz), device=device)
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)

    center = np.array([nx / 4, nyz / 2, nyz / 2])
    radius = nyz / 8
    sphere_idx = solid_voxel_indices(voxelize(sphere_triangles(center=center, radius=radius, subdivisions=3), grid.shape))

    def rotation_profile(coords):
        # u_wall = Omega x (x - c), spinning about the z axis
        r = coords - center[:, None]
        return np.cross(np.array([0.0, 0.0, rot_rate])[None, :], r.T).T

    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back")], axis=1), axis=1)
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(u_in, 0.0, 0.0), indices=box_ne["left"]),
        ExtrapolationOutflowBC(indices=box_ne["right"]),
        HalfwayBounceBackBC(indices=sphere_idx.tolist(), profile=rotation_profile),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type=collision)
    return stepper, stepper.prepare_fields(), omega_from_reynolds(re, u_in, 2 * radius), center, radius


def magnus_asymmetry(u, center, radius, nyz):
    """u_x above minus u_x below the sphere (the rotation breaks the
    symmetry), from the velocity field u (3, *shape)."""
    iy_hi, iy_lo, ix = int(center[1] + radius + 2), int(center[1] - radius - 2), int(center[0])
    return float(u[0, ix, iy_hi, nyz // 2] - u[0, ix, iy_lo, nyz // 2])


def run(nx=96, nyz=48, re=100.0, u_in=0.03, rot_rate=0.005, num_steps=600, collision="KBC", backend="cuda",
        device="cuda", return_velocity=False):
    """Run the scene in windows of 100 steps and return the Magnus
    asymmetry, as the reference's ``run`` (with ``return_velocity``, also
    the final velocity field (3, *shape), float64 NumPy)."""
    from xlb_tpu_torch.ops.macroscopic import density, velocity

    stepper, (f_0, f_1, bc_mask, missing_mask), omega, center, radius = build(
        nx, nyz, re, u_in, rot_rate, collision, backend, device)
    sync = torch.cuda.synchronize if f_0.device.type == "cuda" else (lambda: None)
    chunk = min(100, num_steps)
    run_window = stepper.build_multi_step(chunk)
    f_0, f_1 = run_window(f_0, f_1, bc_mask, missing_mask, omega)  # warm-up
    sync()
    done, t0 = chunk, time.perf_counter()
    while done + chunk <= num_steps:
        f_0, f_1 = run_window(f_0, f_1, bc_mask, missing_mask, omega)
        done += chunk
    sync()
    dt = time.perf_counter() - t0
    if done > chunk:
        mlups = nx * nyz * nyz * (done - chunk) / dt / 1e6
        print(f"rotating sphere [{backend}]: {mlups:.1f} MLUPS ({done} steps, {nx}x{nyz}x{nyz})")

    f = f_0.float()
    u = velocity(f, density(f), stepper.velocity_set._c).double().cpu().numpy()
    fluid = bc_mask[0].cpu().numpy() != 255  # u is 0/0 inside the solid sphere
    u_fluid = np.where(fluid[None], u, 0.0)
    asym = magnus_asymmetry(u, center, radius, nyz)
    print(f"rotating sphere [{backend}]: max|u| (fluid)={np.abs(u_fluid).max():.4f}, "
          f"u_x asymmetry (Magnus) = {asym:+.5f}, finite={np.isfinite(u_fluid).all()}")
    return (asym, u) if return_velocity else asym


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=96)
    p.add_argument("--nyz", type=int, default=48)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--collision", default="KBC", choices=["BGK", "KBC"])
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    args = p.parse_args()
    run(nx=args.nx, nyz=args.nyz, num_steps=args.steps, collision=args.collision, backend=args.backend)
