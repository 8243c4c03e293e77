"""3D flow past a sphere, the port of ``examples/cfd/flow_past_sphere_3d.py``.

    python -m xlb_tpu_torch.examples.cfd.flow_past_sphere_3d [--nx 96] [--nyz 48] [--steps 1000]
        [--inlet parabolic|uniform] [--backend cuda|torch]

D3Q19 BGK; a RegularizedBC velocity inlet (the parabolic profile u_max (1 -
r^2) through the aux field, or uniform), an ExtrapolationOutflowBC outlet,
halfway bounce-back on the channel walls and on the mesh-voxelized sphere.
``--backend cuda`` (the default) runs ``build_multi_step(steps)`` on the
CUDA tier (K2 at k = 2, K1 for the remainder); ``torch`` the TORCH tier.
"""

import argparse

import numpy as np


def build(nx=96, nyz=48, re=100.0, u_in=0.04, inlet="parabolic", backend="cuda", precision="FP32FP32",
          device="cuda"):
    """The scene through the public API: (stepper, prepare_fields(), omega)."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.boundary import ExtrapolationOutflowBC, HalfwayBounceBackBC, RegularizedBC
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.geometry import sphere_triangles
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.utils import omega_from_reynolds
    from xlb_tpu_torch.velocity_set import D3Q19

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend[backend.upper()],
             default_precision_policy=xlb.PrecisionPolicy[precision])
    grid = xlb.grid_factory((nx, nyz, nyz), device=device)
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)

    sphere_r = nyz // 8
    sphere = sphere_triangles(center=(nx / 4, nyz / 2, nyz / 2), radius=sphere_r, subdivisions=3)
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back")], axis=1), axis=1)
    bc_walls = HalfwayBounceBackBC(indices=walls.tolist())
    if inlet == "parabolic":
        # per-voxel parabolic profile u = u_max (1 - r^2): the aux field's velocity channels
        prescribed = inlet_profile(nyz, u_in)
        bc_inlet = RegularizedBC("velocity", profile=lambda: prescribed, indices=box_ne["left"])
    else:
        bc_inlet = RegularizedBC("velocity", prescribed_value=(u_in, 0.0, 0.0), indices=box_ne["left"])
    bc_outlet = ExtrapolationOutflowBC(indices=box_ne["right"])
    bc_sphere = HalfwayBounceBackBC(mesh_vertices=sphere)
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=[bc_walls, bc_inlet, bc_outlet, bc_sphere])
    return stepper, stepper.prepare_fields(), omega_from_reynolds(re, u_in, 2 * sphere_r)


def inlet_profile(nyz, u_in):
    """The parabolic inlet (3, 1, nyz, nyz): u_x = u_in max(0, 1 - r^2) over
    the face, r the distance from its centre in units of its half-width."""
    yz = (np.arange(nyz) + 0.5) / nyz - 0.5
    ry, rz = np.meshgrid(2.0 * yz, 2.0 * yz, indexing="ij")
    prescribed = np.zeros((3, 1, nyz, nyz))
    prescribed[0, 0] = u_in * np.maximum(0.0, 1.0 - ry**2 - rz**2)
    return prescribed


def velocity(f):
    """The velocity field (3, *shape) of populations f, float64 NumPy."""
    from xlb_tpu_torch.ops.macroscopic import density, velocity as velocity_of
    from xlb_tpu_torch.velocity_set import D3Q19

    f = f.float()
    return velocity_of(f, density(f), D3Q19()._c).double().cpu().numpy()


def run(nx=96, nyz=48, re=100.0, u_in=0.04, num_steps=1000, inlet="parabolic", backend="cuda", device="cuda"):
    """Run ``num_steps`` steps in one window and return the velocity field
    (3, nx, nyz, nyz), as the reference's ``run``."""
    stepper, (f_0, f_1, bc_mask, missing_mask), omega = build(nx, nyz, re, u_in, inlet, backend, device=device)
    f_0, f_1 = stepper.build_multi_step(num_steps)(f_0, f_1, bc_mask, missing_mask, omega)
    u = velocity(f_0)
    print(f"flow past sphere [{backend}]: inflow={u_in}, max|u|={np.abs(u).max():.4f}, "
          f"wake u_x={u[0, nx // 2, nyz // 2, nyz // 2]:.4f}, finite={np.isfinite(u).all()}")
    return u


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=96)
    p.add_argument("--nyz", type=int, default=48)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--inlet", choices=["parabolic", "uniform"], default="parabolic")
    p.add_argument("--backend", choices=["cuda", "torch"], default="cuda")
    args = p.parse_args()
    run(nx=args.nx, nyz=args.nyz, num_steps=args.steps, inlet=args.inlet, backend=args.backend)
