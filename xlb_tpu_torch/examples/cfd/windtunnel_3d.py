"""3D wind tunnel with a drag readout, the port of ``examples/cfd/windtunnel_3d.py``.

    python -m xlb_tpu_torch.examples.cfd.windtunnel_3d [--nx 96] [--nyz 48] [--steps 1000] [--stl FILE]
        [--backend cuda|torch]

D3Q27 KBC; an EquilibriumBC inlet, an ExtrapolationOutflowBC outlet,
fullway walls, halfway bounce-back on the voxelized object (a sphere, or
an STL mesh scaled into the tunnel) or, with ``--object-bc hybrid``, a
HybridBC (Tao's closure with regularization, ``nonequilibrium_regularized``,
and the mesh's wall distances), and the drag and lift coefficients from
``MomentumTransfer`` after every ``print_every`` steps. ``--backend cuda``
(the default) runs ``build_multi_step(print_every)`` windows on the CUDA
tier; ``torch`` the TORCH tier.
"""

import argparse

import numpy as np


def build(nx=96, nyz=48, re=200.0, u_in=0.04, stl=None, backend="cuda", object_bc="halfway", precision="FP32FP32",
          device="cuda"):
    """(stepper, prepare_fields(), omega, the object's BC, its size) of the
    tunnel through the public API."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch import boundary
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.geometry import load_stl, sphere_triangles, transform_mesh
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.utils import omega_from_reynolds
    from xlb_tpu_torch.velocity_set import D3Q27

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D3Q27(), default_backend=xlb.ComputeBackend[backend.upper()],
             default_precision_policy=xlb.PrecisionPolicy[precision])
    grid = xlb.grid_factory((nx, nyz, nyz), device=device)
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)

    if stl:
        tris = load_stl(stl)
        # normalize into the tunnel: centre at (nx/4, nyz/2, nyz/2), size nyz/3
        lo, hi = tris.min(axis=(0, 1)), tris.max(axis=(0, 1))
        scale = (nyz / 3.0) / max(hi - lo)
        tris = transform_mesh(tris, scale=scale, translation=np.array([nx / 4, nyz / 2, nyz / 2]) - scale * (lo + hi) / 2)
        size = float(max(hi - lo)) * scale
    else:
        size = nyz / 4
        tris = sphere_triangles(center=(nx / 4, nyz / 2, nyz / 2), radius=size / 2, subdivisions=3)

    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back")], axis=1), axis=1)
    bc_walls = boundary.FullwayBounceBackBC(indices=walls.tolist())
    bc_inlet = boundary.EquilibriumBC(rho=1.0, u=(u_in, 0.0, 0.0), indices=box_ne["left"])
    bc_outlet = boundary.ExtrapolationOutflowBC(indices=box_ne["right"])
    if object_bc == "hybrid":
        bc_object = boundary.HybridBC(bc_method="nonequilibrium_regularized", mesh_vertices=tris)
    else:
        bc_object = boundary.HalfwayBounceBackBC(mesh_vertices=tris)
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=[bc_walls, bc_inlet, bc_outlet, bc_object],
                                                collision_type="KBC")
    return stepper, stepper.prepare_fields(), omega_from_reynolds(re, u_in, size), bc_object, size


def run(nx=96, nyz=48, re=200.0, u_in=0.04, num_steps=1000, stl=None, print_every=200, backend="cuda",
        object_bc="halfway", device="cuda"):
    """Run the tunnel and return the drag coefficient after each window,
    as the reference's ``run``."""
    from xlb_tpu_torch.ops import MomentumTransfer
    from xlb_tpu_torch.ops.macroscopic import density, velocity

    stepper, (f_0, f_1, bc_mask, missing_mask), omega, bc_object, size = build(
        nx, nyz, re, u_in, stl, backend, object_bc, device=device)
    momentum_transfer = MomentumTransfer(bc_object)
    window = print_every or num_steps
    run_window = stepper.build_multi_step(window)
    drag_history = []
    for start in range(0, num_steps, window):
        f_0, f_1 = run_window(f_0, f_1, bc_mask, missing_mask, omega, start)
        if print_every:
            force = momentum_transfer(f_0, f_1, bc_mask, missing_mask).double().cpu().numpy()
            area = np.pi * (size / 2) ** 2
            cd = force[0] / (0.5 * u_in**2 * area)
            cl = force[2] / (0.5 * u_in**2 * area)
            drag_history.append(float(cd))
            print(f"step {start + window}: drag force={force[0]:.5e}, Cd={cd:.3f}, Cl={cl:.3f}")
    f = f_0.float()
    u = velocity(f, density(f), stepper.velocity_set._c)
    print(f"windtunnel [{backend}] done: max|u|={float(u.abs().max()):.4f}")
    return drag_history


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=96)
    p.add_argument("--nyz", type=int, default=48)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--stl", type=str, default=None)
    p.add_argument("--backend", choices=["cuda", "torch"], default="cuda")
    p.add_argument("--object-bc", choices=["halfway", "hybrid"], default="halfway")
    args = p.parse_args()
    run(nx=args.nx, nyz=args.nyz, num_steps=args.steps, stl=args.stl, backend=args.backend, object_bc=args.object_bc)
