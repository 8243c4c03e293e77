"""3D sphere drag validation on a broken STL, the port of
``examples/cfd/sphere_drag_validation.py``.

    python -m xlb_tpu_torch.examples.cfd.sphere_drag_validation [--d 24] [--re 100] [--u-in 0.05]
        [--t-star 60] [--sphere-bc hybrid|staircase] [--backend cuda|torch]

A wind tunnel (12 D, 6 D, 6 D) over the non-watertight sphere asset
``examples/cfd/data/sphere_nonwatertight.stl`` (open holes, duplicated
faces, flipped normals), voxelized with the WINDING method, centred 3.5 D
from the inlet: D3Q19 BGK, FreeSlipBC lateral walls, a RegularizedBC
velocity inlet and pressure (rho = 1) outlet, and a HybridBC
interpolated bounce-back sphere with ray-cast wall distances (links that
escape through a hole take the halfway value). The drag coefficient is the
mean momentum-exchange Cd over samples one window apart after t* = 60
(D / u_in units): the velocity inlet and the pressure outlet form a weakly
damped acoustic resonator, and windows of an irrational share of its period
sample its phase near-uniformly. Published steady drag at Re 100 (Johnson
& Patel 1999): Cd ~ 1.087; the blockage and the resolution put Cd in
[1.00, 1.18] at D = 24.

``--backend cuda`` (the default) runs ``build_multi_step`` windows on the
CUDA tier (K2 at k = 2, K1 for the remainder); ``torch`` the TORCH tier.
"""

import argparse
import pathlib

import numpy as np

ASSET = pathlib.Path(__file__).resolve().parents[3] / "examples" / "cfd" / "data" / "sphere_nonwatertight.stl"
CD_BAND = (1.00, 1.18)
CD_PUBLISHED = {100.0: 1.087, 200.0: 0.772, 300.0: 0.657}


def sphere_drag_bcs(grid, bnd, tris, voxelization_method, sphere_bc="hybrid", u_in=0.05):
    """The tunnel's BCs on ``grid`` from a package's BC classes (``bnd``)
    around the sphere ``tris`` (grid coordinates): four free-slip walls (the
    y faces own the y-z edge lines, the z faces are y-trimmed), the
    regularized inlet and outlet, the sphere last."""
    nx, nyz, _ = grid.shape
    box_ne = grid.bounding_box_indices(remove_edges=True)
    if sphere_bc == "staircase":
        bc_sphere = bnd.HalfwayBounceBackBC(mesh_vertices=tris, voxelization_method=voxelization_method)
    else:
        bc_sphere = bnd.HybridBC(bc_method="bounceback", mesh_vertices=tris, voxelization_method=voxelization_method)
    g = np.indices((nx, nyz, nyz))
    return [bnd.FreeSlipBC(indices=g[:, :, 0, :].reshape(3, -1).tolist(), normal=(0, -1, 0)),
            bnd.FreeSlipBC(indices=g[:, :, nyz - 1, :].reshape(3, -1).tolist(), normal=(0, 1, 0)),
            bnd.FreeSlipBC(indices=g[:, :, 1:nyz - 1, 0].reshape(3, -1).tolist(), normal=(0, 0, -1)),
            bnd.FreeSlipBC(indices=g[:, :, 1:nyz - 1, nyz - 1].reshape(3, -1).tolist(), normal=(0, 0, 1)),
            bnd.RegularizedBC("velocity", prescribed_value=(u_in, 0.0, 0.0), indices=box_ne["left"]),
            bnd.RegularizedBC("pressure", prescribed_value=1.0, indices=box_ne["right"]),
            bc_sphere]


def build(d=24, re=100.0, u_in=0.05, sphere_bc="hybrid", backend="cuda", precision="FP32FP32", device="cuda",
          timings=None):
    """The tunnel through the public API: (stepper, prepare_fields(), omega,
    the sphere's BC). ``timings``, a dict, receives the seconds of the
    setup's parts: "voxelize" (WINDING), "distances" (the wall distances'
    ray casts) and "masks" (the rest of prepare_fields)."""
    import time

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch import boundary
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.geometry import MeshVoxelizationMethod, assign_mesh_indices, load_stl, transform_mesh
    from xlb_tpu_torch.helper.initializers import CustomInitializer
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper
    from xlb_tpu_torch.velocity_set import D3Q19

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend[backend.upper()],
             default_precision_policy=xlb.PrecisionPolicy[precision])
    nx, nyz = 12 * d, 6 * d
    grid = xlb.grid_factory((nx, nyz, nyz), device=device)
    # the asset is a unit sphere at the origin: scale it to diameter d voxels
    tris = transform_mesh(load_stl(str(ASSET)), scale=d / 2.0, translation=np.array([3.5 * d, nyz / 2.0, nyz / 2.0]))
    bcs = sphere_drag_bcs(grid, boundary, tris, MeshVoxelizationMethod.WINDING, sphere_bc, u_in)
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    sphere = bcs[-1]
    t0 = time.perf_counter()
    # what prepare_fields does for a mesh BC, timed apart: it then takes the sphere's indices as they are
    assign_mesh_indices(sphere, grid)
    t1 = time.perf_counter()
    if sphere.needs_mesh_distance:
        sphere.compute_mesh_distances()
    t2 = time.perf_counter()
    fields = stepper.prepare_fields(initializer=CustomInitializer(rho_0=1.0, u_0=(u_in, 0.0, 0.0)))
    if timings is not None:
        timings.update(voxelize=t1 - t0, distances=t2 - t1, masks=time.perf_counter() - t2)
    return stepper, fields, 1.0 / (3.0 * (u_in * d / re) + 0.5), sphere


def run(d=24, re=100.0, u_in=0.05, t_star=60.0, backend="cuda", sphere_bc="hybrid", verbose=True, device="cuda"):
    """Returns the mean Cd over the sampled windows, as the reference's
    ``run``."""
    from xlb_tpu_torch.ops import MomentumTransfer

    stepper, (f_0, f_1, bc_mask, missing_mask), omega, sphere = build(d, re, u_in, sphere_bc, backend, device=device)
    mt = MomentumTransfer(sphere)
    nx = 12 * d
    num_steps = int(t_star * d / u_in)
    window = max(num_steps // 40, 1)
    run_window = stepper.build_multi_step(window)
    coef = 1.0 / (0.5 * u_in**2 * np.pi * (d / 2.0) ** 2)
    for start in range(0, num_steps, window):
        f_0, f_1 = run_window(f_0, f_1, bc_mask, missing_mask, omega)
        if verbose and ((start // window) % 8 == 7):
            print(f"t* = {(start + window) * u_in / d:6.1f}:  Cd = {coef * float(mt(f_0, f_1, bc_mask, missing_mask)[0]):.4f}")
    # the acoustic resonator's oscillation: sample the force one window apart over ~12 of its periods
    period = 2.0 * nx * np.sqrt(3.0)
    n_samples = max(int(np.ceil(12.0 * period / window)), 16)
    samples = []
    for _ in range(n_samples):
        f_0, f_1 = run_window(f_0, f_1, bc_mask, missing_mask, omega)
        samples.append(coef * float(mt(f_0, f_1, bc_mask, missing_mask)[0]))
    cds = np.asarray(samples)
    cd_mean = float(cds.mean())
    if verbose:
        ref = CD_PUBLISHED.get(re)
        line = (f"sphere drag [{backend}] (D={d}, Re={re}, winding-voxelized broken STL): Cd = {cd_mean:.4f} "
                f"(acoustic p-p {float(cds.max() - cds.min()):.4f} over {n_samples * window} steps)")
        if ref:
            line += f"   (published ~{ref}, dev {100 * (cd_mean / ref - 1):+.1f}%)"
        print(line)
    return cd_mean


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--d", type=int, default=24, help="sphere diameter in lattice units")
    p.add_argument("--re", type=float, default=100.0)
    p.add_argument("--u-in", type=float, default=0.05)
    p.add_argument("--t-star", type=float, default=60.0)
    p.add_argument("--sphere-bc", choices=["hybrid", "staircase"], default="hybrid")
    p.add_argument("--backend", choices=["cuda", "torch"], default="cuda")
    args = p.parse_args()
    run(d=args.d, re=args.re, u_in=args.u_in, t_star=args.t_star, backend=args.backend, sphere_bc=args.sphere_bc)
