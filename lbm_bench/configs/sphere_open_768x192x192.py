"""Flow past a sphere in a channel (``sphere_open_768x192x192.json``), as
upstream ``examples/cfd/flow_past_sphere_3d.py`` builds it at three times
its size: a regularized velocity inlet with the parabolic profile on the
left face without its edges, an extrapolation outflow on the right face
without its edges, fullway bounce-back on the four channel walls, edges
included, and halfway bounce-back on the sphere."""

import numpy as np

from lbm_bench.scene import ball, box_face, build, constant

REFERENCE = "lbm_bench.reference.lbm"  # the plain reference the scene is checked against


def inlet_profile(ny, nz, u_max):
    """(3, 1, ny, nz) float64: u_x = u_max max(0, 1 - r^2) at the voxel
    (j, k), r^2 = (2 (j - H_y/2) / H_y)^2 + (2 (k - H_z/2) / H_z)^2,
    H = n - 1 (upstream's ``bc_profile``)."""
    hy, hz = float(ny - 1), float(nz - 1)
    gy, gz = np.meshgrid(2.0 * (np.arange(ny) - hy / 2.0) / hy, 2.0 * (np.arange(nz) - hz / 2.0) / hz,
                         indexing="ij")
    out = np.zeros((3, 1, ny, nz))
    out[0, 0] = u_max * np.maximum(0.0, 1.0 - gy**2 - gz**2)
    return out


def sphere(cfg):
    """(centre, radius): (nx // 6, ny // 2, nz // 2) and ny // 12, as upstream."""
    X, Y, Z = cfg["shape"]
    s = cfg["sphere"]
    return [X // s["center_div"][0], Y // s["center_div"][1], Z // s["center_div"][2]], Y // s["radius_div"]


def boundaries(cfg):
    """The boundary list, the same for the program and the reference, in
    upstream's order: walls, inlet, outlet, sphere."""
    shape = cfg["shape"]
    X, Y, Z = shape
    walls = [box_face(shape, 2, 0), box_face(shape, 2, 1),
             box_face(shape, 1, 0, skip={2: (1, Z - 2)}), box_face(shape, 1, 1, skip={2: (1, Z - 2)})]
    center, radius = sphere(cfg)
    return [{"kind": "fullway", "indices": np.concatenate(walls, axis=1)},
            {"kind": "regularized", "indices": box_face(shape, 0, 0, trim=1),
             "profile": inlet_profile(Y, Z, cfg["u_max"])},
            {"kind": "outflow", "indices": box_face(shape, 0, 1, trim=1)},
            {"kind": "halfway", "indices": ball(shape, center, radius)}]


def program_scene(cfg, bnd, policy, device, backend):
    """(stepper, bc_mask, missing_mask) of the port, from the boundary list."""
    from xlb_tpu_torch.boundary import (ExtrapolationOutflowBC, FullwayBounceBackBC, HalfwayBounceBackBC,
                                        RegularizedBC)

    walls, inlet, outlet, ball_ = bnd
    return build(cfg, policy, device, backend, lambda: [
        FullwayBounceBackBC(indices=walls["indices"]),
        RegularizedBC("velocity", profile=constant(inlet["profile"]), indices=inlet["indices"]),
        ExtrapolationOutflowBC(indices=outlet["indices"]),
        HalfwayBounceBackBC(indices=ball_["indices"])])


def omega(cfg):
    return float(cfg["omega"])
