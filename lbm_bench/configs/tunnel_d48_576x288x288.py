"""The sphere-drag tunnel (``tunnel_d48_576x288x288.json``), as
``examples/cfd/sphere_drag_validation.py`` builds it: four free-slip
walls, a regularized velocity inlet and a regularized pressure outlet on
the x faces without their edges, and a HybridBC interpolated bounce-back
sphere whose per-link wall distances are those of the analytic sphere."""

import numpy as np

from lbm_bench.reference.lbm import C
from lbm_bench.scene import ball, box_face, build

REFERENCE = "lbm_bench.reference.tunnel"  # the plain reference the scene is checked against


def sphere(cfg):
    """(centre, radius) of the sphere, as the configuration states them."""
    return list(cfg["sphere"]["center"]), cfg["sphere"]["radius"]


def link_distances(shape, center, radius):
    """(shell (3, n) int64, distances (19, n) float64) of the sphere: the
    fluid voxels one stencil hop from a solid voxel (``ball``), and per
    link l the fraction t of x -> x + c_l (C's order) at which the segment
    enters the sphere, for the links that end in a solid voxel; inf for
    the others. t is the smaller root of |p + t c|^2 = r^2, p = x - centre,
    written as 2 (|p|^2 - r^2) / (-b + sqrt(b^2 - 4 |c|^2 (|p|^2 - r^2))),
    b = 2 p . c, which keeps its digits where |p|^2 is close to r^2."""
    solid = ball(shape, center, radius)
    shell = np.unique((solid[:, :, None] + C[:, None, :]).reshape(3, -1), axis=1)
    p = shell.T.astype(np.float64) - np.asarray(center, np.float64)
    r2 = float(radius) ** 2
    outside = (p * p).sum(axis=1) >= r2
    shell, p = shell[:, outside], p[outside]
    pp = (p * p).sum(axis=1) - r2
    out = np.full((C.shape[1], shell.shape[1]), np.inf)
    for l in range(C.shape[1]):
        c = C[:, l].astype(np.float64)
        ends_inside = ((p + c) ** 2).sum(axis=1) < r2
        b = 2.0 * (p @ c)
        disc = np.maximum(b * b - 4.0 * float(c @ c) * pp, 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = 2.0 * pp / (np.sqrt(disc) - b)
        out[l, ends_inside] = t[ends_inside]
    return shell, out


def boundaries(cfg):
    """The boundary list, the same for the program and the reference, in
    the script's order: four free-slip walls, inlet, outlet, sphere."""
    shape = cfg["shape"]
    X, Y, Z = shape
    center, radius = sphere(cfg)
    shell, distances = link_distances(shape, center, radius)
    walls = [(box_face(shape, 1, 0), (0, -1, 0)), (box_face(shape, 1, 1), (0, 1, 0)),
             (box_face(shape, 2, 0, skip={1: (1, Y - 2)}), (0, 0, -1)),
             (box_face(shape, 2, 1, skip={1: (1, Y - 2)}), (0, 0, 1))]
    return [{"kind": "freeslip", "indices": idx, "normal": normal} for idx, normal in walls] + [
        {"kind": "regularized", "indices": box_face(shape, 0, 0, trim=1), "u": [cfg["u_in"], 0.0, 0.0]},
        {"kind": "regularized", "indices": box_face(shape, 0, 1, trim=1), "rho": 1.0},
        {"kind": "hybrid", "method": cfg["hybrid_method"], "indices": ball(shape, center, radius),
         "shell": shell, "distances": distances}]


def program_scene(cfg, bnd, policy, device, backend):
    """(stepper, bc_mask, missing_mask) of the port, from the boundary list:
    the sphere's distances handed in through ``HybridBC.set_link_distances``
    before ``prepare_fields``."""
    from xlb_tpu_torch.boundary import FreeSlipBC, HybridBC, RegularizedBC

    *walls, inlet, outlet, body = bnd

    def make_bcs():
        bcs = [FreeSlipBC(indices=w["indices"], normal=w["normal"]) for w in walls]
        bcs += [RegularizedBC("velocity", prescribed_value=tuple(inlet["u"]), indices=inlet["indices"]),
                RegularizedBC("pressure", prescribed_value=outlet["rho"], indices=outlet["indices"])]
        hybrid = HybridBC(bc_method=body["method"], indices=body["indices"])
        hybrid.set_link_distances(body["shell"], body["distances"])
        return bcs + [hybrid]

    return build(cfg, policy, device, backend, make_bcs)


def omega(cfg):
    return float(cfg["omega"])
