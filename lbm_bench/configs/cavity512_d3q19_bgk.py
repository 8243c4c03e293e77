"""The 3D lid-driven cavity (``cavity512_d3q19_bgk.json``): fullway
bounce-back on the bottom and the four sides, an equilibrium lid moving
along x on the top face without its edges, the lattice, collision and
omega as stated."""

import numpy as np

from lbm_bench.scene import box_face, build

REFERENCE = "lbm_bench.reference.lbm"  # the plain reference the scene is checked against


def boundaries(cfg):
    """The boundary list, the same for the program and the reference."""
    shape = cfg["shape"]
    X, Y, Z = shape
    # the five walls as disjoint pieces (their union, edges included)
    walls = [box_face(shape, 2, 0),
             box_face(shape, 0, 0, skip={2: (1, Z - 1)}), box_face(shape, 0, 1, skip={2: (1, Z - 1)}),
             box_face(shape, 1, 0, skip={0: (1, X - 2), 2: (1, Z - 1)}),
             box_face(shape, 1, 1, skip={0: (1, X - 2), 2: (1, Z - 1)})]
    lid = box_face(shape, 2, 1, trim=1)
    return [{"kind": "fullway", "indices": np.concatenate(walls, axis=1)},
            {"kind": "equilibrium", "indices": lid, "rho": cfg["lid"]["rho"], "u": cfg["lid"]["u"]}]


def program_scene(cfg, bnd, policy, device, backend):
    """(stepper, bc_mask, missing_mask) of the port, from the boundary list."""
    from xlb_tpu_torch.boundary import EquilibriumBC, FullwayBounceBackBC

    walls, lid = bnd
    return build(cfg, policy, device, backend, lambda: [
        FullwayBounceBackBC(indices=walls["indices"]),
        EquilibriumBC(rho=lid["rho"], u=tuple(lid["u"]), indices=lid["indices"])])


def omega(cfg):
    return float(cfg["omega"])
