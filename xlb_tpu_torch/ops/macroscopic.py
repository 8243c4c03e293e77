"""Moment operators: density, velocity and the momentum flux."""

import numpy as np
import torch

from xlb_tpu_torch.operator import Operator
from xlb_tpu_torch.ops.stencil_math import stencil_contract


def density(f):
    """Zeroth moment: rho = sum_l f_l, shape (1, *spatial)."""
    return torch.sum(f, dim=0, keepdim=True)


def velocity(f, rho, c):
    """First moment: u = (sum_l c_l f_l) / rho, shape (d, *spatial)."""
    return stencil_contract(np.asarray(c), f) / rho


def momentum_flux(fneq, cc):
    """Second moment Pi = sum_l cc_l fneq_l. ``cc`` is the (q, d(d+1)/2)
    upper-triangular second-moment basis; the result packs the symmetric
    tensor as (xx, xy, [xz,] yy, [yz, zz])."""
    return stencil_contract(np.asarray(cc).T, fneq)


class SecondMoment(Operator):
    def __call__(self, fneq):
        return momentum_flux(fneq, self.velocity_set._cc)


class Macroscopic(Operator):
    """Fused (rho, u) readout."""

    def __call__(self, f):
        rho = density(f)
        return rho, velocity(f, rho, self.velocity_set._c)
