"""Moment operators: density and velocity."""

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


class Macroscopic(Operator):
    """Fused (rho, u) readout."""

    def __call__(self, f):
        rho = density(f)
        return rho, velocity(f, rho, self.velocity_set._c)
