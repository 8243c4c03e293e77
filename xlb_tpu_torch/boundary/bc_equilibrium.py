"""Equilibrium (fixed rho/u) boundary condition: populations at tagged
voxels are replaced with feq(rho_prescribed, u_prescribed)."""

import numpy as np
import torch

from xlb_tpu_torch.boundary.base import BoundaryCondition, ImplementationStep
from xlb_tpu_torch.ops.equilibrium import quadratic_equilibrium_np


class EquilibriumBC(BoundaryCondition):
    def __init__(self, rho: float, u, velocity_set=None, precision_policy=None, compute_backend=None, indices=None):
        super().__init__(ImplementationStep.STREAMING, velocity_set, precision_policy, compute_backend, indices)
        self.rho = float(rho)
        self.u = tuple(float(x) for x in u)
        if len(self.u) != self.velocity_set.d:
            raise ValueError(f"u must have {self.velocity_set.d} components, got {len(self.u)}")

    def prescribed_feq_np(self):
        """(q,) float64 feq of the prescribed state, computed in NumPy so it
        is bit-equal to ``xlb_tpu``'s host constant."""
        vs = self.velocity_set
        return quadratic_equilibrium_np(np.array([self.rho]), np.array(self.u), vs._c, vs._w).reshape(-1)

    def __call__(self, f_pre, f_post, bc_mask, missing_mask):
        feq = torch.as_tensor(self.prescribed_feq_np(), device=f_post.device).to(f_post.dtype)
        feq = feq.reshape((-1,) + (1,) * (f_post.ndim - 1))
        return torch.where(self.boundary_map(bc_mask), feq, f_post)
