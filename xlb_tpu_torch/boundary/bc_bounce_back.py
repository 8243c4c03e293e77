"""Fullway bounce-back boundary condition. Halfway bounce-back (with moving
walls) is still to be ported."""

import torch

from xlb_tpu_torch.boundary.base import BoundaryCondition, ImplementationStep


class FullwayBounceBackBC(BoundaryCondition):
    """No-slip wall: at tagged (solid-shell) voxels every population is
    replaced by the opposite population of ``f_pre``. Applied at the
    COLLISION step, where the stepper passes the post-streaming populations
    as ``f_pre``."""

    def __init__(self, velocity_set=None, precision_policy=None, compute_backend=None, indices=None):
        super().__init__(ImplementationStep.COLLISION, velocity_set, precision_policy, compute_backend, indices)

    def __call__(self, f_pre, f_post, bc_mask, missing_mask):
        opp = torch.as_tensor(self.velocity_set._opp_indices, dtype=torch.long, device=f_pre.device)
        return torch.where(self.boundary_map(bc_mask), f_pre[opp], f_post)
