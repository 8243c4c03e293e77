"""Do-nothing (zero-gradient) outlet -- ``xlb_tpu.boundary.bc_do_nothing``:
tagged voxels keep their pre-streaming populations."""

import torch

from xlb_tpu_torch.boundary.base import BoundaryCondition, ImplementationStep


class DoNothingBC(BoundaryCondition):
    def __init__(self, velocity_set=None, precision_policy=None, compute_backend=None, indices=None,
                 mesh_vertices=None, voxelization_method=None):
        super().__init__(ImplementationStep.STREAMING, velocity_set, precision_policy, compute_backend, indices,
                         mesh_vertices, voxelization_method)

    def __call__(self, f_pre, f_post, bc_mask, missing_mask):
        return torch.where(self.boundary_map(bc_mask), f_pre, f_post)
