"""Extrapolation outflow (Geier et al. 2015, Sec 3.3.2.1) --
``xlb_tpu.boundary.bc_extrapolation_outflow``.

After the collision an extrapolated population

    f_ext = cs f_neighbour + (1 - cs) f_boundary     (cs = 1 / sqrt(3))

is staged in the outgoing (opposite) slots of the post-collision field;
the next streaming brings those slots back to the boundary voxel, where
the BC copies them into the missing directions.
"""

from collections import Counter

import numpy as np
import torch

from xlb_tpu_torch.boundary.base import BoundaryCondition, ImplementationStep


class ExtrapolationOutflowBC(BoundaryCondition):
    def __init__(self, velocity_set=None, precision_policy=None, compute_backend=None, indices=None,
                 mesh_vertices=None, voxelization_method=None):
        super().__init__(ImplementationStep.STREAMING, velocity_set, precision_policy, compute_backend, indices,
                         mesh_vertices, voxelization_method)
        self.needs_aux_recovery = True
        if indices is None:
            raise ValueError("ExtrapolationOutflowBC requires explicit indices (a planar outflow face)")
        self.normal = self._face_normal(indices)

    def _face_normal(self, indices):
        """Outward normal of the planar outflow face: the axis whose
        coordinate is constant across the face, pointing away from 0 unless
        that coordinate is 0."""
        freq = [Counter(coord).most_common(1)[0] for coord in indices]
        counts = np.array([count for _, count in freq])
        elements = np.array([element for element, _ in freq])
        normal = counts // counts.max()
        if elements[np.argmax(counts)] == 0:
            normal = -normal
        return normal

    def _roll(self, fld, vec):
        return torch.roll(fld, shifts=tuple(int(v) for v in vec), dims=tuple(range(1, fld.ndim)))

    def assemble_auxiliary_data(self, f_pre, f_post, bc_mask, missing_mask):
        """Stage the extrapolated populations in the outgoing slots after
        the collision (``f_pre`` the post-streaming, ``f_post`` the
        post-collision state)."""
        sound_speed = float(1.0 / np.sqrt(3.0))
        boundary = self.boundary_map_q(bc_mask)
        neighbour = self._roll(boundary, -self.normal)
        fpop = torch.where(boundary, f_pre, f_post)
        fpop_neighbour = self._roll(torch.where(neighbour, f_pre, f_post), self.normal)
        fpop_extrapolated = sound_speed * fpop_neighbour + (1.0 - sound_speed) * fpop
        opp = torch.as_tensor(self.velocity_set._opp_indices, dtype=torch.long, device=f_post.device)
        return torch.where(boundary & missing_mask[opp], fpop_extrapolated[opp], f_post)

    def __call__(self, f_pre, f_post, bc_mask, missing_mask):
        opp = torch.as_tensor(self.velocity_set._opp_indices, dtype=torch.long, device=f_pre.device)
        return torch.where(missing_mask & self.boundary_map_q(bc_mask), f_pre[opp], f_post)
