"""Free-slip (specular-reflection) wall -- ``xlb_tpu.boundary.bc_free_slip``.

At a fluid-side wall voxel every missing direction l that crosses the
wall takes the pre-streaming population of its mirror spec(l), which
flips the wall-normal component of c_l and keeps the tangential ones: a
stress-free wall at the halfway plane. Voxel-local, so it runs in the
fused kernels.
"""

import numpy as np
import torch

from xlb_tpu_torch.boundary.base import BoundaryCondition, ImplementationStep


class FreeSlipBC(BoundaryCondition):
    """Specular-reflection wall on the fluid-side shell.

    Parameters
    ----------
    normal : (d,) ints
        The outward axis-aligned wall normal, e.g. (0, 0, 1) for a wall
        above the fluid.
    """

    def __init__(self, velocity_set=None, precision_policy=None, compute_backend=None, indices=None,
                 mesh_vertices=None, voxelization_method=None, normal=None):
        super().__init__(ImplementationStep.STREAMING, velocity_set, precision_policy, compute_backend, indices,
                         mesh_vertices, voxelization_method)
        self.needs_padding = True
        if normal is None:
            raise ValueError("FreeSlipBC needs the axis-aligned wall `normal`, e.g. (0, 1) or (0, 0, 1)")
        normal = np.asarray(normal, dtype=np.int64).reshape(-1)
        d = self.velocity_set.d
        if normal.shape != (d,) or np.abs(normal).sum() != 1:
            raise ValueError(f"free-slip normal must be axis-aligned with {d} components, got {normal}")
        self.normal = normal
        self.axis = axis = int(np.nonzero(normal)[0][0])
        c = self.velocity_set._c
        target = c.copy()
        target[axis] = -target[axis]
        self.spec_indices = np.asarray(
            [int(np.nonzero((c == target[:, l: l + 1]).all(axis=0))[0][0]) for l in range(self.velocity_set.q)])
        # only directions whose pull crosses this wall; the masker also tags
        # directions that wrap a periodic transverse edge at corner voxels,
        # and those keep their streamed values
        self.reflect_dirs = c[axis] == -int(np.sign(normal[axis]))

    def __call__(self, f_pre, f_post, bc_mask, missing_mask):
        refl = torch.as_tensor(self.reflect_dirs, device=f_post.device).reshape((-1,) + (1,) * (f_post.ndim - 1))
        sel = missing_mask & self.boundary_map_q(bc_mask) & refl
        spec = torch.as_tensor(self.spec_indices, dtype=torch.long, device=f_pre.device)
        return torch.where(sel, f_pre[spec], f_post)
