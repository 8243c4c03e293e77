"""Boundary-condition base class.

A BC is applied inside the step as a masked select: voxels whose
``bc_mask`` equals the BC's id get the BC-specific populations, all others
pass through. Prescribed values are kept on the BC object, in NumPy.
"""

from enum import Enum, auto

import numpy as np

from xlb_tpu_torch.operator import Operator
from xlb_tpu_torch.boundary.registry import boundary_condition_registry


class ImplementationStep(Enum):
    """Algorithmic stage at which a BC executes."""

    COLLISION = auto()
    STREAMING = auto()


class BoundaryCondition(Operator):
    """Abstract base for LBM boundary conditions.

    Parameters
    ----------
    implementation_step : ImplementationStep
    indices : array-like (d, n)
        Explicit voxel indices this BC claims.
    mesh_vertices : array-like, optional
        Triangles ((n, 3, 3), or a flat (3n, 3) vertex array) of a
        geometry-based BC, voxelized by ``prepare_fields`` into
        ``indices`` (``geometry.mesh_masker``).
    voxelization_method : optional
        The ``geometry.MeshVoxelizationMethod`` for ``mesh_vertices``
        (``RAY`` by default).
    """

    def __init__(self, implementation_step: ImplementationStep, velocity_set=None, precision_policy=None,
                 compute_backend=None, indices=None, mesh_vertices=None, voxelization_method=None):
        self.id = boundary_condition_registry.register_boundary_condition(f"{type(self).__name__}_{id(self)}")
        super().__init__(velocity_set, precision_policy, compute_backend)
        self.indices = indices
        self.mesh_vertices = mesh_vertices
        self.voxelization_method = voxelization_method
        self.implementation_step = implementation_step
        # fluid-side BCs (halfway, Zou-He, regularized) dilate interior
        # geometry into the shell where their missing directions live
        self.needs_padding = False
        # per-link wall distances of a mesh (HybridBC), computed by
        # prepare_fields after voxelization
        self.needs_mesh_distance = False
        # stages data for the next step in assemble_auxiliary_data (the
        # extrapolation outflow)
        self.needs_aux_recovery = False

    def boundary_map(self, bc_mask):
        """(1, *spatial) boolean: voxels claimed by this BC."""
        return bc_mask == self.id

    def boundary_map_q(self, bc_mask):
        """(q, *spatial) boolean: claimed voxels broadcast over directions."""
        return (bc_mask == self.id).expand((self.velocity_set.q,) + tuple(bc_mask.shape[1:]))

    def pad_indices(self):
        """This BC's indices dilated by one stencil hop in every direction
        when ``needs_padding`` (the masker tags that shell of interior
        geometry), else the indices as given."""
        bc_indices = np.asarray(self.indices)
        if not self.needs_padding:
            return bc_indices
        c = self.velocity_set._c  # (d, q)
        dilated = bc_indices[:, :, None] + c[:, None, :]
        return np.unique(dilated.reshape(self.velocity_set.d, -1), axis=1)

    def assemble_auxiliary_data(self, f_pre, f_post, bc_mask, missing_mask):
        """Post-collision hook of a BC that stages data for the next step
        (``f_pre`` the post-streaming, ``f_post`` the post-collision
        populations); the identity by default."""
        return f_post

    def __call__(self, f_pre, f_post, bc_mask, missing_mask):
        raise NotImplementedError
