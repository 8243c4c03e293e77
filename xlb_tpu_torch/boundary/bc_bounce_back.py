"""Bounce-back boundary conditions: fullway, and halfway with a constant
or a per-voxel moving wall -- ``xlb_tpu.boundary.bc_bounce_back``."""

import inspect

import numpy as np
import torch

from xlb_tpu_torch.boundary.base import BoundaryCondition, ImplementationStep


class FullwayBounceBackBC(BoundaryCondition):
    """No-slip wall: at tagged (solid-shell) voxels every population is
    replaced by the opposite population of ``f_pre``. Applied at the
    COLLISION step, where the stepper passes the post-streaming populations
    as ``f_pre``."""

    def __init__(self, velocity_set=None, precision_policy=None, compute_backend=None, indices=None,
                 mesh_vertices=None, voxelization_method=None):
        super().__init__(ImplementationStep.COLLISION, velocity_set, precision_policy, compute_backend, indices,
                         mesh_vertices, voxelization_method)

    def __call__(self, f_pre, f_post, bc_mask, missing_mask):
        opp = torch.as_tensor(self.velocity_set._opp_indices, dtype=torch.long, device=f_pre.device)
        return torch.where(self.boundary_map(bc_mask), f_pre[opp], f_post)


def takes_coordinates(profile):
    """True when a prescription callable takes the voxel coordinates, i.e.
    varies in space."""
    return len(inspect.signature(profile).parameters) >= 1


class HalfwayBounceBackBC(BoundaryCondition):
    """Halfway bounce-back on the fluid-side shell: only missing directions
    are reflected, with an optional moving-wall momentum correction

        f_l <- f_pre[opp(l)] + 6 w_l (c_l . u_wall)

    ``prescribed_value`` gives a constant wall velocity, as does a
    zero-argument ``profile``; ``profile(coords)``, with coords the (d, n)
    voxel positions, a wall velocity (d, n) that varies in space (e.g. a
    rotating body). It is evaluated once, on the BC's dilated voxel set
    (``pad_indices``: the fluid-side shell where the missing directions
    live); the fused kernels read it from the aux field."""

    def __init__(self, velocity_set=None, precision_policy=None, compute_backend=None, indices=None,
                 mesh_vertices=None, voxelization_method=None, profile=None, prescribed_value=None):
        super().__init__(ImplementationStep.STREAMING, velocity_set, precision_policy, compute_backend, indices,
                         mesh_vertices, voxelization_method)
        self.needs_padding = True
        if profile is not None and prescribed_value is not None:
            raise ValueError("specify either profile or prescribed_value, not both")
        self.profile = profile
        if prescribed_value is not None:
            value = np.asarray(prescribed_value, dtype=np.float64)
            if value.shape != (self.velocity_set.d,):
                raise ValueError(f"wall velocity must have {self.velocity_set.d} components, got {value.shape}")
            self.profile = lambda: value.reshape(-1, 1)
        self.needs_moving_wall_treatment = self.profile is not None

    @property
    def spatial(self):
        """True when the wall velocity varies in space (``profile(coords)``)."""
        return self.profile is not None and takes_coordinates(self.profile)

    def moving_wall_np(self):
        """(q,) float64 moving-wall term 6 w_l (c_l . u_wall), or None for a
        wall at rest; "aux" for a wall velocity that varies in space."""
        if not self.needs_moving_wall_treatment:
            return None
        if self.spatial:
            return "aux"
        vs = self.velocity_set
        u_wall = np.asarray(self.profile(), dtype=np.float64)
        if u_wall.size != vs.d:
            raise ValueError("a zero-argument profile must return a single wall velocity vector")
        return 6.0 * vs._w * (vs._c.T.astype(np.float64) @ u_wall.reshape(-1))

    def spatial_wall_velocity(self):
        """(pad_indices (d, n) int64, wall velocity (d, n) float64) of a
        spatial profile, evaluated on the dilated voxel set."""
        if self.indices is None:
            raise ValueError("a spatial wall-velocity profile needs the BC's voxel indices (run prepare_fields first)")
        idx = np.asarray(self.pad_indices(), dtype=np.int64)
        u_wall = np.asarray(self.profile(idx.astype(np.float64)), dtype=np.float64)
        if u_wall.shape != idx.shape:
            raise ValueError(f"profile returned {u_wall.shape}, expected {idx.shape}")
        return idx, u_wall

    def __call__(self, f_pre, f_post, bc_mask, missing_mask):
        vs = self.velocity_set
        opp = torch.as_tensor(vs._opp_indices, dtype=torch.long, device=f_pre.device)
        reflected = f_pre[opp]
        mw = self.moving_wall_np()
        if isinstance(mw, str):
            # 6 w_l (c_l . u_wall) in float64 on the dilated voxel set, rounded
            # once to the compute dtype and scattered into a q-field
            idx, u_wall = self.spatial_wall_velocity()
            term = 6.0 * vs._w[:, None] * (vs._c.T.astype(np.float64) @ u_wall)
            field = torch.zeros_like(f_post)
            field[(slice(None),) + tuple(torch.as_tensor(idx, device=f_post.device))] = (
                torch.as_tensor(term, device=f_post.device).to(f_post.dtype))
            reflected = reflected + field
        elif mw is not None:
            # float64, rounded once to the compute dtype
            mw = torch.as_tensor(mw, device=f_post.device).to(f_post.dtype)
            reflected = reflected + mw.reshape((-1,) + (1,) * (f_post.ndim - 1))
        return torch.where(missing_mask & self.boundary_map_q(bc_mask), reflected, f_post)
