"""Bounce-back boundary conditions: fullway, and halfway with a constant
moving wall -- ``xlb_tpu.boundary.bc_bounce_back``."""

import inspect

import numpy as np
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


def takes_coordinates(profile):
    """True when a prescription callable takes the voxel coordinates, i.e.
    varies in space."""
    return len(inspect.signature(profile).parameters) >= 1


class HalfwayBounceBackBC(BoundaryCondition):
    """Halfway bounce-back on the fluid-side shell: only missing directions
    are reflected, with an optional moving-wall momentum correction

        f_l <- f_pre[opp(l)] + 6 w_l (c_l . u_wall)

    ``prescribed_value`` gives a constant wall velocity, as does a
    zero-argument ``profile``. A spatial ``profile(coords)`` needs the
    per-voxel aux channels of the fused kernels, which are not ported yet:
    it raises ``NotImplementedError``."""

    def __init__(self, velocity_set=None, precision_policy=None, compute_backend=None, indices=None,
                 profile=None, prescribed_value=None):
        super().__init__(ImplementationStep.STREAMING, velocity_set, precision_policy, compute_backend, indices)
        self.needs_padding = True
        if profile is not None and prescribed_value is not None:
            raise ValueError("specify either profile or prescribed_value, not both")
        if profile is not None and takes_coordinates(profile):
            raise NotImplementedError(
                "a spatial wall-velocity profile(coords) needs the per-voxel aux channels, which are not ported "
                "yet (the aux-channel slice); give a constant prescribed_value or a zero-argument profile"
            )
        self.profile = profile
        if prescribed_value is not None:
            value = np.asarray(prescribed_value, dtype=np.float64)
            if value.shape != (self.velocity_set.d,):
                raise ValueError(f"wall velocity must have {self.velocity_set.d} components, got {value.shape}")
            self.profile = lambda: value.reshape(-1, 1)
        self.needs_moving_wall_treatment = self.profile is not None

    def moving_wall_np(self):
        """(q,) float64 moving-wall term 6 w_l (c_l . u_wall), or None for a
        wall at rest."""
        if not self.needs_moving_wall_treatment:
            return None
        vs = self.velocity_set
        u_wall = np.asarray(self.profile(), dtype=np.float64)
        if u_wall.size != vs.d:
            raise ValueError("a zero-argument profile must return a single wall velocity vector")
        return 6.0 * vs._w * (vs._c.T.astype(np.float64) @ u_wall.reshape(-1))

    def __call__(self, f_pre, f_post, bc_mask, missing_mask):
        vs = self.velocity_set
        opp = torch.as_tensor(vs._opp_indices, dtype=torch.long, device=f_pre.device)
        reflected = f_pre[opp]
        mw = self.moving_wall_np()
        if mw is not None:
            # float64, rounded once to the compute dtype
            mw = torch.as_tensor(mw, device=f_post.device).to(f_post.dtype)
            reflected = reflected + mw.reshape((-1,) + (1,) * (f_post.ndim - 1))
        return torch.where(missing_mask & self.boundary_map_q(bc_mask), reflected, f_post)
