"""Zou-He (non-equilibrium bounce-back) velocity or pressure boundary
condition -- ``xlb_tpu.boundary.bc_zouhe``.

The prescribed value (velocity vector or density) is closed by the Zou-He
mass balance at the boundary; missing populations are rebuilt by
non-equilibrium bounce-back:

    f_missing = f[opp] + feq - feq[opp]

The prescription is a constant (a d-vector velocity or a density), or
an array from a zero-argument ``profile()`` that varies in space:
(k, *slab) values broadcast over the domain (``_broadcast_prescribed``),
e.g. the parabolic inlet (3, 1, ny, nz) of ``flow_past_sphere_3d.py``.
The fused kernels read a spatial prescription from the aux field.
"""

import numpy as np
import torch

from xlb_tpu_torch.boundary.base import BoundaryCondition, ImplementationStep
from xlb_tpu_torch.boundary.bc_bounce_back import takes_coordinates
from xlb_tpu_torch.ops.equilibrium import quadratic_equilibrium
from xlb_tpu_torch.ops.stencil_math import stencil_contract


def _broadcast_prescribed(values, target_shape):
    """Broadcast (k,) / (k, 1) / (k, *spatial-slab) prescribed values
    toward ``target_shape`` by inserting singleton dims after the leading
    axis (the port's copy of ``xlb_tpu.boundary.bc_zouhe``'s helper)."""
    values = np.asarray(values)
    if values.ndim == 0:
        values = values.reshape((1,) * len(target_shape))
    elif values.ndim < len(target_shape):
        missing = len(target_shape) - values.ndim
        values = values.reshape((values.shape[0],) + (1,) * missing + values.shape[1:])
    return values


class ZouHeBC(BoundaryCondition):
    def __init__(self, bc_type, profile=None, prescribed_value=None, velocity_set=None, precision_policy=None,
                 compute_backend=None, indices=None, mesh_vertices=None, voxelization_method=None):
        if bc_type not in ("velocity", "pressure"):
            raise ValueError(f"bc_type must be 'velocity' or 'pressure', got {bc_type!r}")
        self.bc_type = bc_type
        super().__init__(ImplementationStep.STREAMING, velocity_set, precision_policy, compute_backend, indices,
                         mesh_vertices, voxelization_method)
        self.needs_padding = True
        if profile is not None and prescribed_value is not None:
            raise ValueError("specify either profile or prescribed_value, not both")
        if profile is not None and takes_coordinates(profile):
            raise ValueError(f"{type(self).__name__} takes a zero-argument profile() returning the prescribed values "
                             "(a constant, or an array that broadcasts over the domain), as xlb_tpu")
        self.profile = profile
        if prescribed_value is not None:
            if bc_type == "velocity":
                value = np.asarray(prescribed_value, dtype=np.float64)
                if value.ndim != 1:
                    raise ValueError("velocity prescribed_value must be a d-vector")
            else:
                value = np.asarray(float(prescribed_value), dtype=np.float64).reshape(1)
            self.profile = lambda: value.reshape(-1, 1)
        if self.profile is None:
            raise ValueError(f"{type(self).__name__} requires a prescribed_value or a profile")
        self.prescribed_values = np.asarray(self.profile())

    @property
    def spatial(self):
        """True when the prescription varies in space (read from the aux
        field by the fused kernels)."""
        return self.prescribed_values.size != (self.velocity_set.d if self.bc_type == "velocity" else 1)

    # -- geometric helpers --------------------------------------------------
    def _known_middle_masks(self, missing_mask):
        known = missing_mask[torch.as_tensor(self.velocity_set._opp_indices, dtype=torch.long)]
        middle = ~(missing_mask | known)
        return known, middle

    def _normal_vectors(self, missing_mask):
        """Inward unit normal per voxel from the missing main directions."""
        vs = self.velocity_set
        m = missing_mask[torch.as_tensor(vs.main_indices, dtype=torch.long)]
        return -stencil_contract(vs._c[:, vs.main_indices], m.to(torch.int32))

    # -- Zou-He closure -----------------------------------------------------
    def _closure_rho_u(self, fpop, missing_mask):
        normals = self._normal_vectors(missing_mask).to(fpop.dtype)
        known, middle = self._known_middle_masks(missing_mask)
        fsum = torch.sum(fpop * middle, dim=0, keepdim=True) + 2.0 * torch.sum(fpop * known, dim=0, keepdim=True)
        d = self.velocity_set.d
        if self.bc_type == "velocity":
            vel = self._prescribed(d, fpop)
            unormal = torch.sum(normals * vel, dim=0, keepdim=True)
            rho = fsum / (1.0 + unormal)
            vel = vel + torch.zeros_like(fsum)
        else:
            rho = self._prescribed(1, fpop)
            unormal = -1.0 + fsum / rho
            vel = unormal * normals
            rho = rho + torch.zeros_like(fsum)
        return rho, vel

    def _prescribed(self, k, fpop):
        """The prescription as a (k, ...) tensor that broadcasts against
        the (q, *s) populations ``fpop``, rounded once to their dtype."""
        values = _broadcast_prescribed(self.prescribed_values, (k,) + tuple(fpop.shape[1:]))
        if values.size == k:
            values = values.reshape((k,) + (1,) * (fpop.ndim - 1))
        return torch.as_tensor(np.ascontiguousarray(values), device=fpop.device).to(fpop.dtype)

    def calculate_equilibrium(self, f_post, missing_mask):
        rho, vel = self._closure_rho_u(f_post, missing_mask)
        vs = self.velocity_set
        return quadratic_equilibrium(rho, vel, vs._c, vs._w, f_post.dtype)

    def bounceback_nonequilibrium(self, fpop, feq, missing_mask):
        opp = torch.as_tensor(self.velocity_set._opp_indices, dtype=torch.long, device=fpop.device)
        return torch.where(missing_mask, fpop[opp] + feq - feq[opp], fpop)

    def __call__(self, f_pre, f_post, bc_mask, missing_mask):
        feq = self.calculate_equilibrium(f_post, missing_mask)
        f_bd = self.bounceback_nonequilibrium(f_post, feq, missing_mask)
        return torch.where(self.boundary_map(bc_mask), f_bd, f_post)
