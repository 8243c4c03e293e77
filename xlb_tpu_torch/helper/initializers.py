"""Equilibrium initialization of distribution fields."""

import numpy as np
import torch

from xlb_tpu_torch.ops.equilibrium import quadratic_equilibrium


def initialize_eq(f, grid, velocity_set, precision_policy):
    """Return f initialized to feq(rho=1, u=0) in the store dtype (so under
    FP32BF16, f starts as bf16(w))."""
    rho = grid.create_field(cardinality=1, fill_value=1.0, dtype=precision_policy.compute_precision)
    u = grid.create_field(cardinality=velocity_set.d, fill_value=0.0, dtype=precision_policy.compute_precision)
    feq = quadratic_equilibrium(rho, u, velocity_set._c, velocity_set._w, precision_policy.compute_dtype)
    return feq.to(precision_policy.store_dtype)


def initialize_from_macroscopic(grid, velocity_set, precision_policy, rho, u):
    """Equilibrium populations of the given (rho (1, *s), u (d, *s)) fields
    (arrays or tensors), on the grid's device in the store dtype."""
    cdt = precision_policy.compute_dtype
    rho = torch.as_tensor(rho, device=grid.device).to(cdt)
    u = torch.as_tensor(u, device=grid.device).to(cdt)
    feq = quadratic_equilibrium(rho, u, velocity_set._c, velocity_set._w, cdt)
    return feq.to(precision_policy.store_dtype)


class CustomInitializer:
    """Per-region equilibrium initializer -- ``xlb_tpu.helper.initializers
    .CustomInitializer``: the whole domain at (rho_0, u_0) and the voxels
    tagged ``bc_id`` in ``bc_mask`` at (rho_bc, u_bc). Pass it as the
    ``initializer`` of ``stepper.prepare_fields``."""

    def __init__(self, rho_0=1.0, u_0=None, bc_id=None, rho_bc=None, u_bc=None, velocity_set=None,
                 precision_policy=None):
        from xlb_tpu_torch.default_config import DefaultConfig

        self.velocity_set = velocity_set or DefaultConfig.velocity_set
        self.precision_policy = precision_policy or DefaultConfig.default_precision_policy
        d = self.velocity_set.d
        self.rho_0 = float(rho_0)
        self.u_0 = np.asarray(u_0 if u_0 is not None else [0.0] * d, dtype=np.float64)
        self.bc_id = bc_id
        self.rho_bc = float(rho_bc) if rho_bc is not None else None
        self.u_bc = np.asarray(u_bc, dtype=np.float64) if u_bc is not None else None

    def __call__(self, bc_mask, f):
        vs, pp = self.velocity_set, self.precision_policy
        spatial = tuple(f.shape[1:])
        ones = (1,) * len(spatial)
        cdt = pp.compute_dtype
        rho = torch.full((1,) + spatial, self.rho_0, dtype=cdt, device=f.device)
        u = torch.as_tensor(self.u_0, device=f.device).to(cdt).reshape((vs.d,) + ones).expand((vs.d,) + spatial)
        if self.bc_id is not None:
            region = bc_mask == self.bc_id
            if self.rho_bc is not None:
                rho = torch.where(region, torch.tensor(self.rho_bc, dtype=cdt, device=f.device), rho)
            if self.u_bc is not None:
                u_bc = torch.as_tensor(self.u_bc, device=f.device).to(cdt).reshape((vs.d,) + ones)
                u = torch.where(region, u_bc, u)
        feq = quadratic_equilibrium(rho, u, vs._c, vs._w, cdt)
        return feq.to(pp.store_dtype)
