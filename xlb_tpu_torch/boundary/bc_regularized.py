"""Regularized velocity or pressure boundary condition (Latt & Chopard
2008) -- ``xlb_tpu.boundary.bc_regularized``: the Zou-He closure, then
every boundary population rebuilt from the non-equilibrium momentum flux

    f = feq + (9/2) w_l (Q_l : Pi_neq)
"""

import torch

from xlb_tpu_torch.boundary.bc_zouhe import ZouHeBC
from xlb_tpu_torch.ops.macroscopic import momentum_flux
from xlb_tpu_torch.ops.stencil_math import stencil_contract


class RegularizedBC(ZouHeBC):
    def regularize_fpop(self, fpop, feq):
        vs = self.velocity_set
        pi_neq = momentum_flux(fpop - feq, vs._cc)
        qipi = stencil_contract(vs._qi, pi_neq)
        w = torch.as_tensor(vs._w, device=fpop.device).to(fpop.dtype).reshape((-1,) + (1,) * (fpop.ndim - 1))
        return feq + 4.5 * w * qipi

    def __call__(self, f_pre, f_post, bc_mask, missing_mask):
        feq = self.calculate_equilibrium(f_post, missing_mask)
        f_bd = self.bounceback_nonequilibrium(f_post, feq, missing_mask)
        f_bd = self.regularize_fpop(f_bd, feq)
        return torch.where(self.boundary_map(bc_mask), f_bd, f_post)
