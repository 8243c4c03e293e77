"""Shan-Chen pseudopotential multiphase flow (single component), the port
of ``xlb_tpu.models.multiphase``.

Liquid/vapor phase separation, droplets and bubbles with surface tension,
and solid wettability, from one inter-particle pseudopotential force
applied by the per-voxel exact-difference forcing of the NSE step
(``models/nse.py::_step_pull(..., force_field)`` on the TORCH tier,
``kernels.fused_step.build_fused_forced_step`` on the CUDA tier):

    psi(rho)  = rho0 * (1 - exp(-rho / rho0))          # bounded potential
    F_a(x)    = -G psi(x) * sum_l w_l psi(x + c_l) c_{a,l}
    delta u   = F / rho                                 # exact-difference shift
    EOS:  p   = cs^2 rho + (cs^2 G / 2) psi^2

``G < 0`` is attractive; below the critical point (G < -4 for rho0 = 1)
the fluid separates into coexisting liquid and vapor. The force uses the
step's input state rho(t), the zeroth moment of f_0, on both tiers.
Wettability: ``psi_wall`` gives solid voxels (cell type 255, and the
bounce-back walls' voxels) a virtual potential, from wetting (psi of the
liquid) to non-wetting (psi of the vapor). The neighbour sums and psi are
plain torch around the kernel on both tiers.
"""

import numpy as np
import torch

from xlb_tpu_torch.compute_backend import ComputeBackend
from xlb_tpu_torch.models.ade import _require_pull


class ShanChenMultiphaseStepper:
    """Single-component multiphase NSE stepper.

    Parameters
    ----------
    nse : IncompressibleNavierStokesStepper
        Configured stepper (its BC list handles walls).
    G : float
        Interaction strength (negative = attractive; |G| > 4 separates
        phases for rho0 = 1).
    rho0 : float
        Potential saturation density.
    psi_wall : float or None
        Virtual potential of solid voxels (wettability); None leaves
        solids force-neutral (psi read from the frozen solid state).

    Call: ``(f_0, f_1, bc_mask, missing_mask, omega, timestep) ->
    (f_0, f_1)``, the standard stepper signature.
    """

    def __init__(self, nse, G=-5.0, rho0=1.0, psi_wall=None):
        _require_pull(nse, "ShanChenMultiphaseStepper")
        self._fused_nse = None
        if nse.compute_backend == ComputeBackend.CUDA:
            from xlb_tpu_torch.kernels.fused_step import build_fused_forced_step

            # the interaction force as the forced kernel's field channels; a
            # pair or BC set without that kernel raises (NotImplementedError)
            self._fused_nse = build_fused_forced_step(nse)
        self.nse = nse
        self.G = float(G)
        self.rho0 = float(rho0)
        self.psi_wall = None if psi_wall is None else float(psi_wall)
        # wettability anchors: interior solids (255) and the bounce-back
        # walls' voxels (the masker tags them with their BC ids)
        from xlb_tpu_torch.boundary.bc_bounce_back import FullwayBounceBackBC, HalfwayBounceBackBC

        self._wall_ids = [255] + [
            bc.id for bc in nse.boundary_conditions if isinstance(bc, (FullwayBounceBackBC, HalfwayBounceBackBC))
        ]

    def psi(self, rho):
        """Bounded Shan-Chen potential psi = rho0 (1 - exp(-rho/rho0))."""
        r0 = torch.tensor(self.rho0, dtype=rho.dtype, device=rho.device)
        return r0 * (1.0 - torch.exp(-rho / r0))

    def pressure(self, rho):
        """Equation of state p = cs^2 rho + (cs^2 G / 2) psi^2."""
        cs2 = torch.tensor(self.nse.velocity_set.cs2, dtype=rho.dtype, device=rho.device)
        half_g = torch.tensor(0.5 * self.G, dtype=rho.dtype, device=rho.device)
        return cs2 * rho + cs2 * half_g * self.psi(rho) ** 2

    def interaction_du(self, rho, bc_mask=None):
        """Exact-difference velocity shift delta_u = F / rho, with F_a = -G
        psi sum_l w_l psi(x + c_l) c_{a,l}. The neighbour sums are
        ``torch.roll`` gathers (periodic wrap; walls take ``psi_wall``)."""
        vs = self.nse.velocity_set
        d, q = vs.d, vs.q
        c = np.asarray(vs._c)
        w = np.asarray(vs._w)
        psi0 = self.psi(rho)[0]
        if self.psi_wall is not None and bc_mask is not None:
            on_wall = bc_mask[0] == self._wall_ids[0]
            for wid in self._wall_ids[1:]:
                on_wall = on_wall | (bc_mask[0] == wid)
            psi0 = torch.where(on_wall, torch.tensor(self.psi_wall, dtype=psi0.dtype, device=psi0.device), psi0)
        S = [None] * d
        for l in range(q):
            cl = c[:, l]
            if not cl.any():
                continue
            nb = torch.roll(psi0, shifts=tuple(-int(cl[a]) for a in range(d)), dims=tuple(range(d)))
            for a in range(d):
                if cl[a]:
                    term = float(w[l] * cl[a]) * nb
                    S[a] = term if S[a] is None else S[a] + term
        G = torch.tensor(self.G, dtype=psi0.dtype, device=psi0.device)
        rho_safe = torch.clamp(rho[0], min=1e-8)
        return torch.stack([-G * psi0 * S[a] / rho_safe for a in range(d)])

    def __call__(self, f_0, f_1, bc_mask, missing_mask, omega, timestep=0):
        pp = self.nse.precision_policy
        rho = torch.sum(pp.cast_to_compute(f_0), dim=0, keepdim=True)
        du = self.interaction_du(rho, bc_mask)
        if self._fused_nse is not None:
            return self._fused_nse(f_0, f_1, bc_mask, missing_mask, omega, du, timestep)
        return self.nse._step_pull(f_0, f_1, bc_mask, missing_mask, omega, timestep, force_field=du)

    def macroscopic(self, f, bc_mask=None):
        """(rho, u_true) from a stepper output state: the post-collision
        populations carry the full kick rho delta_u, so the physical
        (half-step) velocity is u_raw - delta_u / 2."""
        pp = self.nse.precision_policy
        rho, u = self.nse.macroscopic(pp.cast_to_compute(f))
        du = self.interaction_du(rho, bc_mask)
        return rho, u - 0.5 * du

    def build_multi_step(self, num_steps):
        """``num_steps`` steps: ``run(f_0, f_1, bc_mask, missing_mask,
        omega, start=0) -> (f_0, f_1)`` with f_0 the current state (a plain
        loop; one kernel launch per step on the CUDA tier)."""

        def run(f_0, f_1, bc_mask, missing_mask, omega, start=0):
            for t in range(num_steps):
                f_0, f_1 = self(f_0, f_1, bc_mask, missing_mask, omega, start + t)
                f_0, f_1 = f_1, f_0
            return f_0, f_1

        return run
