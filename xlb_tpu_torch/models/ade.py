"""Advection-diffusion (ADE) stepper and Boussinesq-coupled thermal flow,
the port of ``xlb_tpu.models.ade``.

A scalar field phi is carried by a second distribution set g on the same
velocity set, advected by a prescribed (or NSE-coupled) velocity field
with the linear equilibrium geq_l = w_l phi (1 + 3 c_l . u). Diffusivity
maps to the scalar's relaxation rate as D = (1/omega_phi - 1/2)/3, the
same form as the NSE viscosity.

Boundary conditions are the NSE ones, applied to g:

- Dirichlet phi = const: ``EquilibriumBC(rho=phi_wall, u=(0, ...))`` (at
  zero velocity the quadratic feq reduces to w_l phi_wall);
- zero flux (adiabatic): ``HalfwayBounceBackBC`` / fullway (reflection
  conserves the scalar).

``ThermalNSEStepper`` couples an NSE stepper to the scalar through the
Boussinesq approximation: a per-voxel buoyancy F = -beta (phi - phi_ref) g
by exact-difference forcing inside the NSE collide, and u from the NSE
macroscopics advecting phi.

Two tiers, as the NSE stepper: TORCH (plain torch, any device) and CUDA
(the grid on a CUDA device): the ADE step is
``kernels.fused_step.build_fused_ade_step`` and the NSE step of the
coupling ``build_fused_forced_step``, one kernel launch each per coupled
step; the coupling's glue (phi, the buoyancy, u) stays plain torch.
Both fused steps are forward only, as in ``xlb_tpu``: differentiate
through the TORCH tier.
"""

import numpy as np
import torch

from xlb_tpu_torch.boundary.base import ImplementationStep
from xlb_tpu_torch.boundary.maskers import IndicesBoundaryMasker
from xlb_tpu_torch.cell_type import BC_SOLID
from xlb_tpu_torch.compute_backend import ComputeBackend
from xlb_tpu_torch.helper.check_boundary_overlaps import check_bc_overlaps
from xlb_tpu_torch.helper.nse_fields import create_nse_fields
from xlb_tpu_torch.models.stepper import Stepper
from xlb_tpu_torch.ops.equilibrium import LinearEquilibrium
from xlb_tpu_torch.ops.macroscopic import density
from xlb_tpu_torch.ops.stream import Stream


def omega_from_diffusivity(diffusivity):
    """omega_phi for a target lattice diffusivity D = (1/omega - 1/2)/3."""
    return 1.0 / (3.0 * float(diffusivity) + 0.5)


def diffusivity_from_omega(omega):
    return (1.0 / float(omega) - 0.5) / 3.0


def _require_pull(nse, what):
    if getattr(nse, "streaming_scheme", "pull") != "pull":
        raise NotImplementedError(f"{what} needs the pull streaming scheme")


class AdvectionDiffusionStepper(Stepper):
    """Scalar-transport LBM step: stream -> BCs -> phi moment -> linear
    equilibrium -> BGK relax -> BCs.

    Call: ``(g_0, g_1, bc_mask, missing_mask, omega_phi, u, timestep=0) ->
    (g_0, g_1)``, the caller swapping buffers as with the NSE stepper, with
    the advecting velocity ``u`` (d, *spatial) as an extra argument.
    """

    def __init__(self, grid, boundary_conditions=(), velocity_set=None, precision_policy=None, compute_backend=None):
        super().__init__(grid, boundary_conditions, velocity_set, precision_policy, compute_backend)
        common = dict(velocity_set=self.velocity_set, precision_policy=self.precision_policy,
                      compute_backend=self.compute_backend)
        self.stream = Stream(**common)
        self.equilibrium = LinearEquilibrium(**common)
        self._fused_step = None
        if self.compute_backend == ComputeBackend.CUDA:
            if grid.device.type != "cuda":
                raise ValueError(f"ComputeBackend.CUDA needs a grid on a CUDA device, got {grid.device}")
            from xlb_tpu_torch.kernels.fused_step import build_fused_ade_step

            self._fused_step = build_fused_ade_step(self)

    def prepare_fields(self, phi_init=None):
        """Allocate (g_0, g_1, bc_mask, missing_mask); ``phi_init`` is an
        optional (1, *shape) or (*shape) initial scalar field (default 0),
        a NumPy array or a tensor."""
        _, g_0, g_1, missing_mask, bc_mask = create_nse_fields(
            grid=self.grid, velocity_set=self.velocity_set, precision_policy=self.precision_policy
        )
        check_bc_overlaps(self.boundary_conditions, self.velocity_set.d)
        bcs = [bc for bc in self.boundary_conditions if bc.indices is not None]
        if bcs:
            masker = IndicesBoundaryMasker(velocity_set=self.velocity_set, precision_policy=self.precision_policy,
                                           compute_backend=self.compute_backend)
            bc_mask, missing_mask = masker(bcs, bc_mask, missing_mask)

        pp = self.precision_policy
        shape = tuple(self.grid.shape)
        if phi_init is None:
            phi = torch.zeros((1,) + shape, dtype=pp.compute_dtype, device=g_0.device)
        else:
            phi = torch.as_tensor(np.asarray(phi_init) if not isinstance(phi_init, torch.Tensor) else phi_init)
            phi = phi.to(device=g_0.device, dtype=pp.compute_dtype).reshape((1,) + shape)
        # the weights rounded to the store dtype, as xlb_tpu's NumPy weights
        w = torch.as_tensor(np.asarray(self.velocity_set._w, dtype=np.float64)).to(pp.store_dtype)
        w = w.to(device=g_0.device, dtype=pp.compute_dtype).reshape((-1,) + (1,) * len(shape))
        g_0 = (phi * w).to(pp.store_dtype)
        g_1 = g_1 + g_0
        return g_0, g_1, bc_mask, missing_mask

    def phi(self, g):
        """Zeroth moment: the transported scalar (1, *spatial)."""
        return density(self.precision_policy.cast_to_compute(g))

    def __call__(self, g_0, g_1, bc_mask, missing_mask, omega_phi, u, timestep=0):
        if self._fused_step is not None:
            return self._fused_step(g_0, g_1, bc_mask, missing_mask, omega_phi, u, timestep)
        pp = self.precision_policy
        g_0c = pp.cast_to_compute(g_0)

        g_post_stream = self.stream(g_0c)
        for bc in self.boundary_conditions:
            if bc.implementation_step == ImplementationStep.STREAMING:
                g_post_stream = bc(g_0c, g_post_stream, bc_mask, missing_mask)

        phi = density(g_post_stream)
        geq = self.equilibrium(phi, u.to(g_post_stream.dtype))
        g_post = g_post_stream - omega_phi * (g_post_stream - geq)

        for bc in self.boundary_conditions:
            if bc.implementation_step == ImplementationStep.COLLISION:
                g_post = bc(g_post_stream, g_post, bc_mask, missing_mask)

        # solid voxels (cell type 255) neither stream nor relax, as in the
        # NSE step and the kernels' keep-out
        if self.boundary_conditions:
            g_post = torch.where(bc_mask == BC_SOLID, g_0c, g_post)
        return g_0, pp.cast_to_store(g_post)


class ThermalNSEStepper:
    """Boussinesq-coupled NSE + ADE: buoyancy F = -beta (phi - phi_ref) g
    drives the flow; the flow advects the scalar.

    ``nse`` and ``ade`` are steppers on the same grid and velocity set
    (their BC lists may differ: no-slip walls for f, Dirichlet or adiabatic
    walls for g). One coupled step:

        f   <- NSE step with the exact-difference buoyancy of phi(g_0)
        g   <- ADE step advected by u of the updated f

    Call: ``(f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g, omega,
    omega_phi, timestep) -> (f_0, f_1, g_0, g_1)``.
    """

    def __init__(self, nse, ade, beta=1e-3, gravity=None, phi_ref=0.0):
        _require_pull(nse, "ThermalNSEStepper")
        self._fused_nse = None
        if nse.compute_backend == ComputeBackend.CUDA:
            # the per-voxel buoyancy as the forced kernel's field channels
            from xlb_tpu_torch.kernels.fused_step import build_fused_forced_step

            self._fused_nse = build_fused_forced_step(nse)
        self.nse = nse
        self.ade = ade
        self.beta = float(beta)
        d = nse.velocity_set.d
        self.gravity = np.asarray(gravity if gravity is not None else (0.0,) * (d - 1) + (-1.0,), dtype=np.float64)
        assert self.gravity.shape == (d,)
        self.phi_ref = float(phi_ref)

    def buoyancy(self, phi):
        """F = -beta (phi - phi_ref) g for the scalar phi (1, *spatial)."""
        grav = torch.as_tensor(self.gravity, device=phi.device).to(phi.dtype).reshape((-1,) + (1,) * (phi.ndim - 1))
        return -self.beta * (phi - self.phi_ref) * grav

    def __call__(self, f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g, omega, omega_phi, timestep=0):
        nse, ade = self.nse, self.ade
        # the scalar before the step drives this step's buoyancy
        force = self.buoyancy(ade.phi(g_0))
        if self._fused_nse is not None:
            f_0, f_1 = self._fused_nse(f_0, f_1, bc_f, miss_f, omega, force, timestep)
        else:
            f_0, f_1 = nse._step_pull(f_0, f_1, bc_f, miss_f, omega, timestep, force_field=force)
        # the scalar is advected by the post-stream velocity of the updated f
        _, u = nse.macroscopic(nse.precision_policy.cast_to_compute(f_1))
        g_0, g_1 = ade(g_0, g_1, bc_g, miss_g, omega_phi, u, timestep)
        return f_0, f_1, g_0, g_1

    def build_multi_step(self, num_steps):
        """``num_steps`` coupled steps: ``run(f_0, f_1, g_0, g_1, bc_f,
        miss_f, bc_g, miss_g, omega, omega_phi, start=0) -> (f_0, f_1, g_0,
        g_1)`` with f_0 and g_0 the current states (a plain loop of coupled
        steps; each is two kernel launches on the CUDA tier)."""

        def run(f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g, omega, omega_phi, start=0):
            for t in range(num_steps):
                f_0, f_1, g_0, g_1 = self(f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g, omega, omega_phi, start + t)
                f_0, f_1, g_0, g_1 = f_1, f_0, g_1, g_0
            return f_0, f_1, g_0, g_1

        return run
