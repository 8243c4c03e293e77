"""Single-resolution incompressible Navier-Stokes stepper.

``prepare_fields()`` builds (f_0, f_1, bc_mask, missing_mask) and the call
``stepper(f_0, f_1, bc_mask, missing_mask, omega, timestep) -> (f_0, f_1)``
advances one LBM step with the caller swapping buffers -- the interface of
``xlb_tpu.models.IncompressibleNavierStokesStepper``.

Two tiers:

- TORCH (default): the plain torch pull step below, on any device.
- CUDA: the fused collide-stream kernels (``xlb_tpu_torch.kernels``), 3D
  (D3Q19 and D3Q27) and 2D (D2Q9); one pass over device memory per step,
  or per k steps in a window. The grid must live on a CUDA device. In 3D
  every collision of the TORCH tier runs in the kernels, with the
  exact-difference body force and halfway walls, and on D3Q19 BGK and
  D3Q27 KBC the open boundaries (Zou-He, regularized, do-nothing,
  free-slip, extrapolation outflow, per-voxel prescriptions) and HybridBC;
  in 2D, BGK with halfway, Zou-He, regularized and HybridBC.

BCs take voxel ``indices`` or a triangle mesh (``mesh_vertices``), which
``prepare_fields`` voxelizes on the host (``geometry``), and then gives a
mesh HybridBC its per-link wall distances.

Both tiers differentiate with ``torch.autograd`` with respect to ``f_0``
and ``omega`` (a float or a 0-d tensor; the TORCH tier also takes a
per-voxel field). On the CUDA tier the backward of ``stepper(...)`` and of
``build_multi_step`` is the fused adjoint kernel
(``kernels/adjoint_step.py``), the 3D open boundaries and curved walls
included. In 2D, as in ``xlb_tpu``, the backward of ``stepper(...)`` is
the TORCH tier's VJP and the window has none (it raises under autograd).
The masks and BC prescriptions get no gradient. The per-voxel force of
``_step_pull(..., force_field)`` (the thermal and multiphase models,
``models/ade.py``, ``models/multiphase.py``) runs on the CUDA tier through
the forward-only ``kernels.fused_step.build_fused_forced_step``, as in
``xlb_tpu``: differentiate those models through the TORCH tier.
"""

import torch

from xlb_tpu_torch.cell_type import BC_SOLID
from xlb_tpu_torch.compute_backend import ComputeBackend
from xlb_tpu_torch.models.stepper import Stepper
from xlb_tpu_torch.ops.stream import Stream
from xlb_tpu_torch.ops.equilibrium import QuadraticEquilibrium, quadratic_equilibrium
from xlb_tpu_torch.ops.macroscopic import Macroscopic
from xlb_tpu_torch.ops.collision import BGK, KBC, MRT, TRT, ForcedCollision, PowerLawBGK, SmagorinskyLESBGK
from xlb_tpu_torch.boundary.base import ImplementationStep
from xlb_tpu_torch.boundary.maskers import IndicesBoundaryMasker
from xlb_tpu_torch.helper.check_boundary_overlaps import check_bc_overlaps
from xlb_tpu_torch.helper.nse_fields import create_nse_fields
from xlb_tpu_torch.helper.initializers import initialize_eq

_COLLISIONS = {"BGK": BGK, "KBC": KBC, "SmagorinskyLESBGK": SmagorinskyLESBGK, "TRT": TRT, "MRT": MRT,
               "PowerLawBGK": PowerLawBGK}


class IncompressibleNavierStokesStepper(Stepper):
    """Full LBM timestep: stream -> BCs -> macroscopic -> equilibrium ->
    collide -> BCs.

    Parameters
    ----------
    grid : Grid
    boundary_conditions : list of BoundaryCondition
    collision_type : {"BGK", "KBC", "SmagorinskyLESBGK", "TRT", "MRT", "PowerLawBGK"}
        ``xlb_tpu``'s push streaming scheme is not ported: this stepper
        pulls.
    collision_params : dict, optional
        Constructor arguments of the collision operator (TRT ``magic``, MRT
        ``bulk_rate`` / ``ghost_rate``, Smagorinsky ``smagorinsky_coef``,
        PowerLawBGK ``consistency`` / ``power_index`` / ``iterations``).
    forcing_scheme : str
        Only "exact_difference" (used when ``force_vector`` is given).
    force_vector : array-like, optional
        A constant body force, one entry per spatial dimension.
    """

    def __init__(
        self,
        grid,
        boundary_conditions=(),
        collision_type="BGK",
        forcing_scheme="exact_difference",
        force_vector=None,
        velocity_set=None,
        precision_policy=None,
        compute_backend=None,
        collision_params=None,
    ):
        super().__init__(grid, boundary_conditions, velocity_set, precision_policy, compute_backend)
        if collision_type not in _COLLISIONS:
            raise ValueError(f"unknown collision_type {collision_type!r}; choose from {sorted(_COLLISIONS)}")
        self.collision_type = collision_type

        common = dict(velocity_set=self.velocity_set, precision_policy=self.precision_policy, compute_backend=self.compute_backend)
        self.collision = _COLLISIONS[collision_type](**common, **(collision_params or {}))
        if force_vector is not None:
            self.collision = ForcedCollision(self.collision, forcing_scheme=forcing_scheme, force_vector=force_vector)
        self.stream = Stream(**common)
        self.equilibrium = QuadraticEquilibrium(**common)
        self.macroscopic = Macroscopic(**common)

        self._fused_step = None
        if self.compute_backend == ComputeBackend.CUDA:
            if grid.device.type != "cuda":
                raise ValueError(f"ComputeBackend.CUDA needs a grid on a CUDA device, got {grid.device}")
            from xlb_tpu_torch.kernels.fused_step import build_fused_step

            self._fused_step = build_fused_step(self)

    # ------------------------------------------------------------------
    # Setup path
    # ------------------------------------------------------------------
    def prepare_fields(self, initializer=None):
        """Allocate fields, rasterize BCs into the masks, and initialize f.

        ``initializer(bc_mask, f)``, e.g. ``helper.CustomInitializer``,
        replaces the rest-state equilibrium. Returns (f_0, f_1, bc_mask,
        missing_mask)."""
        _, f_0, f_1, missing_mask, bc_mask = create_nse_fields(
            grid=self.grid, velocity_set=self.velocity_set, precision_policy=self.precision_policy
        )
        bc_mask, missing_mask = self._process_boundary_conditions(self.boundary_conditions, bc_mask, missing_mask)

        # static hint for the fused kernels: a domain with no solid-tagged
        # voxels skips the solid keep-out
        self.has_solids = bool((bc_mask == BC_SOLID).any())

        if initializer is not None:
            f_0 = initializer(bc_mask, f_0)
        else:
            f_0 = initialize_eq(f_0, self.grid, self.velocity_set, self.precision_policy)
        f_1 = f_0.clone()
        return f_0, f_1, bc_mask, missing_mask

    def _process_boundary_conditions(self, boundary_conditions, bc_mask, missing_mask):
        check_bc_overlaps(boundary_conditions, self.velocity_set.d)
        for bc in boundary_conditions:
            if bc.indices is None and bc.mesh_vertices is None:
                raise ValueError(f"{type(bc).__name__} has neither indices nor mesh_vertices")
        with_indices = [bc for bc in boundary_conditions if bc.indices is not None]
        with_mesh = [bc for bc in boundary_conditions if bc.indices is None]
        for bc in with_mesh:
            # voxelize the mesh on the host; its solid voxels take the
            # indices path, after the BCs given by indices (as xlb_tpu)
            from xlb_tpu_torch.geometry.mesh_masker import assign_mesh_indices

            assign_mesh_indices(bc, self.grid)
            if bc.needs_mesh_distance:
                bc.compute_mesh_distances()
        boundary_conditions = with_indices + with_mesh
        if boundary_conditions:
            masker = IndicesBoundaryMasker(
                velocity_set=self.velocity_set,
                precision_policy=self.precision_policy,
                compute_backend=self.compute_backend,
            )
            bc_mask, missing_mask = masker(boundary_conditions, bc_mask, missing_mask)
        return bc_mask, missing_mask

    # ------------------------------------------------------------------
    # Hot loop
    # ------------------------------------------------------------------
    def __call__(self, f_0, f_1, bc_mask, missing_mask, omega, timestep=0):
        if self._fused_step is not None:
            return self._fused_step(f_0, f_1, bc_mask, missing_mask, omega, timestep)
        return self._step_pull(f_0, f_1, bc_mask, missing_mask, omega, timestep)

    def _step_pull(self, f_0, f_1, bc_mask, missing_mask, omega, timestep, force_field=None):
        """The TORCH-tier step; ``force_field`` (d, *spatial), when given,
        is a per-voxel exact-difference force (the field form of a constant
        ``force_vector``, with the same rho_0 = 1 convention): f +=
        feq(rho, u + F) - feq(rho, u) after the collision."""
        pp = self.precision_policy
        f_0c = pp.cast_to_compute(f_0)

        f_post_stream = self.stream(f_0c)
        for bc in self.boundary_conditions:
            if bc.implementation_step == ImplementationStep.STREAMING:
                f_post_stream = bc(f_0c, f_post_stream, bc_mask, missing_mask)

        rho, u = self.macroscopic(f_post_stream)
        feq = self.equilibrium(rho, u)
        f_post_collision = self.collision(f_post_stream, feq, omega)

        if force_field is not None:
            vs = self.velocity_set
            feq_shift = quadratic_equilibrium(rho, u + force_field.to(u.dtype), vs._c, vs._w, u.dtype)
            f_post_collision = f_post_collision + (feq_shift - feq)

        # staging for the next step (the extrapolation outflow), then the
        # collision-step BCs; the "pre-streaming" population a collision-step
        # BC reflects is the post-stream one
        for bc in self.boundary_conditions:
            f_post_collision = bc.assemble_auxiliary_data(f_post_stream, f_post_collision, bc_mask, missing_mask)
            if bc.implementation_step == ImplementationStep.COLLISION:
                f_post_collision = bc(f_post_stream, f_post_collision, bc_mask, missing_mask)

        # solid voxels (cell type 255) keep their previous populations
        f_post_collision = torch.where(bc_mask == BC_SOLID, f_0c, f_post_collision)
        return f_0, pp.cast_to_store(f_post_collision)

    # ------------------------------------------------------------------
    def build_multi_step(self, num_steps):
        """A ``num_steps``-step advance. The returned callable has signature
        ``(f_0, f_1, bc_mask, missing_mask, omega, start_step=0)`` and
        returns the post-window ``(f_0, f_1)`` with f_0 the current state.

        On the CUDA tier this is the fused window
        (``kernels.fused_step.build_fused_window``, k-step groups of 8 in
        2D and 2 in 3D): 16-bit storage runs in deviation form and returns
        f_0 in the compute dtype. Its backward (3D) keeps ``num_steps``
        states in the store dtype (memory = window x one field); chain
        windows under ``torch.utils.checkpoint`` to differentiate long
        rollouts."""
        if self.compute_backend == ComputeBackend.CUDA:
            from xlb_tpu_torch.kernels.fused_step import build_fused_window

            window = build_fused_window(self, num_steps)

            def _run_fused(f_0, f_1, bc_mask, missing_mask, omega, start_step=0):
                return window(f_0, f_1, bc_mask, missing_mask, omega)

            return _run_fused

        def _run(f_0, f_1, bc_mask, missing_mask, omega, start_step=0):
            for i in range(num_steps):
                f_0, f_1 = self(f_0, f_1, bc_mask, missing_mask, omega, start_step + i)
                f_0, f_1 = f_1, f_0
            return f_0, f_1

        return _run
