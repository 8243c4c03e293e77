"""Multi-resolution simulation manager, the port of
``xlb_tpu.helper.simulation_manager``: owns the per-level fields, steps
the coarsest level and exports the per-level macroscopic fields. Fields
live on the grid's device (the card unless the grid was built with
``device="cpu"``)."""

import numpy as np

from xlb_tpu_torch.models.multires import MultiresIncompressibleNavierStokesStepper, compute_omega
from xlb_tpu_torch.ops.macroscopic import Macroscopic


class MultiresSimulationManager:
    def __init__(self, grid, omega_finest, boundary_conditions=None, collision_type="BGK", initializer=None,
                 mres_perf_opt=None):
        self.grid = grid
        self.omega = float(omega_finest)
        self.stepper = MultiresIncompressibleNavierStokesStepper(
            grid, boundary_conditions=boundary_conditions, collision_type=collision_type, mres_perf_opt=mres_perf_opt
        )
        self.f_0, self.f_1, self.bc_mask, self.missing_mask = self.stepper.prepare_fields()
        if initializer is not None:
            self.f_0 = initializer(self.f_0)
        self.iteration_idx = 0
        self._window_n = None
        self._window = None

    def compute_omega(self, omega_finest, level):
        return compute_omega(omega_finest, level)

    def step(self):
        """Advance one coarsest-level step (2^(L-1) finest steps)."""
        self.f_0 = self.stepper(self.f_0, self.bc_mask, self.missing_mask, self.omega)
        self.iteration_idx += 1
        return self.f_0

    def run(self, num_coarse_steps, window=None):
        """Advance ``num_coarse_steps`` in windows of ``window`` coarse steps
        (all of them by default; ``stepper.build_window``), the remainder
        through ``step``."""
        window = num_coarse_steps if window is None else min(window, num_coarse_steps)
        if window > 0 and self._window_n != window:
            self._window_n = window
            self._window = self.stepper.build_window(window)
        done = 0
        while window > 0 and done + window <= num_coarse_steps:
            self.f_0 = self._window(self.f_0, self.bc_mask, self.missing_mask, self.omega)
            self.iteration_idx += window
            done += window
        for _ in range(num_coarse_steps - done):
            self.step()
        return self.f_0

    def export_macroscopic(self):
        """Per-level (rho, u) as NumPy arrays, finest first."""
        mac = Macroscopic(velocity_set=self.stepper.velocity_set, precision_policy=self.stepper.precision_policy)
        out = []
        for f in self.f_0:
            rho, u = mac(f.float())
            out.append((rho.cpu().numpy(), u.cpu().numpy()))
        return out
