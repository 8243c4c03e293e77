from xlb_tpu_torch.models.stepper import Stepper
from xlb_tpu_torch.models.nse import IncompressibleNavierStokesStepper
from xlb_tpu_torch.models.multires import MultiresIncompressibleNavierStokesStepper, compute_omega
from xlb_tpu_torch.models.ade import (AdvectionDiffusionStepper, ThermalNSEStepper, diffusivity_from_omega,
                                      omega_from_diffusivity)
from xlb_tpu_torch.models.multiphase import ShanChenMultiphaseStepper

__all__ = ["Stepper", "IncompressibleNavierStokesStepper", "MultiresIncompressibleNavierStokesStepper", "compute_omega",
           "AdvectionDiffusionStepper", "ThermalNSEStepper", "ShanChenMultiphaseStepper", "omega_from_diffusivity",
           "diffusivity_from_omega"]
