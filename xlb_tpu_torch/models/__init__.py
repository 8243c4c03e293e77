from xlb_tpu_torch.models.stepper import Stepper
from xlb_tpu_torch.models.nse import IncompressibleNavierStokesStepper

__all__ = ["Stepper", "IncompressibleNavierStokesStepper"]
