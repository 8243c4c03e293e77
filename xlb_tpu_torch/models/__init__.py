from xlb_tpu_torch.models.stepper import Stepper
from xlb_tpu_torch.models.nse import IncompressibleNavierStokesStepper
from xlb_tpu_torch.models.multires import MultiresIncompressibleNavierStokesStepper, compute_omega

__all__ = ["Stepper", "IncompressibleNavierStokesStepper", "MultiresIncompressibleNavierStokesStepper", "compute_omega"]
