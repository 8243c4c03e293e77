from xlb_tpu_torch.helper.nse_fields import create_nse_fields
from xlb_tpu_torch.helper.initializers import CustomInitializer, initialize_eq, initialize_from_macroscopic
from xlb_tpu_torch.helper.check_boundary_overlaps import check_bc_overlaps
from xlb_tpu_torch.helper.simulation_manager import MultiresSimulationManager

__all__ = ["create_nse_fields", "CustomInitializer", "initialize_eq", "initialize_from_macroscopic", "check_bc_overlaps", "MultiresSimulationManager"]
