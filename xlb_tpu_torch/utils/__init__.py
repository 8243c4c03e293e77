from xlb_tpu_torch.utils.interop import (aux_from_numpy, cotangent_from_numpy, fields_from_numpy, fields_to_numpy,
                                        gradients_to_numpy, level_fields_from_numpy, level_fields_to_numpy)
from xlb_tpu_torch.utils.units import omega_from_reynolds, viscosity_from_omega

__all__ = [
    "aux_from_numpy",
    "cotangent_from_numpy",
    "fields_from_numpy",
    "fields_to_numpy",
    "gradients_to_numpy",
    "level_fields_from_numpy",
    "level_fields_to_numpy",
    "omega_from_reynolds",
    "viscosity_from_omega",
]
