from xlb_tpu_torch.boundary.registry import boundary_condition_registry, BoundaryConditionRegistry
from xlb_tpu_torch.boundary.base import BoundaryCondition, ImplementationStep
from xlb_tpu_torch.boundary.bc_equilibrium import EquilibriumBC
from xlb_tpu_torch.boundary.bc_do_nothing import DoNothingBC
from xlb_tpu_torch.boundary.bc_bounce_back import FullwayBounceBackBC, HalfwayBounceBackBC
from xlb_tpu_torch.boundary.bc_free_slip import FreeSlipBC
from xlb_tpu_torch.boundary.bc_zouhe import ZouHeBC
from xlb_tpu_torch.boundary.bc_regularized import RegularizedBC
from xlb_tpu_torch.boundary.bc_extrapolation_outflow import ExtrapolationOutflowBC
from xlb_tpu_torch.boundary.bc_hybrid import HybridBC
from xlb_tpu_torch.boundary.maskers import IndicesBoundaryMasker

__all__ = [
    "boundary_condition_registry",
    "BoundaryConditionRegistry",
    "BoundaryCondition",
    "ImplementationStep",
    "EquilibriumBC",
    "DoNothingBC",
    "FullwayBounceBackBC",
    "HalfwayBounceBackBC",
    "FreeSlipBC",
    "ZouHeBC",
    "RegularizedBC",
    "ExtrapolationOutflowBC",
    "HybridBC",
    "IndicesBoundaryMasker",
]

