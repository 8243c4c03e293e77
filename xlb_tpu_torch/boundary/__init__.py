from xlb_tpu_torch.boundary.registry import boundary_condition_registry, BoundaryConditionRegistry
from xlb_tpu_torch.boundary.base import BoundaryCondition, ImplementationStep
from xlb_tpu_torch.boundary.bc_equilibrium import EquilibriumBC
from xlb_tpu_torch.boundary.bc_bounce_back import FullwayBounceBackBC, HalfwayBounceBackBC
from xlb_tpu_torch.boundary.bc_zouhe import ZouHeBC
from xlb_tpu_torch.boundary.bc_regularized import RegularizedBC
from xlb_tpu_torch.boundary.maskers import IndicesBoundaryMasker

__all__ = [
    "boundary_condition_registry",
    "BoundaryConditionRegistry",
    "BoundaryCondition",
    "ImplementationStep",
    "EquilibriumBC",
    "FullwayBounceBackBC",
    "HalfwayBounceBackBC",
    "ZouHeBC",
    "RegularizedBC",
    "IndicesBoundaryMasker",
]
