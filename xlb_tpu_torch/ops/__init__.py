from xlb_tpu_torch.ops.stream import Stream
from xlb_tpu_torch.ops.equilibrium import Equilibrium, LinearEquilibrium, QuadraticEquilibrium
from xlb_tpu_torch.ops.macroscopic import Macroscopic, SecondMoment
from xlb_tpu_torch.ops.collision import (BGK, KBC, MRT, TRT, Collision, ForcedCollision, PowerLawBGK,
                                         SmagorinskyLESBGK)
from xlb_tpu_torch.ops.force import ExactDifference, FetchPopulations, LBMOperationSequence, MomentumTransfer

__all__ = [
    "Stream",
    "Equilibrium",
    "QuadraticEquilibrium",
    "LinearEquilibrium",
    "Macroscopic",
    "SecondMoment",
    "Collision",
    "BGK",
    "KBC",
    "SmagorinskyLESBGK",
    "PowerLawBGK",
    "TRT",
    "MRT",
    "ForcedCollision",
    "ExactDifference",
    "FetchPopulations",
    "LBMOperationSequence",
    "MomentumTransfer",
]
