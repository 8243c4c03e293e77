from xlb_tpu_torch.ops.stream import Stream
from xlb_tpu_torch.ops.equilibrium import Equilibrium, QuadraticEquilibrium
from xlb_tpu_torch.ops.macroscopic import Macroscopic, SecondMoment
from xlb_tpu_torch.ops.collision import Collision, BGK
from xlb_tpu_torch.ops.force import FetchPopulations, LBMOperationSequence, MomentumTransfer

__all__ = [
    "Stream",
    "Equilibrium",
    "QuadraticEquilibrium",
    "Macroscopic",
    "SecondMoment",
    "Collision",
    "BGK",
    "FetchPopulations",
    "LBMOperationSequence",
    "MomentumTransfer",
]
