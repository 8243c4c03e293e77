from xlb_tpu_torch.ops.stream import Stream
from xlb_tpu_torch.ops.equilibrium import Equilibrium, QuadraticEquilibrium
from xlb_tpu_torch.ops.macroscopic import Macroscopic
from xlb_tpu_torch.ops.collision import Collision, BGK

__all__ = [
    "Stream",
    "Equilibrium",
    "QuadraticEquilibrium",
    "Macroscopic",
    "Collision",
    "BGK",
]
