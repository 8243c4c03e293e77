from xlb_tpu_torch.velocity_set.velocity_set import VelocitySet
from xlb_tpu_torch.velocity_set.stencils import D2Q9, D3Q19, D3Q27

__all__ = ["VelocitySet", "D2Q9", "D3Q19", "D3Q27"]
