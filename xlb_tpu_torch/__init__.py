"""xlb_tpu_torch: the PyTorch / CUDA port of xlb_tpu.

The same scene API as ``xlb_tpu`` (``init``, ``grid_factory``, velocity
sets, BC classes, ``stepper.prepare_fields()``,
``stepper(f_0, f_1, bc_mask, missing_mask, omega, t)`` with the caller
swapping buffers), on torch tensors. Two tiers: ``ComputeBackend.TORCH``
runs plain torch ops on any device; ``ComputeBackend.CUDA`` runs the hot
loop through hand-written CUDA kernels for Hopper (``csrc/``), built with
``nvcc`` at first use.

Quick start::

    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.velocity_set import D3Q19

    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend.CUDA,
             default_precision_policy=xlb.PrecisionPolicy.FP32BF16)
    grid = xlb.grid_factory((256, 256, 256), device="cuda")
    ...

This package never imports JAX.
"""

from xlb_tpu_torch.compute_backend import ComputeBackend
from xlb_tpu_torch.precision_policy import Precision, PrecisionPolicy
from xlb_tpu_torch.physics_type import PhysicsType
from xlb_tpu_torch.cell_type import BC_NONE, BC_SFV, BC_SOLID
from xlb_tpu_torch.default_config import DefaultConfig, init
from xlb_tpu_torch.operator import Operator
from xlb_tpu_torch.grid import Grid, grid_factory
from xlb_tpu_torch import velocity_set
from xlb_tpu_torch import ops, boundary, models, helper, utils

__version__ = "0.1.0"

__all__ = [
    "ComputeBackend",
    "Precision",
    "PrecisionPolicy",
    "PhysicsType",
    "BC_NONE",
    "BC_SFV",
    "BC_SOLID",
    "DefaultConfig",
    "init",
    "Operator",
    "Grid",
    "grid_factory",
    "velocity_set",
    "ops",
    "boundary",
    "models",
    "helper",
    "utils",
]
