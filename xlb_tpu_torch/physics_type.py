"""Physics-type enum (the members of ``xlb_tpu.physics_type``)."""

from enum import Enum, auto


class PhysicsType(Enum):
    NSE = auto()  # incompressible Navier-Stokes
    ADE = auto()  # advection-diffusion (not yet ported)
