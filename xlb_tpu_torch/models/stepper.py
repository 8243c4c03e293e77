"""Stepper base class."""

from xlb_tpu_torch.operator import Operator


class Stepper(Operator):
    """Holds the grid and BC list; concrete steppers implement
    ``prepare_fields`` and ``__call__``."""

    def __init__(self, grid, boundary_conditions=(), velocity_set=None, precision_policy=None, compute_backend=None):
        super().__init__(velocity_set, precision_policy, compute_backend)
        self.grid = grid
        self.boundary_conditions = list(boundary_conditions)

    def prepare_fields(self, initializer=None):
        raise NotImplementedError
