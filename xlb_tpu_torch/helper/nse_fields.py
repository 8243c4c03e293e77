"""Field factory for Navier-Stokes simulations: the double-buffered
populations (store precision), the uint8 ``bc_mask`` and the boolean
``missing_mask``, all on the grid's device."""

from xlb_tpu_torch.default_config import DefaultConfig
from xlb_tpu_torch.grid import grid_factory
from xlb_tpu_torch.precision_policy import Precision


def create_nse_fields(grid_shape=None, grid=None, velocity_set=None, compute_backend=None, precision_policy=None, device="cuda"):
    velocity_set = velocity_set or DefaultConfig.velocity_set
    precision_policy = precision_policy or DefaultConfig.default_precision_policy

    if grid is None:
        if grid_shape is None:
            raise ValueError("grid_shape must be provided when grid is None")
        grid = grid_factory(grid_shape, compute_backend=compute_backend, velocity_set=velocity_set, device=device)

    f_0 = grid.create_field(cardinality=velocity_set.q, dtype=precision_policy.store_precision)
    f_1 = grid.create_field(cardinality=velocity_set.q, dtype=precision_policy.store_precision)
    bc_mask = grid.create_field(cardinality=1, dtype=Precision.UINT8)
    missing_mask = grid.create_field(cardinality=velocity_set.q, dtype=Precision.BOOL)
    return grid, f_0, f_1, missing_mask, bc_mask
