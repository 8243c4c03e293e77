from xlb_tpu_torch.grid.grid import Grid, grid_factory
from xlb_tpu_torch.grid.multires import MultiresGrid, MultiresLevel

__all__ = ["Grid", "grid_factory", "MultiresGrid", "MultiresLevel"]
