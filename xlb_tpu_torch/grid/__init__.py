from xlb_tpu_torch.grid.grid import Grid, grid_factory

__all__ = ["Grid", "grid_factory"]
