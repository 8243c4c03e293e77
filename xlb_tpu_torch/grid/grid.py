"""Single-device computational grid.

Fields live on the grid's ``torch.device``: the card (``"cuda"``) unless
the caller asks for another device, e.g. ``device="cpu"``. There is no
mesh and no fallback: without CUDA, a grid left on its default device
raises torch's own error as soon as it allocates a field. Fields created by :meth:`Grid.create_field`
have shape ``(cardinality, *shape)``, the layout of ``xlb_tpu``.
"""

from typing import Tuple

import numpy as np
import torch

from xlb_tpu_torch.default_config import DefaultConfig
from xlb_tpu_torch.precision_policy import Precision


class Grid:
    """A dense rectangular domain on one device.

    Parameters
    ----------
    shape : tuple of int
        Spatial extents ``(nx, ny[, nz])``.
    device : torch.device or str
        Where every field of this grid is allocated; the current CUDA
        device by default.
    """

    def __init__(self, shape: Tuple[int, ...], device="cuda"):
        self.shape = tuple(int(s) for s in shape)
        self.dim = len(self.shape)
        if self.dim not in (2, 3):
            raise ValueError(f"grid must be 2-D or 3-D, got shape {shape}")
        self.device = torch.device(device)

    def create_field(self, cardinality: int, dtype=None, fill_value=None):
        """Allocate a ``(cardinality, *shape)`` field on ``self.device``."""
        if dtype is None:
            dtype = DefaultConfig.default_precision_policy.store_precision
        tdtype = dtype.torch_dtype if isinstance(dtype, Precision) else dtype
        full_shape = (int(cardinality),) + self.shape
        if fill_value is not None:
            return torch.full(full_shape, fill_value, dtype=tdtype, device=self.device)
        return torch.zeros(full_shape, dtype=tdtype, device=self.device)

    def bounding_box_indices(self, shape=None, remove_edges=False):
        """Per-face voxel index lists of the domain's outer shell.

        Returns a dict mapping face names to ``(dim, n)`` nested lists, with
        ``remove_edges`` trimming the first/last rows of each face so that
        edge/corner voxels are not claimed by two faces.
        """
        shape = tuple(shape) if shape is not None else self.shape
        lo = 1 if remove_edges else 0
        grid = np.indices(shape)
        d = len(shape)

        if d == 2:
            nx, ny = shape
            sx = slice(lo, nx - lo)
            sy = slice(lo, ny - lo)
            faces = {
                "bottom": grid[:, sx, 0],
                "top": grid[:, sx, ny - 1],
                "left": grid[:, 0, sy],
                "right": grid[:, nx - 1, sy],
            }
        else:
            nx, ny, nz = shape
            sx = slice(lo, nx - lo)
            sy = slice(lo, ny - lo)
            sz = slice(lo, nz - lo)
            faces = {
                "bottom": grid[:, sx, sy, 0].reshape(3, -1),
                "top": grid[:, sx, sy, nz - 1].reshape(3, -1),
                "left": grid[:, 0, sy, sz].reshape(3, -1),
                "right": grid[:, nx - 1, sy, sz].reshape(3, -1),
                "front": grid[:, sx, 0, sz].reshape(3, -1),
                "back": grid[:, sx, ny - 1, sz].reshape(3, -1),
            }
        return {k: v.reshape(d, -1).tolist() for k, v in faces.items()}

    def __repr__(self):
        return f"Grid(shape={self.shape}, device={self.device})"


def grid_factory(shape, compute_backend=None, velocity_set=None, device="cuda"):
    """Create a grid on ``device`` (the card unless the caller asks for
    another device).

    ``compute_backend`` / ``velocity_set`` are accepted for signature parity
    with ``xlb_tpu.grid_factory``; one grid serves both tiers.
    """
    return Grid(shape, device=device)
