"""Multi-resolution grid: nested dense cuboid levels with factor-2
refinement, as ``xlb_tpu.grid.multires``.

Level 0 is the FINEST; level l+1 is coarser by a factor of 2. Every finer
level occupies a box of the next-coarser level, given as (origin, extent)
in that level's cells; its own shape is 2 * extent. Every level's fields
live on the grid's ``torch.device`` -- the card unless the caller asks for
another device.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from xlb_tpu_torch.default_config import DefaultConfig
from xlb_tpu_torch.precision_policy import Precision


class MultiresLevel:
    """One resolution level: a dense box plus its placement in the parent."""

    def __init__(self, shape, origin_in_parent=None, extent_in_parent=None, device="cuda"):
        self.shape = tuple(int(s) for s in shape)
        self.dim = len(self.shape)
        self.origin_in_parent = tuple(int(o) for o in origin_in_parent) if origin_in_parent is not None else None
        self.extent_in_parent = tuple(int(e) for e in extent_in_parent) if extent_in_parent is not None else None
        self.device = torch.device(device)

    def create_field(self, cardinality, dtype=None, fill_value=None):
        """A ``(cardinality, *shape)`` field on the level's device."""
        if dtype is None:
            dtype = DefaultConfig.default_precision_policy.store_precision
        tdtype = dtype.torch_dtype if isinstance(dtype, Precision) else dtype
        full = (int(cardinality),) + self.shape
        if fill_value is not None:
            return torch.full(full, fill_value, dtype=tdtype, device=self.device)
        return torch.zeros(full, dtype=tdtype, device=self.device)


class MultiresGrid:
    """Nested levels, finest first.

    Parameters
    ----------
    coarsest_shape : tuple
        Cell extents of the coarsest level, which spans the whole domain.
    boxes : list of (origin, extent)
        One entry per finer level, outermost first: the box the next-finer
        level occupies, in the cells of the level it refines.
    device : torch.device or str
        Where every level's fields live; the current CUDA device by default.
    """

    def __init__(self, coarsest_shape: Tuple[int, ...], boxes: Sequence = (), device="cuda"):
        self.device = torch.device(device)
        levels_coarse_first: List[MultiresLevel] = [MultiresLevel(coarsest_shape, device=self.device)]
        for origin, extent in boxes:
            origin = tuple(int(o) for o in origin)
            extent = tuple(int(e) for e in extent)
            parent = levels_coarse_first[-1]
            for o, e, s in zip(origin, extent, parent.shape):
                if o < 0 or o + e > s:
                    raise ValueError(f"refinement box ({origin}, {extent}) exceeds parent shape {parent.shape}")
            levels_coarse_first.append(MultiresLevel(tuple(2 * e for e in extent), origin, extent, device=self.device))
        self.levels = list(reversed(levels_coarse_first))
        self.num_levels = len(self.levels)
        self.dim = len(coarsest_shape)

    @property
    def count_levels(self):
        return self.num_levels

    def level_to_shape(self, level):
        return self.levels[level].shape

    def level_origin_spacing(self, level):
        """(origin, spacing) of a level's voxel grid in coarsest-level
        (global) units: global = origin + index * spacing."""
        idx = self.num_levels - 1
        origin = np.zeros(self.dim, dtype=np.float64)
        spacing = 1.0
        while idx > level:
            child = self.levels[idx - 1]
            origin = origin + np.asarray(child.origin_in_parent, dtype=np.float64) * spacing
            spacing = spacing / 2.0
            idx -= 1
        return origin, spacing

    def finest_equivalent_cells(self):
        """Total cell count if the whole domain were at finest resolution."""
        return int(np.prod(self.levels[-1].shape)) * (2**self.dim) ** (self.num_levels - 1)

    def active_cells(self):
        """Cells actually simulated: each level's cells minus refined boxes."""
        total = 0
        for i, lvl in enumerate(self.levels):
            n = int(np.prod(lvl.shape))
            if i > 0:
                n -= int(np.prod(self.levels[i - 1].extent_in_parent))
            total += n
        return total

    def weighted_updates_per_coarse_step(self):
        """Lattice updates of one coarsest-level step: level l runs
        2^(L-1-l) sub-steps of its own cell count."""
        L = self.num_levels
        return sum(int(np.prod(lvl.shape)) * 2 ** (L - 1 - l) for l, lvl in enumerate(self.levels))
