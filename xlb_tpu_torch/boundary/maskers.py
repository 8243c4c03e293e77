"""Boundary maskers: rasterize BC lists into ``bc_mask`` / ``missing_mask``.

:class:`IndicesBoundaryMasker` runs the pad -> tag -> stream -> crop
algorithm of ``xlb_tpu.boundary.maskers``:

1. pad the domain by one voxel, marking the exterior as "missing source";
2. tag solid voxels of interior geometry as missing sources too;
3. pull-stream the boolean mask once: direction l of voxel x becomes missing
   iff its pull source x - c_l is a missing source;
4. crop the padding and write BC ids into ``bc_mask``.

It runs once at setup time, on the grid's device.
"""

import numpy as np
import torch

from xlb_tpu_torch.operator import Operator
from xlb_tpu_torch.ops.stream import stream_pull


class IndicesBoundaryMasker(Operator):
    def _interior_flags(self, indices, shape):
        """True per index column when strictly inside the domain (not on the
        outer shell)."""
        d = self.velocity_set.d
        shape = np.asarray(shape)
        idx = np.asarray(indices)[:d]
        return np.all((idx > 0) & (idx < shape[:d, None] - 1), axis=0)

    def __call__(self, bclist, bc_mask, missing_mask):
        d = self.velocity_set.d
        grid_shape = tuple(bc_mask.shape[1:])
        device = bc_mask.device

        interior = (slice(1, -1),) * d
        bc_ext = torch.zeros(tuple(s + 2 for s in grid_shape), dtype=bc_mask.dtype, device=device)
        bc_ext[interior] = bc_mask[0]
        miss_ext = torch.ones((missing_mask.shape[0],) + tuple(s + 2 for s in grid_shape), dtype=torch.bool, device=device)
        miss_ext[(slice(None),) + interior] = missing_mask

        def as_index(idx):
            return tuple(torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device))

        for bc in bclist:
            if bc.indices is None:
                raise ValueError(f"{type(bc).__name__} has no indices")
            padded = as_index(np.asarray(bc.indices) + 1)
            if self._interior_flags(bc.indices, grid_shape).any():
                # interior geometry: the given indices are solid voxels and
                # missing sources for their neighbours
                miss_ext[(slice(None),) + padded] = True
            bc_ext[padded] = bc.id

        miss_ext = stream_pull(miss_ext, self.velocity_set._c)

        missing_mask = miss_ext[(slice(None),) + interior].contiguous()
        bc_mask = bc_mask.clone()
        bc_mask[0] = bc_ext[interior]
        return bc_mask, missing_mask
