"""Boundary maskers: rasterize BC lists into ``bc_mask`` / ``missing_mask``.

:class:`IndicesBoundaryMasker` runs the pad -> tag -> stream -> crop
algorithm of ``xlb_tpu.boundary.maskers``:

1. pad the domain by one voxel, marking the exterior as "missing source";
2. tag solid voxels of interior geometry as missing sources too, and give
   the BC id to the dilated shell around them; a fluid-side BC
   (``needs_padding``) tags the solid voxels themselves cell type 255, so
   the steppers keep them out;
3. pull-stream the boolean mask once: direction l of voxel x becomes missing
   iff its pull source x - c_l is a missing source;
4. crop the padding and write BC ids into ``bc_mask``.

It runs once at setup time, on the grid's device.
"""

import numpy as np
import torch

from xlb_tpu_torch.cell_type import BC_SOLID
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
            bc_indices = np.asarray(bc.indices)
            solid = None
            if self._interior_flags(bc_indices, grid_shape).any():
                # interior geometry: the given indices are solid voxels and
                # missing sources for their neighbours; the BC claims the
                # dilated shell
                solid = as_index(bc_indices + 1)
                miss_ext[(slice(None),) + solid] = True
                tag = as_index(bc.pad_indices() + 1)
            else:
                tag = as_index(bc_indices + 1)
            bc_ext[tag] = bc.id
            if solid is not None and bc.needs_padding:
                bc_ext[solid] = BC_SOLID

        miss_ext = stream_pull(miss_ext, self.velocity_set._c)

        missing_mask = miss_ext[(slice(None),) + interior].contiguous()
        bc_mask = bc_mask.clone()
        bc_mask[0] = bc_ext[interior]
        return bc_mask, missing_mask
