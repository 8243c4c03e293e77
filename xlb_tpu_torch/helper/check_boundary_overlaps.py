"""Duplicate-index detection across a BC list: overlapping voxel claims
between two BCs are a setup bug (the last writer would win in the masker),
so raise."""

import numpy as np


def check_bc_overlaps(bclist, dim):
    claims = [np.asarray(bc.indices, dtype=np.int64).reshape(dim, -1) for bc in bclist if bc.indices is not None]
    if not claims or not sum(c.shape[1] for c in claims):
        return

    indices = np.concatenate(claims, axis=1).T
    unique, counts = np.unique(indices, axis=0, return_counts=True)
    duplicates = unique[counts > 1]
    if duplicates.size:
        raise ValueError(
            f"boundary conditions overlap at voxels {duplicates[:10].tolist()}" + (" ..." if len(duplicates) > 10 else "")
        )
