"""Mesh-based boundary masking: voxelize a BC's mesh into voxel indices
(``xlb_tpu.geometry.mesh_masker``). The solid voxel indices feed the
IndicesBoundaryMasker's interior-geometry path (pad -> tag -> stream ->
crop), which computes the missing directions.
"""

import numpy as np

from xlb_tpu_torch.geometry.voxelize import MeshVoxelizationMethod, voxelize, solid_voxel_indices


def assign_mesh_indices(bc, grid, spacing=1.0, origin=(0.0, 0.0, 0.0)):
    """Voxelize ``bc.mesh_vertices`` onto ``grid`` and set ``bc.indices``.

    ``mesh_vertices`` may be (n_tri, 3, 3) triangles or a flat (3k, 3)
    vertex array (every 3 rows one triangle), in grid coordinates (a voxel
    spans a unit cube; mesh coordinates == voxel coordinates by default).
    """
    tris = np.asarray(bc.mesh_vertices, dtype=np.float64)
    if tris.ndim == 2:
        if tris.shape[0] % 3:
            raise ValueError("flat mesh_vertices must contain 3 vertices per triangle")
        tris = tris.reshape(-1, 3, 3)

    method = bc.voxelization_method or MeshVoxelizationMethod.RAY
    options = {}
    if isinstance(method, tuple):
        method, options = method
    if hasattr(method, "options"):
        options = dict(getattr(method, "options") or {})
        method = getattr(method, "method", method)

    solid = voxelize(
        tris,
        grid.shape,
        origin=origin,
        spacing=spacing,
        method=method,
        close_voxels=options.get("close_voxels", 2),
    )
    if not solid.any():
        raise ValueError(f"voxelization of {type(bc).__name__} produced no solid voxels; check mesh placement")
    bc.indices = solid_voxel_indices(solid).tolist()
    return bc
