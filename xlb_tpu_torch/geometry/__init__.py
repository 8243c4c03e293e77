from xlb_tpu_torch.geometry.stl import (
    load_stl,
    save_stl,
    transform_mesh,
    rotation_matrix,
    sphere_triangles,
    naca_airfoil_triangles,
    turbine_rotor_triangles,
)
from xlb_tpu_torch.geometry.voxelize import MeshVoxelizationMethod, voxelize, voxelize_stl, winding_number, solid_voxel_indices
from xlb_tpu_torch.geometry.mesh_masker import assign_mesh_indices

__all__ = [
    "load_stl",
    "save_stl",
    "transform_mesh",
    "rotation_matrix",
    "sphere_triangles",
    "naca_airfoil_triangles",
    "turbine_rotor_triangles",
    "MeshVoxelizationMethod",
    "voxelize",
    "voxelize_stl",
    "winding_number",
    "solid_voxel_indices",
    "assign_mesh_indices",
]
