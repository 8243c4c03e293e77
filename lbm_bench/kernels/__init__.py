"""Kernel families, one file each (``<family>.py``): the profiler names a
family matches (``matches``), the launch counters of its forms in the
port (``COUNTERS``), and its bytes and operations per call (``work``),
worked out from a cell's sizes (``cell_sizes``)."""

Q = {"D2Q9": 9, "D3Q19": 19, "D3Q27": 27}
STORE_BYTES = {"f32": 4, "bf16": 2}


def cell_sizes(cell):
    """(voxels, q, store bytes, shifted storage, aux bytes per call) of a
    cell: ``shape``, ``velocity_set``, ``storage``, and the aux field's
    float32 channels at the voxels of each boundary with a per-voxel
    ``profile`` (``profile_voxels``, ``profile_channels``)."""
    n = 1
    for s in cell["shape"]:
        n *= int(s)
    aux = sum(4 * c * v for c, v in zip(cell["profile_channels"], cell["profile_voxels"]))
    return n, Q[cell["velocity_set"]], STORE_BYTES[cell["storage"]], cell["storage"] != "f32", aux
