"""Host-side mesh voxelization -- the port of ``xlb_tpu.geometry.voxelize``.

Voxelization is a setup-time operation: it runs on the host with
vectorized NumPy (accelerated by the C++ voxelizer of
``xlb_tpu_torch/geometry/native``, the same source as ``xlb_tpu``'s, built
with g++ at first use) and only the resulting voxel indices reach the
device.

Methods (parity with MeshVoxelizationMethod, mesh_voxelization_method.py:13-52):

- ``RAY``   -- column-parity solid fill: count z-ray crossings per (x, y)
  column; odd parity = inside.  Robust for watertight meshes, O(T + V).
- ``AABB``  -- conservative surface shell (triangle/voxel overlap) plus
  parity fill of the interior.
- ``AABB_CLOSE`` -- AABB followed by morphological closing with
  ``close_voxels`` iterations (plugs leaky meshes).
- ``WINDING`` -- generalized winding number (Jacobson et al. 2013) per
  voxel; robust to non-watertight meshes.  O(T * V) over the voxels near
  the mesh (``winding_candidates``; the others provably have |w| < 1/2) --
  use for small domains or let the native extension handle it.
"""

from enum import Enum

import numpy as np


class MeshVoxelizationMethod(Enum):
    AABB = 1
    RAY = 2
    AABB_CLOSE = 3
    WINDING = 4

    @classmethod
    def from_name(cls, name, **options):
        method = cls[name.upper()] if isinstance(name, str) else name
        method_options = dict(options)
        return method, method_options

    @property
    def id(self):
        return self.value


def _ray_crossings_z(triangles, shape, origin, spacing):
    """For every (x, y) voxel-center column, the sorted z-positions where an
    upward ray crosses the mesh.  Returns a dense crossing-parity volume."""
    nx, ny, nz = shape
    solid = np.zeros(shape, dtype=bool)

    v0, v1, v2 = triangles[:, 0], triangles[:, 1], triangles[:, 2]
    # voxel-center coordinates in mesh space
    xs = origin[0] + (np.arange(nx) + 0.5) * spacing
    ys = origin[1] + (np.arange(ny) + 0.5) * spacing

    # process triangles grouped by x-slab to bound memory
    tri_xmin = triangles[:, :, 0].min(axis=1)
    tri_xmax = triangles[:, :, 0].max(axis=1)

    for ix, x in enumerate(xs):
        sel = (tri_xmin <= x) & (tri_xmax >= x)
        if not sel.any():
            continue
        a, b, c = v0[sel], v1[sel], v2[sel]
        # 2D point-in-triangle in the (x, y) plane via barycentric coords
        for iy_chunk in range(0, ny, 64):
            yy = ys[iy_chunk : iy_chunk + 64]
            # barycentric setup: solve for (w1, w2) with triangle projected
            d00 = (b[:, 0] - a[:, 0])[None, :]
            d01 = (b[:, 1] - a[:, 1])[None, :]
            d10 = (c[:, 0] - a[:, 0])[None, :]
            d11 = (c[:, 1] - a[:, 1])[None, :]
            px = x - a[:, 0][None, :]
            py = yy[:, None] - a[:, 1][None, :]
            det = d00 * d11 - d10 * d01
            with np.errstate(divide="ignore", invalid="ignore"):
                w1 = (px * d11 - py * d10) / det
                w2 = (py * d00 - px * d01) / det
            with np.errstate(invalid="ignore"):
                inside = (w1 >= 0) & (w2 >= 0) & (w1 + w2 <= 1) & (np.abs(det) > 1e-30)
            if not inside.any():
                continue
            zhit = a[:, 2][None, :] + w1 * (b[:, 2] - a[:, 2])[None, :] + w2 * (c[:, 2] - a[:, 2])[None, :]
            zhit = np.where(inside, zhit, np.inf)
            # crossing parity per voxel: z-center > zhit toggles
            z_centers = origin[2] + (np.arange(nz) + 0.5) * spacing
            # count crossings below each voxel center
            counts = (zhit[:, :, None] < z_centers[None, None, :]) & inside[:, :, None]
            parity = counts.sum(axis=1) % 2  # sum over triangles
            solid[ix, iy_chunk : iy_chunk + 64, :] |= parity.astype(bool)
    return solid


def _triangle_shell(triangles, shape, origin, spacing):
    """Conservative voxel shell: voxels whose cell AABB intersects a
    triangle's AABB (cheap superset of exact tri-box overlap; one cell in
    size, adequate for tagging the boundary shell)."""
    shell = np.zeros(shape, dtype=bool)
    tmin = (triangles.min(axis=1) - origin) / spacing
    tmax = (triangles.max(axis=1) - origin) / spacing
    lo = np.clip(np.floor(tmin).astype(int), 0, np.asarray(shape) - 1)
    hi = np.clip(np.floor(tmax).astype(int), 0, np.asarray(shape) - 1)
    span = hi - lo
    # subdivide large triangles so the AABB approximation stays tight
    order = np.argsort(-span.sum(axis=1))
    for t in order:
        l, h = lo[t], hi[t]
        if (h - l).max() <= 1:
            shell[l[0] : h[0] + 1, l[1] : h[1] + 1, l[2] : h[2] + 1] = True
        else:
            # split the triangle and recurse (midpoint subdivision)
            tri = triangles[t]
            m01 = 0.5 * (tri[0] + tri[1])
            m12 = 0.5 * (tri[1] + tri[2])
            m20 = 0.5 * (tri[2] + tri[0])
            sub = np.array([[tri[0], m01, m20], [tri[1], m12, m01], [tri[2], m20, m12], [m01, m12, m20]])
            shell |= _triangle_shell(sub, shape, origin, spacing)
    return shell


def _dilate(mask, iterations=1):
    out = mask.copy()
    for _ in range(iterations):
        grown = out.copy()
        for axis in range(3):
            grown |= np.roll(out, 1, axis=axis) | np.roll(out, -1, axis=axis)
        out = grown
    return out


def _erode(mask, iterations=1):
    return ~_dilate(~mask, iterations)


def winding_number(points, triangles):
    """Generalized winding number of ``points`` (n, 3) wrt ``triangles``
    (t, 3, 3) via the solid-angle formula (van Oosterom & Strackee)."""
    p = points[:, None, :]
    a = triangles[None, :, 0, :] - p
    b = triangles[None, :, 1, :] - p
    c = triangles[None, :, 2, :] - p
    la = np.linalg.norm(a, axis=-1)
    lb = np.linalg.norm(b, axis=-1)
    lc = np.linalg.norm(c, axis=-1)
    numer = np.einsum("ntk,ntk->nt", a, np.cross(b, c))
    denom = la * lb * lc + np.einsum("ntk,ntk->nt", a, b) * lc + np.einsum("ntk,ntk->nt", b, c) * la + np.einsum("ntk,ntk->nt", c, a) * lb
    omega = 2.0 * np.arctan2(numer, denom)
    return omega.sum(axis=1) / (4.0 * np.pi)


def winding_candidates(triangles, shape, origin=(0.0, 0.0, 0.0), spacing=1.0):
    """The voxels whose winding number may exceed 1/2: those whose centre
    lies within sqrt(A / 2 pi) of the mesh's bounding box, A the summed
    triangle area. Elsewhere |w| <= A / (4 pi r^2) < 1/2 (a triangle at
    distance >= r subtends at most its area / r^2 of solid angle), so
    WINDING needs no evaluation there; a 1% margin covers roundoff.
    Returns a boolean mask of ``shape``."""
    triangles = np.asarray(triangles, dtype=np.float64)
    area = 0.5 * np.linalg.norm(np.cross(triangles[:, 1] - triangles[:, 0], triangles[:, 2] - triangles[:, 0]),
                                axis=-1).sum()
    lo, hi = triangles.min(axis=(0, 1)), triangles.max(axis=(0, 1))
    r2 = 1.01 * area / (2.0 * np.pi)
    d2 = 0.0
    for a, n in enumerate(shape):
        x = origin[a] + (np.arange(n) + 0.5) * spacing
        gap = np.maximum(np.maximum(lo[a] - x, x - hi[a]), 0.0)
        d2 = d2 + (gap**2).reshape((1,) * a + (n,) + (1,) * (len(shape) - a - 1))
    return d2 <= r2


def voxelize(triangles, shape, origin=(0.0, 0.0, 0.0), spacing=1.0, method=MeshVoxelizationMethod.RAY, close_voxels=2):
    """Voxelize triangles into a boolean solid mask of ``shape``.

    ``origin``/``spacing`` map voxel (i, j, k) centers to mesh coordinates
    ``origin + (ijk + 0.5) * spacing``.
    """
    triangles = np.asarray(triangles, dtype=np.float64)
    origin = np.asarray(origin, dtype=np.float64)
    spacing = float(spacing)
    if isinstance(method, str):
        method = MeshVoxelizationMethod[method.upper()]

    try:
        from xlb_tpu_torch.geometry.native import voxelize_native

        native = voxelize_native(triangles, shape, origin, spacing, method.name, close_voxels)
        if native is not None:
            return native
    except ImportError:
        pass

    if method == MeshVoxelizationMethod.RAY:
        return _ray_crossings_z(triangles, shape, origin, spacing)
    if method == MeshVoxelizationMethod.AABB:
        shell = _triangle_shell(triangles, shape, origin, spacing)
        return shell | _ray_crossings_z(triangles, shape, origin, spacing)
    if method == MeshVoxelizationMethod.AABB_CLOSE:
        shell = _triangle_shell(triangles, shape, origin, spacing)
        closed = _erode(_dilate(shell, close_voxels), close_voxels)
        return closed | _ray_crossings_z(triangles, shape, origin, spacing)
    if method == MeshVoxelizationMethod.WINDING:
        cand = winding_candidates(triangles, shape, origin, spacing)
        points = origin + (np.stack(np.nonzero(cand), axis=-1) + 0.5) * spacing
        # chunk to bound the (points x triangles) matrix
        inside = np.zeros(points.shape[0], dtype=bool)
        chunk = max(1, int(4e7 // max(1, triangles.shape[0])))
        for s in range(0, points.shape[0], chunk):
            inside[s : s + chunk] = winding_number(points[s : s + chunk], triangles) > 0.5
        solid = np.zeros(shape, dtype=bool)
        solid[cand] = inside
        return solid
    raise ValueError(f"unknown voxelization method {method!r}")


def solid_voxel_indices(solid_mask):
    """(3, n) indices of solid voxels, the format BCs expect."""
    return np.array(np.nonzero(solid_mask))


def voxelize_stl(stl_filename, length_lbm_unit=None, transformation_matrix=None, pitch=None,
                 method=MeshVoxelizationMethod.RAY, margin=2):
    """Load an STL and voxelize it on a fitted grid (reference
    xlb/utils/utils.py:248-284, minus the trimesh dependency).

    ``pitch`` (voxel size in mesh units) or ``length_lbm_unit`` (the number
    of voxels across the mesh's largest extent) sizes the grid; an optional
    4x4 ``transformation_matrix`` is applied to the mesh first.  Returns
    ``(solid_mask, pitch, origin)`` -- pair with
    :func:`solid_voxel_indices` for BC index lists.
    """
    from xlb_tpu_torch.geometry.stl import load_stl

    if length_lbm_unit is None and pitch is None:
        raise ValueError("Either 'length_lbm_unit' or 'pitch' must be provided!")
    tris = load_stl(stl_filename)
    if transformation_matrix is not None:
        m = np.asarray(transformation_matrix, dtype=np.float64)
        pts = tris.reshape(-1, 3)
        tris = (pts @ m[:3, :3].T + m[:3, 3]).reshape(-1, 3, 3)
    lo, hi = tris.min(axis=(0, 1)), tris.max(axis=(0, 1))
    extent = float((hi - lo).max())
    if pitch is None:
        pitch = extent / float(length_lbm_unit)
    shape = tuple(int(np.ceil(e / pitch)) + 2 * margin for e in (hi - lo))
    origin = lo - margin * pitch
    mask = voxelize(tris, shape, origin=origin, spacing=pitch, method=method)
    return mask, float(pitch), origin
