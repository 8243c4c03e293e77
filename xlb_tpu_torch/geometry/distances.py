"""Directional wall distances for curved-boundary (hybrid) BCs -- the port
of ``xlb_tpu.geometry.distances``, line for line in NumPy.

For each boundary voxel and lattice direction, the normalized distance
t in [0, 1] from the voxel center to the mesh surface along that direction
(t = 1 means the wall sits exactly at the neighbor's center), computed
with vectorized Moller-Trumbore at setup (or the native C++ sweep of
``geometry/native``) and kept as per-voxel tables on the BC object. This
is host-side setup; only the resulting weights reach the device.
"""

import numpy as np


def ray_triangle_hits(origins, direction, triangles, eps=1e-12):
    """Moller-Trumbore: smallest positive hit parameter t per origin along
    ``direction`` (3,), or +inf.  origins (n, 3); triangles (m, 3, 3)."""
    v0 = triangles[:, 0]
    e1 = triangles[:, 1] - v0
    e2 = triangles[:, 2] - v0
    d = np.asarray(direction, dtype=np.float64)

    tmin = np.full(origins.shape[0], np.inf)
    chunk = max(1, int(2e7 // max(1, triangles.shape[0])))
    for s in range(0, origins.shape[0], chunk):
        o = origins[s : s + chunk]  # (c, 3)
        p = np.cross(d, e2)  # (m, 3)
        det = np.einsum("mk,mk->m", e1, p)  # (m,)
        valid = np.abs(det) > eps
        inv_det = np.where(valid, 1.0 / np.where(valid, det, 1.0), 0.0)
        tvec = o[:, None, :] - v0[None, :, :]  # (c, m, 3)
        u = np.einsum("cmk,mk->cm", tvec, p) * inv_det[None, :]
        q = np.cross(tvec, e1[None, :, :])
        v = np.einsum("cmk,k->cm", q, d) * inv_det[None, :]
        t = np.einsum("cmk,mk->cm", q, e2) * inv_det[None, :]
        hit = valid[None, :] & (u >= -1e-9) & (v >= -1e-9) & (u + v <= 1 + 1e-9) & (t > eps)
        t = np.where(hit, t, np.inf)
        tmin[s : s + chunk] = t.min(axis=1)
    return tmin


def implicit_link_distances(inside_fn, voxels, directions, iters=48):
    """Normalized link crossing fractions (q, n) from an implicit geometry.

    ``inside_fn(points)`` maps (n, d) coordinates to a boolean "inside the
    solid" array.  For every voxel (columns of ``voxels`` (d, n), assumed
    OUTSIDE) and lattice direction ``c_l`` (columns of ``directions``
    (d, q)), returns the fraction t in (0, 1] at which the link
    ``x + t c_l`` first enters the solid, located by bisection (exact to
    ~2^-iters of a link), or +inf when the link endpoint stays outside.

    This is the analytic-geometry counterpart of
    ``directional_wall_distances`` (triangle meshes): same output
    convention, so the result feeds ``HybridBC.set_link_distances``
    directly.  Used for 2D shapes (cylinders) where no mesh exists --
    the reference's curved BC machinery is 3D/Warp-only
    (bc_hybrid.py:110-116), so this path has no reference counterpart.
    """
    voxels = np.asarray(voxels, dtype=np.float64)
    directions = np.asarray(directions, dtype=np.float64)
    d, n = voxels.shape
    q = directions.shape[1]
    out = np.full((q, n), np.inf)
    x = voxels.T  # (n, d)
    inside0 = np.asarray(inside_fn(x), dtype=bool)
    for l in range(q):
        c = directions[:, l]
        if not c.any():
            continue
        endpoint_in = np.asarray(inside_fn(x + c), dtype=bool)
        cross = ~inside0 & endpoint_in
        if not cross.any():
            continue
        lo = np.zeros(cross.sum())
        hi = np.ones(cross.sum())
        xc = x[cross]
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            m_in = np.asarray(inside_fn(xc + mid[:, None] * c), dtype=bool)
            hi = np.where(m_in, mid, hi)
            lo = np.where(m_in, lo, mid)
        out[l, cross] = 0.5 * (lo + hi)
    return out


def directional_wall_distances(triangles, voxels, directions):
    """Normalized distances (q, n): for voxel centers ``voxels`` (d, n) and
    lattice ``directions`` (d, q), the fraction t in [0, 1] of each lattice
    link at which the mesh is crossed (inf when the link doesn't hit).

    Dispatches to the native C++ sweep (geometry/native/voxelizer.cpp)
    when available -- ~100x the NumPy path on large shells (the shell x q
    x triangles product reaches 10^8-10^9 tests at 256^3)."""
    triangles = np.asarray(triangles, dtype=np.float64)
    voxels = np.asarray(voxels, dtype=np.float64)
    if voxels.shape[0] == 3:
        from xlb_tpu_torch.geometry.native import directional_distances_native

        native = directional_distances_native(triangles, voxels, directions)
        if native is not None:
            return native
    d, n = voxels.shape
    origins = voxels.T  # (n, d) at voxel centers (integer coords)
    q = directions.shape[1]
    out = np.full((q, n), np.inf)
    for l in range(q):
        c = directions[:, l].astype(np.float64)
        norm = np.linalg.norm(c)
        if norm == 0:
            continue
        t = ray_triangle_hits(origins, c / norm, triangles)
        out[l] = t / norm  # normalize so t=1 <=> one lattice link
    return out
