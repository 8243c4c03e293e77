"""Minimal STL reader/writer (binary and ASCII) and procedural meshes --
the port's copy of ``xlb_tpu.geometry.stl`` (pure NumPy, no trimesh);
voxelization happens in ``xlb_tpu_torch.geometry.voxelize``.
"""

import struct

import numpy as np


def load_stl(path):
    """Load an STL file; returns triangle vertices of shape (n_tri, 3, 3)."""
    with open(path, "rb") as f:
        header = f.read(5)
        f.seek(0)
        if header[:5] == b"solid":
            # could still be binary with a 'solid' header; try ASCII first
            try:
                return _load_ascii(path)
            except ValueError:
                pass
        return _load_binary(f)


def _load_binary(f):
    f.seek(80)
    (n_tri,) = struct.unpack("<I", f.read(4))
    data = np.frombuffer(f.read(n_tri * 50), dtype=np.uint8)
    if data.size != n_tri * 50:
        raise ValueError("truncated binary STL")
    rec = data.reshape(n_tri, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(n_tri, 4, 3)
    return floats[:, 1:4, :].astype(np.float64)  # drop the normal row


def _load_ascii(path):
    tris, current = [], []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            parts = line.split()
            if parts[:1] == ["vertex"]:
                current.append([float(x) for x in parts[1:4]])
                if len(current) == 3:
                    tris.append(current)
                    current = []
    if not tris:
        raise ValueError("no triangles found in ASCII STL")
    return np.asarray(tris, dtype=np.float64)


def save_stl(path, triangles):
    """Write (n_tri, 3, 3) triangles as binary STL."""
    triangles = np.asarray(triangles, dtype=np.float32)
    n = triangles.shape[0]
    e1 = triangles[:, 1] - triangles[:, 0]
    e2 = triangles[:, 2] - triangles[:, 0]
    normals = np.cross(e1, e2)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = np.where(lens > 0, normals / np.maximum(lens, 1e-30), 0.0).astype(np.float32)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", n))
        for i in range(n):
            f.write(normals[i].tobytes())
            f.write(triangles[i].tobytes())
            f.write(b"\0\0")
    return path


def transform_mesh(triangles, scale=1.0, rotation=None, translation=(0.0, 0.0, 0.0)):
    """Scale/rotate/translate triangles (reference helper/ibm_helper.py:27-75).

    ``rotation`` is an optional (3, 3) matrix applied after scaling.
    """
    tris = np.asarray(triangles, dtype=np.float64) * float(scale)
    if rotation is not None:
        tris = tris @ np.asarray(rotation, dtype=np.float64).T
    return tris + np.asarray(translation, dtype=np.float64)


def rotation_matrix(axis, angle_deg):
    """Rodrigues rotation matrix around ``axis`` by ``angle_deg`` degrees
    (reference utils.py:219-246 rotate_geometry)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)


def sphere_triangles(center=(0.0, 0.0, 0.0), radius=1.0, subdivisions=3):
    """Generate a triangulated sphere (icosphere) -- used by tests/examples."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(subdivisions):
        new_faces = []
        midpoint_cache = {}
        verts_list = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in midpoint_cache:
                m = verts_list[i] + verts_list[j]
                m /= np.linalg.norm(m)
                verts_list.append(m)
                midpoint_cache[key] = len(verts_list) - 1
            return midpoint_cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces)
    pts = verts * radius + np.asarray(center)
    return pts[faces]


def naca_airfoil_triangles(chord=30.0, span=20.0, naca="0012", n_points=41, leading_edge=(0.0, 0.0, 0.0), angle_of_attack_deg=0.0):
    """Triangulated extruded NACA 4-digit airfoil (closed surface).

    The section lies in the x-z plane (chordwise x, thickness z), extruded
    along y over ``span``; angle of attack rotates about the y axis through
    the leading edge.  Procedural stand-in for the reference's airfoil STL
    (examples/ibm/airfoil_ibm.py) so the example needs no asset download.
    """
    m = int(naca[0]) / 100.0
    p = max(int(naca[1]) / 10.0, 1e-6)
    t = int(naca[2:]) / 100.0
    # cosine-spaced chordwise stations
    beta = np.linspace(0.0, np.pi, n_points)
    xc = 0.5 * (1.0 - np.cos(beta))
    yt = 5.0 * t * (0.2969 * np.sqrt(xc) - 0.1260 * xc - 0.3516 * xc**2 + 0.2843 * xc**3 - 0.1036 * xc**4)
    yc = np.where(xc < p, m / p**2 * (2 * p * xc - xc**2), m / (1 - p) ** 2 * ((1 - 2 * p) + 2 * p * xc - xc**2))
    dyc = np.where(xc < p, 2 * m / p**2 * (p - xc), 2 * m / (1 - p) ** 2 * (p - xc))
    theta = np.arctan(dyc)
    xu, zu = xc - yt * np.sin(theta), yc + yt * np.cos(theta)
    xl, zl = xc + yt * np.sin(theta), yc - yt * np.cos(theta)
    # closed loop: upper surface TE->LE then lower LE->TE
    loop_x = np.concatenate([xu[::-1], xl[1:]])
    loop_z = np.concatenate([zu[::-1], zl[1:]])

    a = np.deg2rad(angle_of_attack_deg)
    xr = loop_x * np.cos(a) + loop_z * np.sin(a)
    zr = -loop_x * np.sin(a) + loop_z * np.cos(a)
    xr, zr = xr * chord, zr * chord

    le = np.asarray(leading_edge, dtype=np.float64)
    n = len(xr)
    ring0 = np.stack([xr + le[0], np.full(n, le[1]), zr + le[2]], axis=1)
    ring1 = ring0 + np.array([0.0, span, 0.0])

    tris = []
    for i in range(n - 1):
        a0, a1, b0, b1 = ring0[i], ring0[i + 1], ring1[i], ring1[i + 1]
        tris.append([a0, a1, b0])
        tris.append([a1, b1, b0])
    # end caps (fan from the mid-chord point)
    for ring, flip in ((ring0, False), (ring1, True)):
        c = ring.mean(axis=0)
        for i in range(n - 1):
            tri = [c, ring[i], ring[i + 1]] if flip else [c, ring[i + 1], ring[i]]
            tris.append(tri)
    return np.asarray(tris, dtype=np.float64)


def turbine_rotor_triangles(center=(0.0, 0.0, 0.0), radius=12.0, hub_radius=1.5, n_blades=3, chord=3.0, twist_deg=20.0, axis="x"):
    """Procedural wind-turbine rotor: ``n_blades`` twisted flat blades
    around a hub, facing the ``axis`` direction.  Stand-in for the
    reference's turbine STL (examples/ibm/wind_turbine_ibm.py:69-75)."""
    tris = []
    n_seg = max(6, int(radius))
    for b in range(n_blades):
        phi = 2.0 * np.pi * b / n_blades
        rs = np.linspace(hub_radius * 0.6, radius, n_seg + 1)
        quads = []
        for r in rs:
            frac = (r - rs[0]) / (rs[-1] - rs[0])
            c_loc = chord * (1.0 - 0.6 * frac)  # taper toward the tip
            pitch = np.deg2rad(twist_deg * (1.0 - frac) + 5.0)
            # blade section: a flat strip of width c_loc pitched about the
            # radial direction, in the rotor plane (y-z for axis=x)
            half = 0.5 * c_loc
            quads.append((r, half * np.cos(pitch), half * np.sin(pitch)))
        for (r0, hy0, hx0), (r1, hy1, hx1) in zip(quads[:-1], quads[1:]):
            p00 = (-hx0, r0 * np.cos(phi) - hy0 * np.sin(phi), r0 * np.sin(phi) + hy0 * np.cos(phi))
            p01 = (+hx0, r0 * np.cos(phi) + hy0 * np.sin(phi), r0 * np.sin(phi) - hy0 * np.cos(phi))
            p10 = (-hx1, r1 * np.cos(phi) - hy1 * np.sin(phi), r1 * np.sin(phi) + hy1 * np.cos(phi))
            p11 = (+hx1, r1 * np.cos(phi) + hy1 * np.sin(phi), r1 * np.sin(phi) - hy1 * np.cos(phi))
            tris.append([p00, p01, p10])
            tris.append([p01, p11, p10])
    tris = np.asarray(tris, dtype=np.float64)
    if axis == "y":
        tris = tris[..., [1, 0, 2]]
    elif axis == "z":
        tris = tris[..., [2, 1, 0]]
    return tris + np.asarray(center, dtype=np.float64)
