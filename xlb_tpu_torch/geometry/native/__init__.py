"""ctypes bindings of the native C++ voxelizer (``voxelizer.cpp``, the same
source as ``xlb_tpu``'s).

At first use g++ (-O3 -march=native -fopenmp) compiles it into
``build/xlb_tpu_torch/voxelizer/<hash>/`` beside the package, keyed by a
hash of the source, the flags and the host (``-march=native`` code runs
only where it was built), under a file lock, never next to the source.
Where g++ fails, ``voxelize`` warns and takes its pure-NumPy path, as
``xlb_tpu``'s does; ``XLB_TPU_NO_NATIVE=1`` forces that path. The same
library holds the HybridBC wall distances' ray sweep
(``directional_distances_native``). This is host-side setup, not a device
kernel.
"""

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "voxelizer.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "xlb_tpu_torch" / "voxelizer"
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path():
    """Where the built library lives: keyed by the source, the flags and the host."""
    key = " ".join(FLAGS + (platform.node(), platform.machine())).encode() + SRC.read_bytes()
    h = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_ROOT / h / "libvoxelizer.so"


def _build(lib_path):
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lib_path.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return
        tmp = lib_path.with_name(f"libvoxelizer.{os.getpid()}.so")  # renamed into place once whole
        try:
            subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)], check=True, capture_output=True)
            os.replace(tmp, lib_path)
        finally:
            tmp.unlink(missing_ok=True)


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if os.environ.get("XLB_TPU_NO_NATIVE"):
            _build_failed = True
            return None
        try:
            lib_path = library_path()
            _build(lib_path)
            lib = ctypes.CDLL(str(lib_path))
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            import warnings

            warnings.warn("native voxelizer unavailable (g++ build failed); mesh voxelization takes the much "
                          "slower pure-NumPy path", RuntimeWarning)
            return None
        c_double_p = ctypes.POINTER(ctypes.c_double)
        c_uint8_p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        lib.voxelize_ray.argtypes = [c_double_p, i64, i64, i64, i64, c_double_p, ctypes.c_double, c_uint8_p]
        lib.winding_numbers.argtypes = [c_double_p, i64, c_double_p, i64, c_double_p]
        lib.triangle_shell.argtypes = [c_double_p, i64, i64, i64, i64, c_double_p, ctypes.c_double, c_uint8_p]
        lib.directional_distances.argtypes = [c_double_p, i64, c_double_p, i64, c_double_p, i64, c_double_p]
        _lib = lib
    return _lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _u8ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def ray_fill(tris, shape, origin, spacing):
    lib = _load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tris, dtype=np.float64)
    origin = np.ascontiguousarray(origin, dtype=np.float64)
    out = np.zeros(shape, dtype=np.uint8)
    lib.voxelize_ray(_dptr(tris), tris.shape[0], shape[0], shape[1], shape[2], _dptr(origin), float(spacing), _u8ptr(out))
    return out.astype(bool)


def shell(tris, shape, origin, spacing):
    lib = _load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tris, dtype=np.float64)
    origin = np.ascontiguousarray(origin, dtype=np.float64)
    out = np.zeros(shape, dtype=np.uint8)
    lib.triangle_shell(_dptr(tris), tris.shape[0], shape[0], shape[1], shape[2], _dptr(origin), float(spacing),
                       _u8ptr(out))
    return out.astype(bool)


def winding(tris, points):
    lib = _load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tris, dtype=np.float64)
    points = np.ascontiguousarray(points, dtype=np.float64)
    out = np.zeros(points.shape[0], dtype=np.float64)
    lib.winding_numbers(_dptr(tris), tris.shape[0], _dptr(points), points.shape[0], _dptr(out))
    return out


def directional_distances_native(tris, voxels, directions):
    """The native Moller-Trumbore sweep of ``geometry.distances``; None: take
    the NumPy one. tris (m, 3, 3); voxels (3, n) centres; directions (3, q).
    Returns (q, n) hit fractions along each unnormalized direction."""
    lib = _load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tris, dtype=np.float64)
    origins = np.ascontiguousarray(np.asarray(voxels, dtype=np.float64).T)  # (n, 3)
    dirs = np.ascontiguousarray(np.asarray(directions, dtype=np.float64).T)  # (q, 3)
    n, q = origins.shape[0], dirs.shape[0]
    out = np.empty((q, n), dtype=np.float64)
    lib.directional_distances(_dptr(tris), tris.shape[0], _dptr(origins), n, _dptr(dirs), q, _dptr(out))
    return out


def voxelize_native(tris, shape, origin, spacing, method_name, close_voxels):
    """The native path of ``geometry.voxelize``; None: take the NumPy one."""
    lib = _load()
    if lib is None:
        return None
    if method_name == "RAY":
        return ray_fill(tris, shape, origin, spacing)
    if method_name == "AABB":
        return shell(tris, shape, origin, spacing) | ray_fill(tris, shape, origin, spacing)
    if method_name == "AABB_CLOSE":
        from xlb_tpu_torch.geometry.voxelize import _dilate, _erode

        closed = _erode(_dilate(shell(tris, shape, origin, spacing), close_voxels), close_voxels)
        return closed | ray_fill(tris, shape, origin, spacing)
    if method_name == "WINDING":
        from xlb_tpu_torch.geometry.voxelize import winding_candidates

        cand = winding_candidates(tris, shape, origin, spacing)
        points = np.asarray(origin) + (np.stack(np.nonzero(cand), axis=-1) + 0.5) * spacing
        solid = np.zeros(shape, dtype=bool)
        solid[cand] = winding(tris, points) > 0.5
        return solid
    return None
