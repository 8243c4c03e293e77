"""Build and bind the CUDA kernels of ``xlb_tpu_torch/csrc``.

At first use, ``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), which is loaded with ``ctypes``. The library lands in
``build/xlb_tpu_torch/<hash>/`` beside the package, keyed by a hash of the
sources and flags, under a file lock so concurrent processes do not race.
A missing ``nvcc`` or a failed build raises; nothing falls back.
"""

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "xlb_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

Q = 19
MAX_BC = 8
STORE_KIND = {torch.float32: 0, torch.bfloat16: 1}  # the launchers' store_kind codes


class XlbStepParams(ctypes.Structure):
    """Mirror of ``struct XlbStepParams`` in ``csrc/collide_stream.cuh``."""

    _fields_ = [
        ("w", ctypes.c_float * Q),
        ("has_solids", ctypes.c_int),
        ("n_bc", ctypes.c_int),
        ("bc_kind", ctypes.c_int * MAX_BC),
        ("bc_id", ctypes.c_int * MAX_BC),
        ("bc_feq", (ctypes.c_float * Q) * MAX_BC),
    ]


def find_nvcc():
    """Path of ``nvcc`` from ``CUDA_HOME`` (as PyTorch resolves it: the
    environment, then ``PATH``, then the default toolkit location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.is_file():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin directory on PATH")
    return str(nvcc)


def _source_hash(nvcc):
    h = hashlib.sha256(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library():
    """Compile the kernels (once per source hash) and return the library path."""
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / _source_hash(nvcc)
    lib_path = out_dir / "libxlb_tpu_torch.so"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            tmp = out_dir / f"libxlb_tpu_torch.{os.getpid()}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(tmp, lib_path)
    return lib_path


@functools.cache
def load_library():
    """Build (if needed) and load the kernel library; declare every entry point."""
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    params = ctypes.POINTER(XlbStepParams)
    lib.xlb_collide_stream_step.argtypes = [i32, i32, ptr, ptr, ptr, i32, i32, i32, f32, params, ptr]
    lib.xlb_collide_stream_step.restype = i32
    lib.xlb_collide_stream_kstep.argtypes = [i32, i32, i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, params, ptr]
    lib.xlb_collide_stream_kstep.restype = i32
    lib.xlb_collide_stream_adjoint.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32, params, ptr]
    lib.xlb_collide_stream_adjoint.restype = i32
    lib.xlb_error_string.argtypes = [i32]
    lib.xlb_error_string.restype = ctypes.c_char_p
    lib.xlb_params_size.argtypes = []
    lib.xlb_params_size.restype = i32
    if lib.xlb_params_size() != ctypes.sizeof(XlbStepParams):
        raise RuntimeError("XlbStepParams layout differs between csrc/collide_stream.cuh and _cuda.py")
    return lib


def check(lib, err, what):
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.xlb_error_string(err).decode()})")


def build_log():
    """The compiler output of the current build (ptxas register and spill
    report), or None before the first build."""
    path = BUILD_ROOT / _source_hash(find_nvcc()) / "build.log"
    return path.read_text() if path.exists() else None
