"""Build and bind the CUDA kernels of ``xlb_tpu_torch/csrc``.

At first use, ``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links them into a shared
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_Q = 19
MAX_BC = 8
STORE_KIND = {torch.float32: 0, torch.bfloat16: 1}  # the launchers' store_kind codes
# the launchers' bc_kind codes (enum in csrc/collide_stream.cuh)
BC_KIND = {"equilibrium": 0, "fullway": 1, "halfway": 2, "zouhe": 3, "regularized": 4}


class XlbStepParams(ctypes.Structure):
    """Mirror of ``struct XlbStepParams`` in ``csrc/collide_stream.cuh``."""

    _fields_ = [
        ("w", ctypes.c_float * MAX_Q),
        ("w45", ctypes.c_float * MAX_Q),
        ("has_solids", ctypes.c_int),
        ("n_bc", ctypes.c_int),
        ("bc_kind", ctypes.c_int * MAX_BC),
        ("bc_id", ctypes.c_int * MAX_BC),
        ("bc_flag", ctypes.c_int * MAX_BC),
        ("bc_feq", (ctypes.c_float * MAX_Q) * MAX_BC),
        ("bc_mw", (ctypes.c_float * MAX_Q) * MAX_BC),
        ("bc_value", (ctypes.c_float * 3) * MAX_BC),
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
            pid = os.getpid()
            sources = sorted(CSRC.glob("*.cu"))
            objects = [out_dir / f"{src.stem}.{pid}.o" for src in sources]
            cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objects)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in cmds]
            outputs = [proc.communicate()[0] for proc in procs]
            tmp = out_dir / f"libxlb_tpu_torch.{pid}.so"
            link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
            failed = [(cmd, out) for cmd, out, proc in zip(cmds, outputs, procs) if proc.returncode != 0]
            if not failed:
                proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                outputs.append(proc.stdout)
                if proc.returncode != 0:
                    failed.append((link, proc.stdout))
            log = "".join(" ".join(cmd) + "\n" + out for cmd, out in zip(cmds + [link], outputs))
            (out_dir / "build.log").write_text(log)
            for obj in objects:
                obj.unlink(missing_ok=True)
            if failed:
                cmd, out = failed[0]
                raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out[-4000:]}")
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
    lib.xlb_collide_stream_2d_step.argtypes = [i32, i32, i32, ptr, ptr, ptr, i32, i32, f32, params, ptr]
    lib.xlb_collide_stream_2d_step.restype = i32
    lib.xlb_collide_stream_2d_kstep.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr, i32, i32, i32, i32, f32, params, ptr]
    lib.xlb_collide_stream_2d_kstep.restype = i32
    lib.xlb_collide_only.argtypes = [ptr, ptr, ptr, i32, f32, params, ptr]
    lib.xlb_collide_only.restype = i32
    lib.xlb_collide_then_stream.argtypes = [i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                                            i32, i32, i32, f32, params, ptr]
    lib.xlb_collide_then_stream.restype = i32
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
