"""Build and bind the CUDA kernels of ``xlb_tpu_torch/csrc``.

At first use, ``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links them into a shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), which is loaded with ``ctypes``. The library lands in
``build/xlb_tpu_torch/<hash>/`` beside the package, keyed by a hash of the
sources and flags, under a file lock so concurrent processes do not race.
The build log there holds ptxas's report and each source's seconds.
A missing ``nvcc`` or a failed build raises; nothing falls back.
"""

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "xlb_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_Q = 27
MAX_BC = 256  # the packed id field's reach (XLB_MAX_BC)
STORE_KIND = {torch.float32: 0, torch.bfloat16: 1}  # the launchers' store_kind codes
# the XlbStepParams::bc_kind codes (enum in csrc/collide_stream.cuh)
BC_KIND = {"equilibrium": 0, "fullway": 1, "halfway": 2, "zouhe": 3, "regularized": 4, "do_nothing": 5,
           "free_slip": 6, "extrapolation_outflow": 7, "hybrid": 8}
# the collision codes of XlbStepParams::collision (enum in csrc/collide_stream.cuh)
COLLISION = {"BGK": 0, "KBC": 1, "SmagorinskyLESBGK": 2, "TRT": 3, "MRT": 4, "PowerLawBGK": 5}


class XlbBc(ctypes.Structure):
    """Mirror of ``struct XlbBc`` in ``csrc/collide_stream.cuh``: the
    constant prescription of one BC (``vec``: the equilibrium's feq, the
    halfway or hybrid moving-wall term -- or 6 w_l for a per-voxel wall
    velocity --, the Zou-He / regularized velocity or density, the
    free-slip or outflow normal and the outflow's sound speed; ``flag``: a
    moving wall, a pressure BC, a per-voxel prescription and its aux
    channel, or a hybrid BC's method, distances, moving wall and aux
    channels, ``collide_stream_dma.hybrid_flag``)."""

    _fields_ = [
        ("flag", ctypes.c_int),
        ("vec", ctypes.c_float * MAX_Q),
    ]


class XlbStepParams(ctypes.Structure):
    """Mirror of ``struct XlbStepParams`` in ``csrc/collide_stream.cuh``:
    every field travels by value, the prescriptions of all ``MAX_BC`` BCs
    included."""

    _fields_ = [
        ("w", ctypes.c_float * MAX_Q),
        ("w45", ctypes.c_float * MAX_Q),
        ("has_solids", ctypes.c_int),
        ("n_bc", ctypes.c_int),
        ("q", ctypes.c_int),
        ("collision", ctypes.c_int),
        ("walled", ctypes.c_int),
        ("has_force", ctypes.c_int),
        ("force", ctypes.c_float * 3),
        ("coll", ctypes.c_float * 3),
        ("coll_iters", ctypes.c_int),
        ("mrt_on", ctypes.c_int * 2),
        ("mrt_rate", ctypes.c_float * 2),
        ("bc_kind", ctypes.c_int * MAX_BC),
        ("bc_id", ctypes.c_int * MAX_BC),
        ("bc", XlbBc * MAX_BC),
    ]


MRT_TABLE = CSRC / "mrt_projectors.cuh"


def mrt_table_header():
    """The text of ``csrc/mrt_projectors.cuh``: for D3Q19 and D3Q27 and the
    bulk and ghost groups, the projector contraction out_i += coef sum_j
    P_ij fneq_j written out row by row (``ops.collision.mrt_projectors``
    rounded to float32; entries below 1e-14 in magnitude skipped and +-1
    as adds, in column order, as ``xlb_tpu``'s kernel body unrolls it),
    templated on the scalar (float, or the adjoint's Dual), with the
    arithmetic that nvcc never contracts into FMAs. A CPU test
    holds the committed file to this function."""
    import numpy as np

    from xlb_tpu_torch.ops.collision import mrt_projectors
    from xlb_tpu_torch.velocity_set import D3Q19, D3Q27

    out = [
        "// The MRT projector contractions of D3Q19 and D3Q27: for the bulk (g = 0)",
        "// and ghost (g = 1) groups, out[i] += coef * sum_j P_ij fneq[j], row by row,",
        "// with P rounded to float32, entries below 1e-14 in magnitude skipped and",
        "// +-1 as adds, in column order, in products and sums that nvcc never contracts",
        "// into FMAs (the same bits in every kernel); F is float, or the adjoint's Dual",
        "// (mul_rn / add_rn / sub_rn of collide_stream.cuh). Written by",
        "// xlb_tpu_torch.kernels._cuda.mrt_table_header() from",
        "// xlb_tpu_torch.ops.collision.mrt_projectors; a CPU test holds this file to it.",
        "#pragma once",
        "",
        '#include "dual.cuh"',
        "",
        "namespace xlb {",
    ]
    for vs in (D3Q19(), D3Q27()):
        P = mrt_projectors(vs)
        q = vs.q
        for g in ("bulk", "ghost"):
            out.append("")
            out.append("template <typename F>")
            out.append(f"__device__ __forceinline__ void mrt_d3q{q}_{g}(const F* f, F coef, F* out) {{")
            for i, row in enumerate(P[g]):
                body = []
                for j, v in enumerate(row):
                    if abs(v) < 1e-14:
                        continue
                    if v in (1.0, -1.0):
                        op, term = ("add_rn" if v > 0 else "sub_rn"), f"f[{j}]"
                        first = f"f[{j}]" if v > 0 else f"-f[{j}]"
                    else:
                        op, term = "add_rn", f"mul_rn(f[{j}], {float(np.float32(v))!r}f)"
                        first = term
                    body.append(f"    a = {op}(a, {term});" if body else f"    F a = {first};")
                if body:
                    out += ["  {", *body, f"    out[{i}] = add_rn(out[{i}], mul_rn(coef, a));", "  }"]
            out.append("}")
    out.append("")
    out.append("}  // namespace xlb")
    return "\n".join(out) + "\n"


def data_ptr(t):
    """The device address of a tensor for a launcher, or None (a null
    pointer) for no tensor."""
    return None if t is None else t.data_ptr()


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
            t0 = time.perf_counter()
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in cmds]
            outputs = [None] * len(procs)

            def collect(i):  # each source's output, and its seconds from the start of the build
                out = procs[i].communicate()[0]
                outputs[i] = f"{out}# {sources[i].name}: {time.perf_counter() - t0:.1f} s\n"

            threads = [threading.Thread(target=collect, args=(i,)) for i in range(len(procs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
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
    # ... omega, aux (the BCs' per-voxel prescriptions, or null), params, stream
    lib.xlb_collide_stream_step.argtypes = [i32, i32, ptr, ptr, ptr, i32, i32, i32, f32, ptr, params, ptr]
    lib.xlb_collide_stream_step.restype = i32
    lib.xlb_collide_stream_kstep.argtypes = [i32, i32, i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, ptr, params,
                                             ptr]
    lib.xlb_collide_stream_kstep.restype = i32
    lib.xlb_collide_stream_blocked.argtypes = [i32, i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, ptr, params,
                                               ptr]
    lib.xlb_collide_stream_blocked.restype = i32
    lib.xlb_has_instantiation.argtypes = [i32, i32, i32, i32, i32, i32]
    lib.xlb_has_instantiation.restype = i32
    lib.xlb_collide_stream_adjoint.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32, ptr, params,
                                               ptr]
    lib.xlb_collide_stream_adjoint.restype = i32
    # ... omega, aux (or null), params, stream
    lib.xlb_collide_stream_2d_step.argtypes = [i32, i32, i32, ptr, ptr, ptr, i32, i32, f32, ptr, params, ptr]
    lib.xlb_collide_stream_2d_step.restype = i32
    lib.xlb_collide_stream_2d_kstep.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr, i32, i32, i32, i32, f32, ptr, params,
                                                ptr]
    lib.xlb_collide_stream_2d_kstep.restype = i32
    # field, store_kind, f, mask, out, X, Y, Z, omega, aux, params, stream
    lib.xlb_collide_stream_field_step.argtypes = [i32, i32, ptr, ptr, ptr, i32, i32, i32, f32, ptr, params, ptr]
    lib.xlb_collide_stream_field_step.restype = i32
    # field, store_kind, ext, f, mask, out, X, Y, omega, aux, params, stream
    lib.xlb_collide_stream_2d_field_step.argtypes = [i32, i32, i32, ptr, ptr, ptr, i32, i32, f32, ptr, params, ptr]
    lib.xlb_collide_stream_2d_field_step.restype = i32
    lib.xlb_collide_only.argtypes = [ptr, ptr, ptr, i32, f32, params, ptr]
    lib.xlb_collide_only.restype = i32
    lib.xlb_collide_then_stream.argtypes = [i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                                            i32, i32, i32, f32, params, ptr]
    lib.xlb_collide_then_stream.restype = i32
    i64 = ctypes.c_longlong
    lib.xlb_copy_vector.argtypes = [ptr, ptr, i64, i32, i32, ptr]
    lib.xlb_copy_vector.restype = i32
    lib.xlb_copy_bulk.argtypes = [ptr, ptr, i64, i32, ptr]
    lib.xlb_copy_bulk.restype = i32
    lib.xlb_copy_bulk_shape.argtypes = [ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.xlb_copy_bulk_shape.restype = i32
    lib.xlb_copy_manual_scale.argtypes = [ptr, ptr, i64, i32, i32, i32, ptr]
    lib.xlb_copy_manual_scale.restype = i32
    lib.xlb_copy_has_variant.argtypes = [i32, i32, i32, i32]
    lib.xlb_copy_has_variant.restype = i32
    lib.xlb_error_string.argtypes = [i32]
    lib.xlb_error_string.restype = ctypes.c_char_p
    lib.xlb_params_size.argtypes = []
    lib.xlb_params_size.restype = i32
    lib.xlb_bc_size.argtypes = []
    lib.xlb_bc_size.restype = i32
    if lib.xlb_params_size() != ctypes.sizeof(XlbStepParams) or lib.xlb_bc_size() != ctypes.sizeof(XlbBc):
        raise RuntimeError("XlbStepParams / XlbBc layout differs between csrc/collide_stream.cuh and _cuda.py")
    return lib


def check(lib, err, what):
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.xlb_error_string(err).decode()})")


def ptxas_report():
    """Per kernel of the current build: (mangled name, registers, spill
    stores, spill loads, static shared bytes), from ptxas's -v report in
    the build log; [] before the first build."""
    import re

    entries, cur = [], None
    for line in (build_log() or "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": m.group(1), "registers": None, "spill_stores": 0, "spill_loads": 0, "smem": 0}
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return [(e["name"], e["registers"], e["spill_stores"], e["spill_loads"], e["smem"]) for e in entries]


def build_log():
    """The compiler output of the current build (ptxas register and spill
    report), or None before the first build."""
    path = BUILD_ROOT / _source_hash(find_nvcc()) / "build.log"
    return path.read_text() if path.exists() else None
