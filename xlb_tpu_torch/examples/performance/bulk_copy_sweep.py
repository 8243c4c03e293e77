"""The design sweep of the bulk copy of K10 / K11 (``bulk_copy_kernel`` of
``csrc/copy_bandwidth.cu``), against ``Tensor.copy_`` on the card.

    python -m xlb_tpu_torch.examples.performance.bulk_copy_sweep [--parent FILE] [--out JSON] [--N 256] [--q 19]

Builds ``bulk_copy_kernel`` at every (chunk bytes, stages, loads ahead) of
``VARIANTS`` (the template's parameters, see the source), each
group of variants into a library of its own beside ``copy_bandwidth.cu``'s
own entry points (the configuration the port ships: ``xlb_copy_bulk``), and,
with ``--parent``, another tree's ``copy_bandwidth.cu`` as it stands (an
A/B against an earlier design: its K9, K10/K11 and K12 entry points). Every
variant is first held bit for bit against its input on the edge shapes of
``EDGE_SHAPES`` (aligned and 4 bytes past a 16-byte boundary) and on the
field. Then, on the scripts' (q, N, N, N) float32 field, every line --
``Tensor.copy_``, K9 under its launch shapes, K12's five variants, each
bulk variant over one range (K10) and over q (K11), the shipped
configuration and the parent's -- runs in windows of ``iters`` calls (two
buffers ping-pong, both far larger than the 50 MB L2), the lines taking
turns: one warm-up round, then ``rounds`` rounds, forward and backward in
turn, each line's best window kept (CUDA events). Prints each line's ms,
its ratio to ``copy_`` and its launch shape (resident blocks per SM,
shared memory per block), and a profile of one ``copy_`` (what it
launches); ``--out`` writes all of it as JSON.
"""

import argparse
import ctypes
import hashlib
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from xlb_tpu_torch.examples.performance.common import interleaved_ms
from xlb_tpu_torch.kernels import _cuda
from xlb_tpu_torch.kernels.copy_bandwidth import MANUAL_VARIANTS

SOURCE = _cuda.CSRC / "copy_bandwidth.cu"
BUILD = _cuda.BUILD_ROOT / "bulk_sweep"
KB = 1024
# (chunk bytes, stages, loads ahead)
VARIANTS = (
    # the ring's layout, every stage but one loading (the parent's split)
    (16 * KB, 2, 1), (16 * KB, 3, 2), (16 * KB, 4, 3), (16 * KB, 6, 5), (16 * KB, 8, 7), (16 * KB, 13, 12),
    (32 * KB, 2, 1), (32 * KB, 3, 2), (32 * KB, 4, 3), (32 * KB, 6, 5), (64 * KB, 2, 1), (64 * KB, 3, 2),
    # more stores in flight
    (16 * KB, 4, 2), (16 * KB, 6, 3), (16 * KB, 8, 4), (16 * KB, 8, 6), (16 * KB, 13, 8), (32 * KB, 4, 2),
    (32 * KB, 6, 3), (32 * KB, 6, 4), (64 * KB, 3, 1),
    # fewer bytes in flight per block, more blocks
    (4 * KB, 2, 1), (8 * KB, 2, 1), (8 * KB, 3, 1), (8 * KB, 4, 2), (16 * KB, 3, 1),
    # ~32 KB of loads in flight per SM, more store groups
    (4 * KB, 6, 2), (4 * KB, 8, 4), (8 * KB, 6, 2), (8 * KB, 6, 3), (8 * KB, 8, 4),
)
# {variant: resident blocks per SM}: persistent grids of fewer blocks than fit
CAPPED = {(16 * KB, 4, 3): (1, 2), (16 * KB, 2, 1): (1, 2, 3, 4), (4 * KB, 2, 1): (4, 8, 16),
          (8 * KB, 2, 1): (2, 3, 4, 6, 8), (8 * KB, 3, 1): (3, 4), (8 * KB, 4, 2): (2, 4), (16 * KB, 3, 1): (2, 3),
          (16 * KB, 3, 2): (2,), (32 * KB, 2, 1): (1, 2), (32 * KB, 3, 2): (1,), (4 * KB, 6, 2): (4,),
          (4 * KB, 8, 4): (2, 4), (8 * KB, 6, 2): (2, 3), (8 * KB, 6, 3): (2,), (8 * KB, 8, 4): (1, 2),
          (16 * KB, 4, 2): (1, 2)}
GROUPS = 8  # libraries (nvcc processes) the variants are spread over
# the chunk plan's edges as (shape, ranges = shape[0]): q above the resident
# blocks, ranges shorter than a 16-byte word, a range of one chunk and of a
# chunk plus a word (of 4, 8 and 16 KB), a prime q that divides no grid of
# 132 x k blocks
EDGE_SHAPES = ((1000, 7), (5000, 7), (64, 3), (3, 1024), (3, 1028), (3, 2048), (3, 2052), (3, 4096), (3, 4100),
               (131, 300), (19, 24, 20, 36), (7, 5, 3))


def _variant_name(v):
    chunk, stages, ahead = v
    return f"C{chunk // KB}K S{stages} A{ahead}"


def _variant_code(i, v):
    """C entry points of variant i: ``sweep_i_c`` launches it on a grid of
    at most c blocks per SM (0: as many as fit), ``sweep_i_shape`` gives its
    resident blocks per SM and shared memory per block."""
    chunk, stages, ahead = v
    code = "".join(f"""
extern "C" int sweep_{i}_{cap}(const void* in, void* out, long long n, int ranges, void* stream) {{
  return xlb::launch_bulk<{chunk}, {stages}, {ahead}, {cap}>(static_cast<const float*>(in), static_cast<float*>(out),
                                                   size_t(n), unsigned(ranges), static_cast<cudaStream_t>(stream));
}}""" for cap in (0,) + CAPPED.get(v, ()))
    return code + f"""
extern "C" int sweep_{i}_shape(int* per_sm, int* smem) {{
  *smem = {stages * chunk};
  return xlb::blocks_per_sm(xlb::bulk_copy_kernel<{chunk}, {stages}, {ahead}>, xlb::kBulkThreads, *smem, 0, *per_sm);
}}
"""


def _compile(nvcc, src, lib):
    if lib.exists():
        return lib
    tmp = lib.with_suffix(".tmp.so")
    cmd = [nvcc, *_cuda.NVCC_FLAGS, "-shared", "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout[-4000:]}")
    tmp.replace(lib)
    return lib


def build(parent=None):
    """Compile the variant libraries (and the parent's), all nvcc processes
    at once; returns ([(library, [variant index])], parent library or None)."""
    nvcc = _cuda.find_nvcc()
    key = hashlib.sha256(SOURCE.read_bytes() + repr((VARIANTS, _cuda.NVCC_FLAGS)).encode())
    if parent:
        key.update(Path(parent).read_bytes())
    out = BUILD / key.hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    jobs, groups = [], []
    for g in range(GROUPS):
        idx = list(range(g, len(VARIANTS), GROUPS))
        src = out / f"group{g}.cu"
        src.write_text(f'#include "{SOURCE}"\n' + "".join(_variant_code(i, VARIANTS[i]) for i in idx))
        jobs.append((src, out / f"libgroup{g}.so"))
        groups.append(idx)
    if parent:
        jobs.append((Path(parent).resolve(), out / "libparent.so"))
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda job: _compile(nvcc, *job), jobs))
    return list(zip(libs[:GROUPS], groups)), (libs[GROUPS] if parent else None)


def _bind(path):
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.xlb_copy_vector.argtypes = [ptr, ptr, i64, i32, i32, ptr]
    lib.xlb_copy_bulk.argtypes = [ptr, ptr, i64, i32, ptr]
    lib.xlb_copy_manual_scale.argtypes = [ptr, ptr, i64, i32, i32, i32, ptr]
    return lib


def _run(fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


def _bulk(fn, split):
    """A bulk copy's launch over one range, or (``split``) one per channel."""
    def launch(a, b):
        r = a.shape[0] if split else 1
        _run(fn, a.data_ptr(), b.data_ptr(), a.numel() // r, r)
    return launch


def lines(groups, parent):
    """{label: (kind, launch(a, b))}: every line of the sweep; "copy" lines
    compute b = a, "scale" lines b = a * 1.0000001f. K11's lines take one
    range per channel of a (its leading dimension), K10's one range."""
    from xlb_tpu_torch.examples.performance.memory_bandwidth import LAUNCH_SHAPES

    out = {"copy_": ("copy", lambda a, b: b.copy_(a))}
    trees = [("", _bind(groups[0][0]))] + ([("parent ", _bind(parent))] if parent else [])
    for tag, lib in trees:
        for t, v in LAUNCH_SHAPES:
            out[f"{tag}K9 {t}x{v}"] = ("copy", lambda a, b, lib=lib, t=t, v=v: _run(
                lib.xlb_copy_vector, a.data_ptr(), b.data_ptr(), a.numel(), t, v))
        for split, name in ((False, "K10"), (True, "K11")):
            out[f"{tag}{name}" + ("" if tag else " shipped")] = ("copy", _bulk(lib.xlb_copy_bulk, split))
        for d, s, m in MANUAL_VARIANTS:
            out[f"{tag}K12 {d}{s}{int(m)}"] = ("scale", lambda a, b, lib=lib, d=d, s=s, m=m: _run(
                lib.xlb_copy_manual_scale, a.data_ptr(), b.data_ptr(), a.numel(), d, s, int(m)))
    for path, idx in groups:
        lib = ctypes.CDLL(str(path))
        for i in idx:
            for cap in (0,) + CAPPED.get(VARIANTS[i], ()):
                fn = getattr(lib, f"sweep_{i}_{cap}")
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
                for split, name in ((False, "K10"), (True, "K11")):
                    label = f"{name} {_variant_name(VARIANTS[i])}" + (f" {cap}/SM" if cap else "")
                    out[label] = ("copy", _bulk(fn, split))
    return out


def shapes(groups):
    """{variant name: (resident blocks per SM, shared memory per block)}."""
    res = {}
    for path, idx in groups:
        lib = ctypes.CDLL(str(path))
        for i in idx:
            per_sm, smem = ctypes.c_int(), ctypes.c_int()
            err = getattr(lib, f"sweep_{i}_shape")(ctypes.byref(per_sm), ctypes.byref(smem))
            if err != 0:
                raise RuntimeError(f"sweep_{i}_shape: CUDA error {err}")
            res[_variant_name(VARIANTS[i])] = (per_sm.value, smem.value)
    return res


def check_edges(all_lines, device, field):
    """Every line bit for bit against its plain version on EDGE_SHAPES
    (aligned and 4 bytes past a 16-byte boundary) and on ``field``; returns
    the number of comparisons."""
    from xlb_tpu_torch.kernels.copy_bandwidth import copy_plain, like_aligned, scale_copy_plain

    gen = torch.Generator(device="cpu").manual_seed(16)
    n_cmp = 0
    views = [field]
    for shape in EDGE_SHAPES:
        numel = int(torch.tensor(shape).prod())
        base = torch.randn(numel + 1, generator=gen).to(device)
        views += [base[:numel].view(shape), base[1:].view(shape)]
    for x in views:
        for label, (kind, launch) in all_lines.items():
            y = like_aligned(x)
            launch(x, y)
            torch.cuda.synchronize()
            if not torch.equal(y, copy_plain(x) if kind == "copy" else scale_copy_plain(x)):
                raise RuntimeError(f"{label} differs from its plain version on {tuple(x.shape)} "
                                   f"({x.data_ptr() % 16} B past 16)")
            n_cmp += 1
            del y
    return n_cmp


def time_lines(all_lines, x, iters, rounds):
    """{label: best ms per call} of every line in alternating windows
    (common.interleaved_ms), each call's output the next one's input: two
    buffers ping-pong (the field's own among them)."""
    spare = [torch.empty_like(x)]

    def step(launch):
        def run(v):
            y = spare[0]
            launch(v, y)
            spare[0] = v
            return y
        return run

    return interleaved_ms({label: step(launch) for label, (_, launch) in all_lines.items()}, x, iters, rounds)


def profile_copy(x):
    """What ``copy_`` launches on the card: (name, device ms) of one call."""
    y = torch.empty_like(x)
    y.copy_(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        y.copy_(x)
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if dev:
            out.append((e.key, dev / 1e3))
    return out


def main():
    p = argparse.ArgumentParser(description="the bulk copy's design sweep against Tensor.copy_")
    p.add_argument("--parent", default=None, help="another tree's csrc/copy_bandwidth.cu, built as it stands")
    p.add_argument("--N", type=int, default=256)
    p.add_argument("--q", type=int, default=19)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--out", default=None, help="write the results to this JSON file")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bulk_copy_sweep: needs a CUDA device")
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    groups, parent = build(args.parent)
    x = torch.randn((args.q, args.N, args.N, args.N), generator=torch.Generator(device=device).manual_seed(16),
                    device=device)
    all_lines = lines(groups, parent)
    print(f"bulk_copy_sweep: {tuple(x.shape)} float32, {x.numel() * 4 / 1e9:.3f} GB per array, {name} ({smi}), "
          f"windows of {args.iters}, best of {args.rounds} alternating rounds")
    n_cmp = check_edges(all_lines, device, x)
    print(f"  {n_cmp} comparisons bit-equal to the plain version ({len(EDGE_SHAPES)} edge shapes x 2 offsets "
          f"and the field)")
    shape = shapes(groups)
    copy_profile = profile_copy(x)
    print("  copy_ launches: " + "; ".join(f"{k} {v:.4f} ms" for k, v in copy_profile))
    best = time_lines(all_lines, x, args.iters, args.rounds)
    ref = best["copy_"]
    for label, ms in sorted(best.items(), key=lambda kv: kv[1]):
        v = next((s for k, s in shape.items() if f" {k}" in label), None)
        if v and label.endswith("/SM"):  # a capped grid
            v = (min(v[0], int(label.rsplit(" ", 1)[1][:-3])), v[1])
        extra = f", {v[0]} blocks/SM x {v[1]} B" if v else ""
        print(f"  {label}: {ms:.4f} ms, {ms / ref:.4f} x copy_, {2 * x.numel() * 4 / ms / 1e6:.1f} GB/s{extra}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": smi, "device": name, "shape": list(x.shape), "iters": args.iters, "rounds": args.rounds,
            "ms": best, "shapes": shape, "copy_profile": copy_profile, "comparisons": n_cmp}, indent=1))


if __name__ == "__main__":
    main()
