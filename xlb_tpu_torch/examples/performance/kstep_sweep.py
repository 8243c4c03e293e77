"""The design sweep of the k-step kernel K2 (``kstep_kernel`` of
``csrc/collide_stream_3d.cuh``) at k = 2, against two K1 launches and,
with ``--parent``, the parent tree's K2 on the card.

    python -m xlb_tpu_torch.examples.performance.kstep_sweep [--parent FILE] [--out JSON]
        [--forms cavity-f32,...] [--iters 10] [--rounds 5]

Run from the repository's root (it takes its scenes from ``chip_smoke.py``).
Builds the kernel library (``_cuda.load_library``) and, with ``--parent``,
another tree's ``collide_stream_3d.cuh`` as it stands (``FILE``; its
``kstep_kernel`` on that tree's tiles, launched from a source of its own
per form), all ``nvcc`` processes at once. The forms (``FORMS``): the
256^3 cavity under FP32FP32 and FP32BF16, the 512x256x256 flow past a
sphere (kExtOpen) and the D=48 sphere-drag tunnel (kExtHybrid) under
both, the D=24 one (its script's default) under FP32FP32, the other D3Q19
collisions' 256^3 cavity (mlups_3d.py's) under FP32FP32, D3Q27 KBC at
256^3 under both, and D3Q27 KBC in a 384x192x192 wind tunnel
(windtunnel_3d: kExtOpen with a halfway sphere, FP32FP32; kExtHybrid,
both). For each,
every column of ``CANDIDATES`` (TY, TZ) that fits an SM, the wrapper's own
(``TILES``) at the segment rule's length and at those of ``SEGMENTS``,
and the parent's K2 are first held bit for bit against two K1 launches
on the form's ragged scenes (100x52x44: chip_smoke's, every hybrid
method). Then, on the full scene's seeded perturbed state, every line and
two K1 launches run in windows of ``iters`` calls on the same input, the
lines taking turns (``common.interleaved_ms``: one warm-up round, then
``rounds`` rounds, forward and backward in turn, each line's best window
kept, CUDA events). Prints each line's ms per 2 steps, its ratio to the
parent's K2, to two K1 launches and to the bound (the bytes of one read
and one write of f, the mask and two steps' aux reads, or the
operations, over the data sheet's rates), and its launch shape (resident
blocks per SM, shared memory, registers, local bytes per thread); then
ptxas's registers and spills of every K2 instantiation. ``--out`` writes
it all as JSON. Not a phase of ``chip_smoke.py``.
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
from xlb_tpu_torch.kernels.collide_stream_2step import MAX_SHARED, CollideStreamKStep, kstep_smem_bytes

BUILD = _cuda.BUILD_ROOT / "kstep_sweep"
# (TY, TZ) columns tried on every form
CANDIDATES = ((4, 32), (6, 32), (8, 32), (10, 32), (12, 32), (16, 32), (24, 32), (6, 30), (14, 30), (4, 64), (8, 64))
SEGMENTS = (16, 24, 32, 48, 64, 128)  # the wrapper's column at these segment lengths too
# form: (velocity set, collision, walled, store, shifted)
FORMS = {
    "cavity-f32": ("D3Q19", "BGK", 0, torch.float32, False),
    "cavity-bf16": ("D3Q19", "BGK", 0, torch.bfloat16, True),
    "open-f32": ("D3Q19", "BGK", 2, torch.float32, False),
    "open-bf16": ("D3Q19", "BGK", 2, torch.bfloat16, True),
    "hybrid-f32": ("D3Q19", "BGK", 3, torch.float32, False),
    "hybrid-bf16": ("D3Q19", "BGK", 3, torch.bfloat16, True),
    "hybrid-d24-f32": ("D3Q19", "BGK", 3, torch.float32, False),
    "smagorinsky-f32": ("D3Q19", "SmagorinskyLESBGK", 0, torch.float32, False),
    "trt-f32": ("D3Q19", "TRT", 0, torch.float32, False),
    "mrt-f32": ("D3Q19", "MRT", 0, torch.float32, False),
    "powerlaw-f32": ("D3Q19", "PowerLawBGK", 0, torch.float32, False),
    "kbc-f32": ("D3Q27", "KBC", 0, torch.float32, False),
    "kbc-bf16": ("D3Q27", "KBC", 0, torch.bfloat16, True),
    "kbc-open-f32": ("D3Q27", "KBC", 2, torch.float32, False),
    "kbc-hybrid-f32": ("D3Q27", "KBC", 3, torch.float32, False),
    "kbc-hybrid-bf16": ("D3Q27", "KBC", 3, torch.bfloat16, True),
}
KBC_TUNNEL = (384, 192)  # windtunnel_3d at (nx, nyz): the D3Q27 KBC open and hybrid forms' full scene
SPHERE_D = {"hybrid-d24-f32": 24}  # the sphere-drag tunnel's D (else chip_smoke's D=48): 24 is its script's default
EXT = {0: ("kExtNone", "false"), 1: ("kExtHalfway", "true"), 2: ("kExtOpen", "true"), 3: ("kExtHybrid", "true")}
COLL = {"BGK": "CollBGK", "KBC": "CollKBC", "SmagorinskyLESBGK": "CollSmagorinsky", "TRT": "CollTRT", "MRT": "CollMRT",
        "PowerLawBGK": "CollPowerLaw"}  # the collisions' traits in csrc/collide_stream.cuh
RAGGED = (100, 52, 44)
SEED = 13


def _parent_code(header, stencil, collision, walled):
    """A source launching the parent's kstep_kernel of one form at k = 2 on
    the parent's own tile (its wrapper's rule: the first of its candidate
    boxes whose sweep buffers fit 113 KB), f32 and bf16-shifted."""
    ext, force = EXT[walled]
    entries = "".join(f"""
extern "C" int parent_kstep_{name}(const void* f, const void* mask, void* out, int X, int Y, int Z, float omega,
                                   const void* aux, const XlbStepParams* p, void* stream) {{
  return launch<{t}, {shifted}>(f, mask, out, X, Y, Z, omega, aux, p, stream);
}}""" for name, t, shifted in (("f32", "float", "false"), ("bf16", "__nv_bfloat16", "true")))
    return f"""#include "{header}"

namespace {{
using namespace xlb;
using S = {stencil};
using C = {collision};

template <typename T, bool SHIFTED>
int launch(const void* f, const void* mask, void* out, int X, int Y, int Z, float omega, const void* aux,
           const XlbStepParams* p, void* stream) {{
  static const int boxes[][3] = {{{{4, 8, 32}}, {{4, 4, 32}}, {{4, 4, 16}}, {{2, 4, 16}}, {{2, 2, 16}}, {{2, 2, 8}},
                                 {{1, 1, 8}}}};
  int tx = 0, ty = 0, tz = 0;
  for (const auto& b : boxes)
    if (kstep_smem_bytes<S>(2, b[0], b[1], b[2], sizeof(T)) <= 113 * 1024) {{
      tx = b[0], ty = b[1], tz = b[2];
      break;
    }}
  const size_t smem = kstep_smem_bytes<S>(2, tx, ty, tz, sizeof(T));
  auto kernel = kstep_kernel<S, C, T, SHIFTED, {ext}, {force}>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((Z + tz - 1) / tz, (Y + ty - 1) / ty, (X + tx - 1) / tx);
  kstep_kernel<S, C, T, SHIFTED, {ext}, {force}><<<grid, kKstepThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f), static_cast<const int*>(mask), static_cast<T*>(out), X, Y, Z, tx, ty, tz, 2, omega, *p,
      static_cast<const float*>(aux));
  return cudaGetLastError();
}}
}}  // namespace
{entries}
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


def build(forms, parent=None):
    """Build the kernel library and, with ``parent``, one parent source per
    form, all at once; returns {form: parent library path} (empty without
    ``parent``)."""
    jobs = {}
    if parent:
        nvcc = _cuda.find_nvcc()
        header = Path(parent).resolve()
        key = hashlib.sha256(header.read_bytes() + repr(_cuda.NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD / key
        out.mkdir(parents=True, exist_ok=True)
        for name in forms:
            vs, coll, walled = FORMS[name][:3]
            src = out / f"parent_{vs}_{coll}_{walled}.cu"
            src.write_text(_parent_code(header, f"xlb::{vs}", f"xlb::{COLL[coll]}", walled))
            jobs[name] = (src, src.with_suffix(".so"))
    sources = set(jobs.values())  # the two policies of a form share its source
    with ThreadPoolExecutor(1 + len(sources)) as pool:
        main = pool.submit(_cuda.load_library)
        libs = {job: pool.submit(_compile, nvcc, *job) for job in sources}
        main.result()
        return {name: libs[job].result() for name, job in jobs.items()}


def _bind_parent(path, name):
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"parent_kstep_{'bf16' if name.endswith('bf16') else 'f32'}")
    fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, ctypes.c_float, ptr, ctypes.POINTER(_cuda.XlbStepParams), ptr]
    fn.restype = i32
    return fn


def scenes(name, device, full):
    """(stepper, mask, omega, aux bytes per step) of a form's ragged scenes
    (``full`` False: a list) or its full scene."""
    import chip_smoke as cs
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    vs_name, coll, walled, _, shifted = FORMS[name]
    policy = xlb.PrecisionPolicy.FP32BF16 if shifted else xlb.PrecisionPolicy.FP32FP32
    torch_tier = xlb.ComputeBackend.TORCH

    def done(stepper, fields, omega):
        mask = pack_masks(fields[2], fields[3])
        specs = [bc_to_spec(b, stepper.velocity_set) for b in stepper.boundary_conditions]
        aux = (cs.hybrid_aux_bytes(specs, fields[2], stepper.velocity_set) if walled == 3
               else cs.open_aux_bytes(specs, fields[2], stepper.velocity_set.d))
        return stepper, mask, omega, aux

    def kbc_tunnel(object_bc):
        from xlb_tpu_torch.examples.cfd.windtunnel_3d import build as tunnel

        nx, nyz = KBC_TUNNEL
        return done(*tunnel(nx=nx, nyz=nyz, object_bc=object_bc, precision=policy.name, device=device)[:3])

    if walled == 0 and (vs_name, coll) == ("D3Q19", "BGK"):
        if not full:
            return [done(*cs.cavity(RAGGED, policy, torch_tier, device), cs.OMEGA)]
        return done(*cs.cavity((cs.N_MAIN,) * 3, policy, torch_tier, device), cs.OMEGA)
    if walled == 0:
        return ([done(*cs.zoo_scene("cavity", vs_name, coll, RAGGED, policy, torch_tier, device))] if not full
                else done(*cs.zoo_scene("cavity", vs_name, coll, (cs.N_MAIN,) * 3, policy, torch_tier, device)))
    if walled == 2:
        if not full:
            return [done(*cs.open_scene(kind, RAGGED, policy, torch_tier, device), cs.OPEN_OMEGA)
                    for kind in cs.OPEN_SCENES if cs.OPEN_SCENES[kind] == (vs_name, coll)]
        if vs_name == "D3Q27":
            return kbc_tunnel("halfway")
        from xlb_tpu_torch.examples.cfd.flow_past_sphere_3d import build as sphere_flow

        nx, nyz, _ = cs.OPEN_BIG
        return done(*sphere_flow(nx=nx, nyz=nyz, backend="cuda", precision=policy.name, device=device))
    if not full:
        return [done(*cs.hybrid_scene((vs_name, coll), method, True, "spin", "open", RAGGED, device, policy.name),
                     cs.HYBRID_OMEGA) for method in cs.HYBRID_METHODS]
    if vs_name == "D3Q27":
        return kbc_tunnel("hybrid")
    from xlb_tpu_torch.examples.cfd.sphere_drag_validation import build as sphere_drag

    d = SPHERE_D.get(name, cs.SPHERE_BIG_D)
    return done(*sphere_drag(d=d, backend="cuda", precision=policy.name, device=device)[:3])


def lines(name, stepper, mask, omega, device, parent_fn, lib):
    """{label: (launch(f) -> f after 2 steps, launch shape or None)} of a
    form on one scene: "2 K1", "parent K2", every candidate column, the
    wrapper's at SEGMENTS; and the aux field."""
    import chip_smoke as cs

    _, _, walled, store, shifted = FORMS[name]
    (one, two, _), aux, specs = cs.open_kernels(stepper, store, shifted)
    assert one.params.walled == walled, (name, one.params.walled)
    kw = dict(collision=one.collision, bc_specs=specs, store_dtype=store, shifted=shifted,
              has_solids=stepper.has_solids, force_vector=one.force_vector)
    vs, shape = stepper.velocity_set, tuple(stepper.grid.shape)
    out = {"2 K1": (lambda f: one(one(f, mask, omega, *aux), mask, omega, *aux), None)}
    if parent_fn is not None:
        def parent(f):
            y = torch.empty_like(f)
            _cuda.check(lib, parent_fn(f.data_ptr(), mask.data_ptr(), y.data_ptr(), *shape, float(omega),
                                       _cuda.data_ptr(aux[0] if aux else None), ctypes.byref(one.params),
                                       torch.cuda.current_stream(device).cuda_stream), "parent K2")
            return y
        out["parent K2"] = (parent, None)
    variants = [(t, None) for t in CANDIDATES if kstep_smem_bytes(2, t, store.itemsize, vs.q) <= MAX_SHARED]
    variants += [(two.tile, seg) for seg in SEGMENTS if seg != two.segment_on(lib, device) and seg < shape[0]]
    for tile, seg in variants:
        k2 = CollideStreamKStep(vs, shape, steps=2, tile=tile, segment=seg, **kw)
        shp = k2.launch_shape(lib)
        if shp[0] < 1:
            continue
        label = (f"K2 {tile[0]}x{tile[1]} seg {k2.segment_on(lib, device)}"
                 + (" (table)" if tile == two.tile and seg is None else ""))
        out[label] = (lambda f, k2=k2: k2(f, mask, omega, *aux),
                      shp + (kstep_smem_bytes(2, tile, store.itemsize, vs.q),))
    return out, aux


def check_ragged(name, device, parent_fn, lib):
    """Every line bit for bit against two K1 launches on the form's ragged
    scenes; returns the number of comparisons."""
    import chip_smoke as cs

    n = 0
    store, shifted = FORMS[name][3:]
    for stepper, mask, omega, _ in scenes(name, device, full=False):
        all_lines, aux = lines(name, stepper, mask, omega, device, parent_fn, lib)
        f = cs.perturbed(stepper.velocity_set, RAGGED, store, shifted, SEED, device)
        ref = all_lines["2 K1"][0](f)
        for label, (run, _) in all_lines.items():
            y = run(f)
            torch.cuda.synchronize()
            if not torch.equal(y, ref):
                raise RuntimeError(f"{name}: {label} differs from two K1 launches at {RAGGED}")
            n += 1
    return n


def sweep_form(name, device, parent_fn, lib, iters, rounds):
    """The timed lines of one form on its full scene: {label: record}."""
    import chip_smoke as cs

    vs_name, coll, _, store, shifted = FORMS[name]
    stepper, mask, omega, aux_bytes = scenes(name, device, full=True)
    vs, shape = stepper.velocity_set, tuple(stepper.grid.shape)
    all_lines, _ = lines(name, stepper, mask, omega, device, parent_fn, lib)
    f = cs.perturbed(vs, shape, store, shifted, SEED, device)
    bound_ms, bound_by = cs.open_bound(vs, coll, f, mask, 2 * aux_bytes, shifted, 2)
    best = interleaved_ms({label: (lambda v, run=run: run(f)) for label, (run, _) in all_lines.items()}, f, iters,
                          rounds)
    two_k1, parent = best["2 K1"], best.get("parent K2")
    out = {}
    print(f"{name}: {'x'.join(map(str, shape))} {vs_name} {coll} {store}{' shifted' if shifted else ''}, bound "
          f"{bound_ms:.4f} ms per 2 steps by {bound_by}")
    for label, ms in sorted(best.items(), key=lambda kv: kv[1]):
        shp = all_lines[label][1]
        rec = {"ms": ms, "x_2k1": ms / two_k1, "x_parent": ms / parent if parent else None,
               "bound_share": bound_ms / ms}
        if shp:
            rec.update(blocks_per_sm=shp[0], registers=shp[1], local_bytes=shp[2], smem=shp[3])
        out[label] = rec
        shape_txt = (f", {shp[0]} blocks/SM, {shp[3]} B smem, {shp[1]} regs, {shp[2]} B local" if shp else "")
        vs_parent = f"{rec['x_parent']:.4f} x parent K2, " if parent else ""
        print(f"  {label}: {ms:.4f} ms, {vs_parent}{rec['x_2k1']:.4f} x 2 K1, {rec['bound_share']:.4f} of bound"
              + shape_txt, flush=True)
    del stepper, mask, f, all_lines
    torch.cuda.empty_cache()
    return {"shape": list(shape), "bound_ms": bound_ms, "bound_by": bound_by, "lines": out}


def kstep_ptxas():
    """ptxas's (kernel, registers, spill stores, spill loads) of every
    kstep_kernel instantiation of the library's build, demangled where
    c++filt is there."""
    rows = [r for r in _cuda.ptxas_report() if "kstep_kernel" in r[0]]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows), capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [r[0] for r in rows]
    if len(names) != len(rows):
        names = [r[0] for r in rows]
    return [(n, r[1], r[2], r[3]) for n, r in zip(names, rows)]


def main():
    p = argparse.ArgumentParser(description="the k-step kernel's design sweep against two K1 launches")
    p.add_argument("--parent", default=None, help="another tree's csrc/collide_stream_3d.cuh, built as it stands")
    p.add_argument("--forms", default=",".join(FORMS), help="comma-separated forms of FORMS")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--out", default=None, help="write the results to this JSON file")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kstep_sweep: needs a CUDA device")
    forms = args.forms.split(",")
    unknown = [f for f in forms if f not in FORMS]
    if unknown:
        raise SystemExit(f"kstep_sweep: unknown forms {unknown}; choose from {list(FORMS)}")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    parents = build(forms, args.parent)
    lib = _cuda.load_library()
    print(f"kstep_sweep: {torch.cuda.get_device_name(device)} ({smi}), windows of {args.iters} calls, best of "
          f"{args.rounds} alternating rounds; parent {args.parent}")
    result = {"card": smi, "device": torch.cuda.get_device_name(device), "iters": args.iters, "rounds": args.rounds,
              "forms": {}}
    with torch.no_grad():
        for name in forms:
            parent_fn = _bind_parent(parents[name], name) if name in parents else None
            n = check_ragged(name, device, parent_fn, lib)
            print(f"{name}: {n} lines bit-equal to two K1 launches on the ragged {'x'.join(map(str, RAGGED))} scenes")
            result["forms"][name] = sweep_form(name, device, parent_fn, lib, args.iters, args.rounds)
            result["forms"][name]["ragged_comparisons"] = n
    result["ptxas"] = kstep_ptxas()
    print("ptxas (kstep_kernel): " + "; ".join(f"{n}: {r} regs, {s}/{l} B spill stores/loads"
                                               for n, r, s, l in result["ptxas"]))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
