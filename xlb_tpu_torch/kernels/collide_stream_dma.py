"""Single fused collide-stream step: wrapper of the CUDA kernel and its
plain version.

``CollideStreamStep`` is the counterpart of
``xlb_tpu.kernels.collide_stream_dma.build_fused_collide_stream_3d_dma``.
Its CUDA kernel (``csrc/collide_stream_3d.cuh::step_kernel``) replaces
that TPU kernel in its plain mode, with and without shifted storage, for
D3Q19 and D3Q27, every collision, the exact-difference force and halfway
walls, and -- on D3Q19 BGK and D3Q27 KBC -- the open-boundary epilogues
(``OPEN_KINDS``: do-nothing, free-slip, Zou-He and regularized in 3D,
extrapolation outflow with its staging, per-voxel prescriptions from the
aux field) and the hybrid curved wall (the kExtHybrid form); and its
field modes ``ade`` and ``extern_force`` (``FIELD_PAIRS``,
``csrc/collide_stream_3d.cuh::field_step_kernel``). The TPU kernel's double-buffered halo DMAs have no counterpart: on
Hopper each thread pulls its q neighbours straight from device memory, and
L1/L2 serve the reuse.

A wrapper launches its kernel for a CUDA tensor and runs the plain version
for a CPU tensor; any other device raises.
"""

import ctypes

import numpy as np
import torch

from xlb_tpu_torch.kernels import _cuda
from xlb_tpu_torch.kernels.collide_stream import (FIELDS, aux_layout, collision_constants, f32_weights, field_base,
                                                  kernel_bc_id, outflow_cs, pointwise_core, spec_uses_aux,
                                                  split_collision)


def plain_collide(vs, bc_specs, fc, mask_i32, omega, shifted=False, has_solids=True, collision="BGK",
                  force_vector=None, aux=None, field=None):
    """The plain step before its store: pull-stream gather of the float32
    store-form field ``fc`` with periodic wrap, then ``pointwise_core``
    (``aux``: the field mode's channels and the BCs' per-voxel
    prescriptions, or None). Returns the post-collision populations (q,
    *s), unshifted, float32."""
    dims = tuple(range(vs.d))

    def pulled(l, t):
        return torch.roll(fc[l], shifts=tuple(int(s) for s in t), dims=dims)

    fs_raw = [pulled(l, vs._c[:, l]) for l in range(vs.q)]
    return torch.stack(pointwise_core(vs, bc_specs, fs_raw, lambda l: fc[l], mask_i32, omega, shifted, has_solids,
                                      collision, force_vector, aux, pulled, field))


def collide_stream_step_plain(vs, bc_specs, f, mask_i32, omega, store_dtype, shifted=False, has_solids=True,
                              collision="BGK", force_vector=None, aux=None, field=None):
    """Plain torch version of one fused step: ``plain_collide``, then the
    (shifted) store."""
    out = plain_collide(vs, bc_specs, f.to(torch.float32), mask_i32, omega, shifted, has_solids, collision,
                        force_vector, aux, field)
    if shifted:
        out = out - torch.tensor(f32_weights(vs), device=out.device).reshape((-1,) + (1,) * vs.d)
    return out.to(store_dtype)


# epilogue kinds behind the EXT switch of csrc/collide_stream.cuh: all of
# them in the 2D kernels (K3, K4); halfway alone in the 3D kernels of the
# collision zoo (K0, K1, K2, and their adjoint K8)
EXT_KINDS = ("halfway", "zouhe", "regularized")
# the 2D kernels' kinds: with a hybrid BC or a per-voxel prescription they
# run their kExtHybrid form (EXT_2D_HYBRID)
KINDS_2D = frozenset({"equilibrium", "fullway", "hybrid"} | set(EXT_KINDS))
# the kinds of the 3D kernels that take no EXT epilogue (K5, K7) and of
# those that take halfway
BASE_KINDS_3D = frozenset({"equilibrium", "fullway"})
ZOO_KINDS_3D = BASE_KINDS_3D | {"halfway"}
# the open-boundary epilogues (EXT == kExtOpen), in K0, K1, K2 and K8, and
# only for OPEN_PAIRS; a halfway wall with a per-voxel velocity is one too.
# The hybrid curved wall (EXT == kExtHybrid: kExtOpen's epilogues and
# hybrid) likewise.
OPEN_KINDS = frozenset({"do_nothing", "free_slip", "zouhe", "regularized", "extrapolation_outflow"})
OPEN_KINDS_3D = ZOO_KINDS_3D | OPEN_KINDS | {"hybrid"}
OPEN_PAIRS = ((19, "BGK"), (27, "KBC"))
# XlbBc.flag bits of the open epilogues; the aux channel offset sits above them
FLAG_PRESSURE, FLAG_AUX, FLAG_AUX_SHIFT = 1, 2, 8
# XlbBc.flag of a hybrid BC: the method in bits 0-1 (HYBRID_METHODS'
# order), the wall distances in bit 2, the moving wall's form in bits 3-4
# (0 none, 1 static: vec holds 6 w_l (c_l . u); 2 per voxel: vec holds
# 6 w_l, the aux field the velocity), the weights' first aux channel in bits
# 8-19 and the velocity's in bits 20-30
HYBRID_METHODS = ("bounceback", "bounceback_regularized", "bounceback_grads", "nonequilibrium_regularized")
FLAG_HYB_DIST, FLAG_HYB_MW_SHIFT, FLAG_HYB_W_SHIFT, FLAG_HYB_U_SHIFT = 4, 3, 8, 20
# the field modes (collide_stream.FIELDS) of K1 and K3: the (q, collision)
# pairs with CUDA instantiations, and the BC kinds of the advection-diffusion
# step (as xlb_tpu's fused ADE: voxel-local kinds, constant prescriptions).
# They are the construction-time gate and change together with has_field of
# csrc/collide_stream.cuh, as OPEN_PAIRS with has_open; the C entries refuse
# any form outside has_field (cudaErrorInvalidValue, raised by the launch).
FIELD_PAIRS = {"ade": ((9, "BGK"), (19, "BGK")), "extern_force": ((9, "BGK"), (19, "BGK"), (27, "KBC"))}
ADE_KINDS = frozenset({"equilibrium", "do_nothing", "halfway", "fullway", "zouhe", "regularized"})
# the launchers' field codes (csrc/collide_stream.cuh: kFieldAde, kFieldForce)
FIELD_CODE = {"ade": 1, "extern_force": 2}


def has_hybrid(bc_specs):
    """True when a scene has a hybrid (curved-wall) BC."""
    return any(s["kind"] == "hybrid" for s in bc_specs)


def needs_open(bc_specs, dims=3):
    """True when a 3D scene's BCs need the open-boundary (kExtOpen) or the
    curved-wall (kExtHybrid) instantiation: an open kind, a hybrid BC, or a
    per-voxel prescription."""
    return dims == 3 and (has_hybrid(bc_specs) or any(s["kind"] in OPEN_KINDS or spec_uses_aux(s) for s in bc_specs))


def hybrid_flag(spec, u_off, w_offs):
    """The ``XlbBc.flag`` of a hybrid BC's spec."""
    flag = HYBRID_METHODS.index(spec["method"])
    if spec["use_dist"]:
        w_off = w_offs[spec["id"]]
        if w_off >= 1 << 12:
            raise NotImplementedError(f"the hybrid BC's weights at aux channel {w_off} exceed the flag's 12 bits")
        flag |= FLAG_HYB_DIST | (w_off << FLAG_HYB_W_SHIFT)
    if isinstance(spec["mw"], str):
        flag |= (2 << FLAG_HYB_MW_SHIFT) | (u_off << FLAG_HYB_U_SHIFT)
    elif spec["mw"] is not None:
        flag |= 1 << FLAG_HYB_MW_SHIFT
    return flag


def _f32_list(values):
    return [float(x) for x in np.asarray(values, dtype=np.float64).astype(np.float32).reshape(-1)]


def check_field(vs, bc_specs, collision, force_vector, field):
    """Raise ``NotImplementedError`` unless K1 / K3 have the field mode
    ``field`` for this stencil, collision and BC set."""
    name, _ = split_collision(collision)
    if force_vector is not None:
        raise NotImplementedError("use either a static force_vector or the per-voxel force field, not both")
    if field == "ade":
        bad = sorted({s["kind"] for s in bc_specs if s["kind"] not in ADE_KINDS or spec_uses_aux(s)})
        if bad:
            raise NotImplementedError(f"the fused advection-diffusion step takes the BC kinds {sorted(ADE_KINDS)} "
                                      f"with constant prescriptions; got {bad}")
    if (vs.q, name) not in FIELD_PAIRS[field]:
        pairs = ", ".join(f"D{2 if q == 9 else 3}Q{q} {c}" for q, c in FIELD_PAIRS[field])
        raise NotImplementedError(f"the {field!r} mode is instantiated for {pairs} only, got D{vs.d}Q{vs.q} {name}")


def kernel_params(vs, bc_specs, has_solids, kinds=None, collision="BGK", force_vector=None, field=None):
    """The kernels' launch parameters (``XlbStepParams``) for a D3Q19,
    D3Q27 or D2Q9 scene. ``kinds`` is the set of epilogue kinds the calling
    kernel takes; by default every kind in 2D and ``BASE_KINDS_3D`` in 3D.
    ``collision`` (a ``kernel_collision_spec``) and ``force_vector`` fill
    the collision fields that the kernels of the zoo read. ``field`` (one
    of ``FIELDS``) lays the BCs' aux channels after the field's d and
    selects a walled form in 3D (the field forms have no unwalled one)."""
    from xlb_tpu_torch.velocity_set import D2Q9, D3Q19, D3Q27

    ref = {9: D2Q9, 19: D3Q19, 27: D3Q27}.get(vs.q)
    if ref is None or vs.d != ref().d or not np.array_equal(vs._c, ref()._c):
        raise NotImplementedError(
            f"the CUDA kernels are built for xlb_tpu's D3Q19, D3Q27 and D2Q9 direction orders, got {vs}")
    q = vs.q
    p = _cuda.XlbStepParams()
    p.w[:q] = f32_weights(vs)
    p.w45[:q] = _f32_list(4.5 * vs._w)
    p.has_solids = int(bool(has_solids))
    p.n_bc = len(bc_specs)
    # as many BCs as the packed id field carries (kernel_bc_id checks each
    # id; distinct ids, so at most MAX_BC), as in xlb_tpu
    if len(bc_specs) > _cuda.MAX_BC:
        raise ValueError(f"{len(bc_specs)} BCs exceed the packed id field's {_cuda.MAX_BC} ids")
    allowed = kinds if kinds is not None else (BASE_KINDS_3D if vs.d == 3 else KINDS_2D)
    if field is not None:
        check_field(vs, bc_specs, collision, force_vector, field)
    u_off, rho_off, w_offs, _ = aux_layout(bc_specs, vs, field_base(field, vs))
    for b, spec in enumerate(bc_specs):
        kind = spec["kind"]
        if kind not in allowed:
            raise NotImplementedError(f"BC kind {kind!r} is not ported to the {vs.d}D CUDA kernels")
        if spec_uses_aux(spec) and "hybrid" not in allowed:
            raise NotImplementedError(
                f"a per-voxel {kind!r} prescription needs the aux channels, which only the kernels K0, K1, K2, K3 "
                "and K4 read")
        p.bc_kind[b] = _cuda.BC_KIND[kind]
        p.bc_id[b] = kernel_bc_id(int(spec["id"]), q)
        bc = p.bc[b]
        if kind == "equilibrium":
            bc.vec[:q] = [float(x) for x in np.asarray(spec["feq"], dtype=np.float32)]
        elif kind == "halfway" and isinstance(spec["mw"], str):
            # per-voxel wall velocity: vec holds 6 w_l, the aux its velocity
            bc.flag = FLAG_AUX | (u_off << FLAG_AUX_SHIFT)
            bc.vec[:q] = _f32_list(6.0 * vs._w)
        elif kind == "halfway" and spec["mw"] is not None:
            bc.flag = 1
            bc.vec[:q] = _f32_list(spec["mw"])
        elif kind in ("zouhe", "regularized"):
            bc.flag = FLAG_PRESSURE if spec["bc_type"] == "pressure" else 0
            if spec_uses_aux(spec):
                bc.flag |= FLAG_AUX | ((u_off if spec["value"] == "aux" else rho_off) << FLAG_AUX_SHIFT)
            else:
                value = _f32_list(spec["value"])
                bc.vec[: len(value)] = value
        elif kind == "hybrid":
            bc.flag = hybrid_flag(spec, u_off, w_offs)
            if isinstance(spec["mw"], str):
                bc.vec[:q] = _f32_list(6.0 * vs._w)
            elif spec["mw"] is not None:
                bc.vec[:q] = _f32_list(spec["mw"])
        elif kind in ("free_slip", "extrapolation_outflow"):
            # the outward normal; the outflow's sound speed after it
            bc.vec[:3] = [float(x) for x in spec["normal"]]
            bc.vec[3] = outflow_cs()

    name, _ = split_collision(collision)
    if name not in _cuda.COLLISION:
        raise NotImplementedError(f"collision {name!r} has no CUDA kernel")
    if name == "KBC" and q not in (9, 27):
        raise NotImplementedError(f"KBC supports D2Q9 and D3Q27 only, got {vs}")
    k = collision_constants(collision)
    p.q = q
    p.collision = _cuda.COLLISION[name]
    p.walled = int(field is not None or force_vector is not None or any(s["kind"] == "halfway" for s in bc_specs))
    if needs_open(bc_specs, vs.d):
        if (q, name) not in OPEN_PAIRS:
            raise NotImplementedError(
                f"the open-boundary and curved-wall epilogues ({sorted({s['kind'] for s in bc_specs})}) are "
                f"instantiated for D3Q19 BGK and D3Q27 KBC only, got D3Q{q} {name}")
        p.walled = 3 if has_hybrid(bc_specs) else 2  # the kExtHybrid or kExtOpen instantiation
    if force_vector is not None:
        p.has_force = 1
        p.force[: vs.d] = _f32_list(force_vector)
    if name == "TRT":
        p.coll[0] = k["magic"]
    elif name == "SmagorinskyLESBGK":
        p.coll[0] = k["c36"]
    elif name == "PowerLawBGK":
        p.coll[0], p.coll[1], p.coll[2] = k["k3"], k["nm1"], k["eps"]
        p.coll_iters = k["iterations"]
    elif name == "MRT":
        _, params = split_collision(collision)
        from xlb_tpu_torch.ops.collision import mrt_projectors

        P = mrt_projectors(vs)
        groups = [g for g, rate in (("bulk", params["bulk_rate"]), ("ghost", params["ghost_rate"])) if rate is not None]
        for (rate, mat), g in zip(k["fixed"], groups):
            if not np.array_equal(mat, P[g]):
                raise NotImplementedError("the MRT kernels hold the stencil's own bulk and ghost projectors")
            i = ("bulk", "ghost").index(g)
            p.mrt_on[i], p.mrt_rate[i] = 1, rate
    return p


class FusedKernel:
    """Shared wrapper logic of the fused kernels: configuration checks,
    input checks, device dispatch and the launch counters.

    Subclasses define ``launches`` and ``plain_calls`` (counts over all
    their instances), ``plain`` and ``_launch``, and ``dims`` when they run
    another dimension than 3; a kernel with another signature defines its
    own ``__call__`` around ``_dispatch``. The kernels of the 3D collision
    zoo (``zoo = True``: K0, K1, K2) take every collision, D3Q27, the body
    force and halfway walls, and on ``OPEN_PAIRS`` the open-boundary kinds;
    the others BGK without force on D3Q19 or D2Q9. A scene whose BCs read
    per-voxel prescriptions (``aux_channels`` > 0) passes its aux field,
    (aux_channels, *shape) float32 from ``fused_step.build_aux_field``, to
    every call. A kernel with a field mode (``fields``: K1 and K3) built
    with ``field`` reads the per-voxel field in the aux field's first d
    channels, the BCs' after them, and stores unshifted; ``field_launches``
    counts its launches by mode."""

    dims = 3
    zoo = False
    bc_kinds = None  # the epilogue kinds the kernel takes (kernel_params' default when None)
    kernel_kind = None  # the zoo kernels' code in csrc/collide_stream_3d.cuh (XLB_KERNEL_*)
    fields = ()  # the field modes the kernel has

    def __init__(self, velocity_set, shape, collision="BGK", bc_specs=(), compute_dtype=torch.float32,
                 store_dtype=torch.float32, shifted=False, has_solids=True, force_vector=None, field=None):
        if velocity_set.d != self.dims:
            raise NotImplementedError(f"{type(self).__name__} runs {self.dims}D scenes, got {velocity_set}")
        name, _ = split_collision(collision)
        if field is not None:
            if field not in self.fields:
                raise NotImplementedError(f"{type(self).__name__} has no {field!r} mode")
            if shifted:
                raise NotImplementedError(f"the {field!r} mode stores unshifted, as in xlb_tpu")
        if not self.zoo:
            if name != "BGK":
                raise NotImplementedError(f"only BGK is ported to {type(self).__name__}, got {name!r}")
            if force_vector is not None:
                raise NotImplementedError(f"{type(self).__name__} has no body force")
            if velocity_set.q == 27:
                raise NotImplementedError(f"{type(self).__name__} is not ported to D3Q27")
        if compute_dtype != torch.float32:
            raise NotImplementedError(f"the fused step computes in float32, got {compute_dtype}")
        if store_dtype not in _cuda.STORE_KIND:
            raise NotImplementedError(f"the fused step stores float32 or bfloat16, got {store_dtype}")
        self.vs = velocity_set
        self.shape = tuple(int(s) for s in shape)
        if int(np.prod(self.shape)) >= 2**31:
            raise ValueError(f"domain {self.shape} exceeds the kernels' 32-bit voxel index")
        self.bc_specs = list(bc_specs)
        self.collision = collision
        self.force_vector = None if force_vector is None else np.asarray(force_vector, dtype=np.float64)
        self.store_dtype = store_dtype
        self.shifted = bool(shifted)
        self.has_solids = bool(has_solids)
        self.field = field
        kinds = self.bc_kinds if self.bc_kinds is not None else (ZOO_KINDS_3D if self.zoo else None)
        self.params = kernel_params(velocity_set, self.bc_specs, has_solids, kinds, collision, self.force_vector,
                                    field)
        self.aux_channels = aux_layout(self.bc_specs, velocity_set, field_base(field, velocity_set))[3]

    def _plain_step(self, f, mask_i32, omega, aux=None):
        """One plain step of this configuration, stored in the store dtype."""
        return collide_stream_step_plain(self.vs, self.bc_specs, f, mask_i32, omega, self.store_dtype, self.shifted,
                                         self.has_solids, self.collision, self.force_vector, aux, self.field)

    def _check_aux(self, f, aux):
        """Raise unless ``aux`` is the aux field this configuration reads
        (None when it reads none)."""
        if not self.aux_channels:
            if aux is not None:
                raise ValueError(f"{type(self).__name__}: this scene's BCs read no aux field")
            return
        shape = (self.aux_channels,) + self.shape
        if aux is None:
            raise ValueError(f"{type(self).__name__}: this configuration reads a {shape} aux field (the field "
                             "mode's channels, then build_aux_field's)")
        if aux.shape != shape or aux.dtype != torch.float32 or not aux.is_contiguous() or aux.device != f.device:
            raise ValueError(f"aux must be a contiguous float32 {shape} tensor on {f.device}, got {aux.dtype} "
                             f"{tuple(aux.shape)} on {aux.device}")

    def _require_instantiation(self, lib):
        """Raise, naming it, when the library holds no instantiation of this
        zoo kernel's configuration (csrc/collide_stream_3d.cuh's table)."""
        p = self.params
        if not lib.xlb_has_instantiation(self.kernel_kind, p.q, p.collision, p.walled,
                                         _cuda.STORE_KIND[self.store_dtype], int(self.shifted)):
            name, _ = split_collision(self.collision)
            form = ("unwalled", "walled (halfway / force)", "open boundaries (kExtOpen)",
                    "curved walls (kExtHybrid)")[p.walled]
            raise NotImplementedError(
                f"{type(self).__name__}: no CUDA instantiation for D3Q{p.q} {name}, {form}, store {self.store_dtype}, "
                f"shifted={self.shifted} (the table of csrc/collide_stream_3d.cuh)")

    def _check(self, f, mask_i32):
        """Raise on anything the kernels do not take."""
        shape = (self.vs.q,) + self.shape
        if f.shape != shape:
            raise ValueError(f"f must have shape {shape}, got {tuple(f.shape)}")
        if f.dtype != self.store_dtype:
            raise TypeError(f"f must be {self.store_dtype}, got {f.dtype}")
        if mask_i32.shape != self.shape or mask_i32.dtype != torch.int32:
            raise ValueError(f"mask must be int32 of shape {self.shape}, got {mask_i32.dtype} {tuple(mask_i32.shape)}")
        if mask_i32.device != f.device:
            raise ValueError(f"f is on {f.device} but the mask is on {mask_i32.device}")
        if not (f.is_contiguous() and mask_i32.is_contiguous()):
            raise ValueError("f and the mask must be contiguous")
        if f.requires_grad:
            raise RuntimeError(
                f"{type(self).__name__} has no autograd of its own: differentiate through stepper(...) or "
                "build_multi_step (kernels.fused_step), whose autograd.Function runs the kernels on detached "
                "tensors and pairs the single step with its adjoint kernel"
            )
        if f.device.type not in ("cpu", "cuda"):
            raise ValueError(f"the fused step runs on CUDA (kernel) or CPU (plain version), not {f.device}")

    def _dispatch(self, f, plain, launch):
        """``plain()`` for a CPU tensor; for a CUDA tensor
        ``launch(lib, stream) -> (result, cuda error)``, checked and
        counted."""
        if f.device.type == "cpu":
            return plain()
        lib = _cuda.load_library()
        if self.zoo and self.field is None:  # check_field gated the field modes at construction
            self._require_instantiation(lib)
        with torch.cuda.device(f.device):
            result, err = launch(lib, torch.cuda.current_stream(f.device).cuda_stream)
        _cuda.check(lib, err, f"{type(self).__name__} launch")
        type(self).launches += 1
        if self.field is not None:
            type(self).field_launches[self.field] += 1
        return result

    def __call__(self, f, mask_i32, omega, aux=None):
        self._check(f, mask_i32)
        self._check_aux(f, aux)
        extra = () if aux is None else (aux,)

        def launch(lib, stream):
            out = torch.empty_like(f)
            return out, self._launch(lib, f, mask_i32, out, float(omega), stream, *extra)

        return self._dispatch(f, lambda: self.plain(f, mask_i32, omega, *extra), launch)


class CollideStreamStep(FusedKernel):
    """One fused LBM step: ``(f, mask_i32, omega) -> f_new``."""

    launches = 0
    plain_calls = 0
    field_launches = dict.fromkeys(FIELDS, 0)
    zoo = True
    bc_kinds = OPEN_KINDS_3D
    kernel_kind = 1  # XLB_KERNEL_STEP
    fields = FIELDS

    def plain(self, f, mask_i32, omega, aux=None):
        CollideStreamStep.plain_calls += 1
        return self._plain_step(f, mask_i32, omega, aux)

    def _launch(self, lib, f, mask_i32, out, omega, stream, aux=None):
        X, Y, Z = self.shape
        if self.field is not None:
            return lib.xlb_collide_stream_field_step(
                FIELD_CODE[self.field], _cuda.STORE_KIND[self.store_dtype], f.data_ptr(), mask_i32.data_ptr(),
                out.data_ptr(), X, Y, Z, omega, aux.data_ptr(), ctypes.byref(self.params), stream,
            )
        return lib.xlb_collide_stream_step(
            _cuda.STORE_KIND[self.store_dtype], int(self.shifted), f.data_ptr(), mask_i32.data_ptr(), out.data_ptr(),
            X, Y, Z, omega, _cuda.data_ptr(aux), ctypes.byref(self.params), stream,
        )
