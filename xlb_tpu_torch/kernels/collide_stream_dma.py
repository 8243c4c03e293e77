"""Single fused collide-stream step: wrapper of the CUDA kernel and its
plain version.

``CollideStreamStep`` is the counterpart of
``xlb_tpu.kernels.collide_stream_dma.build_fused_collide_stream_3d_dma``.
Its CUDA kernel (``csrc/collide_stream_3d.cuh::step_kernel``) replaces
that TPU kernel in its plain mode, with and without shifted storage, for
D3Q19 and D3Q27, every collision, the exact-difference force and halfway
walls. The TPU kernel's double-buffered halo DMAs have no counterpart: on
Hopper each thread pulls its q neighbours straight from device memory, and
L1/L2 serve the reuse.

A wrapper launches its kernel for a CUDA tensor and runs the plain version
for a CPU tensor; any other device raises.
"""

import ctypes

import numpy as np
import torch

from xlb_tpu_torch.kernels import _cuda
from xlb_tpu_torch.kernels.collide_stream import (collision_constants, f32_weights, kernel_bc_id, pointwise_core,
                                                  split_collision)


def plain_collide(vs, bc_specs, fc, mask_i32, omega, shifted=False, has_solids=True, collision="BGK",
                  force_vector=None):
    """The plain step before its store: pull-stream gather of the float32
    store-form field ``fc`` with periodic wrap, then ``pointwise_core``.
    Returns the post-collision populations (q, *s), unshifted, float32."""
    dims = tuple(range(vs.d))
    fs_raw = [torch.roll(fc[l], shifts=tuple(int(s) for s in vs._c[:, l]), dims=dims) for l in range(vs.q)]
    return torch.stack(pointwise_core(vs, bc_specs, fs_raw, lambda l: fc[l], mask_i32, omega, shifted, has_solids,
                                      collision, force_vector))


def collide_stream_step_plain(vs, bc_specs, f, mask_i32, omega, store_dtype, shifted=False, has_solids=True,
                              collision="BGK", force_vector=None):
    """Plain torch version of one fused step: ``plain_collide``, then the
    (shifted) store."""
    out = plain_collide(vs, bc_specs, f.to(torch.float32), mask_i32, omega, shifted, has_solids, collision,
                        force_vector)
    if shifted:
        out = out - torch.tensor(f32_weights(vs), device=out.device).reshape((-1,) + (1,) * vs.d)
    return out.to(store_dtype)


# epilogue kinds behind the EXT switch of csrc/collide_stream.cuh: all of
# them in the 2D kernels (K3, K4); halfway alone in the 3D kernels of the
# collision zoo (K0, K1, K2)
EXT_KINDS = ("halfway", "zouhe", "regularized")
# the kinds of the 3D kernels that take no EXT epilogue (K5, K7, K8) and of
# those that take halfway
BASE_KINDS_3D = frozenset({"equilibrium", "fullway"})
ZOO_KINDS_3D = BASE_KINDS_3D | {"halfway"}


def _f32_list(values):
    return [float(x) for x in np.asarray(values, dtype=np.float64).astype(np.float32).reshape(-1)]


def kernel_params(vs, bc_specs, has_solids, kinds=None, collision="BGK", force_vector=None):
    """The kernels' launch parameters (``XlbStepParams``) for a D3Q19,
    D3Q27 or D2Q9 scene. ``kinds`` is the set of epilogue kinds the calling
    kernel takes; by default every kind in 2D and ``BASE_KINDS_3D`` in 3D.
    ``collision`` (a ``kernel_collision_spec``) and ``force_vector`` fill
    the collision fields that the kernels of the zoo read."""
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
    allowed = kinds if kinds is not None else (BASE_KINDS_3D if vs.d == 3 else set(_cuda.BC_KIND))
    for b, spec in enumerate(bc_specs):
        kind = spec["kind"]
        if kind not in allowed:
            raise NotImplementedError(f"BC kind {kind!r} is not ported to the {vs.d}D CUDA kernels")
        p.bc_kind[b] = _cuda.BC_KIND[kind]
        p.bc_id[b] = kernel_bc_id(int(spec["id"]), q)
        bc = p.bc[b]
        if kind == "equilibrium":
            bc.vec[:q] = [float(x) for x in np.asarray(spec["feq"], dtype=np.float32)]
        elif kind == "halfway" and spec["mw"] is not None:
            bc.flag = 1
            bc.vec[:q] = _f32_list(spec["mw"])
        elif kind in ("zouhe", "regularized"):
            value = _f32_list(spec["value"])
            bc.flag = int(spec["bc_type"] == "pressure")
            bc.vec[: len(value)] = value

    name, _ = split_collision(collision)
    if name not in _cuda.COLLISION:
        raise NotImplementedError(f"collision {name!r} has no CUDA kernel")
    if name == "KBC" and q not in (9, 27):
        raise NotImplementedError(f"KBC supports D2Q9 and D3Q27 only, got {vs}")
    k = collision_constants(collision)
    p.q = q
    p.collision = _cuda.COLLISION[name]
    p.walled = int(force_vector is not None or any(s["kind"] == "halfway" for s in bc_specs))
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
    force and halfway walls; the others BGK without force on D3Q19 or
    D2Q9."""

    dims = 3
    zoo = False
    bc_kinds = None  # the epilogue kinds the kernel takes (kernel_params' default when None)
    kernel_kind = None  # the zoo kernels' code in csrc/collide_stream_3d.cuh (XLB_KERNEL_*)

    def __init__(self, velocity_set, shape, collision="BGK", bc_specs=(), compute_dtype=torch.float32,
                 store_dtype=torch.float32, shifted=False, has_solids=True, force_vector=None):
        if velocity_set.d != self.dims:
            raise NotImplementedError(f"{type(self).__name__} runs {self.dims}D scenes, got {velocity_set}")
        name, _ = split_collision(collision)
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
        kinds = self.bc_kinds if self.bc_kinds is not None else (ZOO_KINDS_3D if self.zoo else None)
        self.params = kernel_params(velocity_set, self.bc_specs, has_solids, kinds, collision, self.force_vector)

    def _plain_step(self, f, mask_i32, omega):
        """One plain step of this configuration, stored in the store dtype."""
        return collide_stream_step_plain(self.vs, self.bc_specs, f, mask_i32, omega, self.store_dtype, self.shifted,
                                         self.has_solids, self.collision, self.force_vector)

    def _require_instantiation(self, lib):
        """Raise, naming it, when the library holds no instantiation of this
        zoo kernel's configuration (csrc/collide_stream_3d.cuh's table)."""
        p = self.params
        if not lib.xlb_has_instantiation(self.kernel_kind, p.q, p.collision, p.walled,
                                         _cuda.STORE_KIND[self.store_dtype], int(self.shifted)):
            name, _ = split_collision(self.collision)
            raise NotImplementedError(
                f"{type(self).__name__}: no CUDA instantiation for D3Q{p.q} {name}, "
                f"{'walled (halfway / force)' if p.walled else 'unwalled'}, store {self.store_dtype}, "
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
        if self.zoo:
            self._require_instantiation(lib)
        with torch.cuda.device(f.device):
            result, err = launch(lib, torch.cuda.current_stream(f.device).cuda_stream)
        _cuda.check(lib, err, f"{type(self).__name__} launch")
        type(self).launches += 1
        return result

    def __call__(self, f, mask_i32, omega):
        self._check(f, mask_i32)

        def launch(lib, stream):
            out = torch.empty_like(f)
            return out, self._launch(lib, f, mask_i32, out, float(omega), stream)

        return self._dispatch(f, lambda: self.plain(f, mask_i32, omega), launch)


class CollideStreamStep(FusedKernel):
    """One fused LBM step: ``(f, mask_i32, omega) -> f_new``."""

    launches = 0
    plain_calls = 0
    zoo = True
    kernel_kind = 1  # XLB_KERNEL_STEP

    def plain(self, f, mask_i32, omega):
        CollideStreamStep.plain_calls += 1
        return self._plain_step(f, mask_i32, omega)

    def _launch(self, lib, f, mask_i32, out, omega, stream):
        X, Y, Z = self.shape
        return lib.xlb_collide_stream_step(
            _cuda.STORE_KIND[self.store_dtype], int(self.shifted), f.data_ptr(), mask_i32.data_ptr(), out.data_ptr(),
            X, Y, Z, omega, ctypes.byref(self.params), stream,
        )
