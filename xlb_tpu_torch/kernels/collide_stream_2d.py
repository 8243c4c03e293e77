"""Fused 2D (D2Q9) collide-stream steps: wrappers of the CUDA single-step
and k-step kernels and their plain versions.

``CollideStream2DStep`` (K3) is the counterpart of
``xlb_tpu.kernels.collide_stream_2d.build_fused_collide_stream_2d`` and
``CollideStream2DKStep`` (K4) of ``build_fused_collide_stream_2d_kstep``.
Their CUDA kernels (``csrc/collide_stream_2d.cu``) replace those TPU
kernels in their plain mode, with and without shifted storage, for the
epilogue kinds equilibrium, fullway, halfway, zouhe and regularized
(constant prescriptions: the kExtAll form) and, in the kExtHybrid form,
the hybrid curved wall (four methods, wall distances, static or per-voxel
moving wall) and the per-voxel prescriptions of the aux field (a halfway
wall's velocity, a Zou-He / regularized velocity or density); the single
step also in the field modes ``ade`` and ``extern_force``
(``step_2d_field_kernel``, unshifted, kExtAll and kExtHybrid). The 2D
outflow, free-slip and do-nothing are not ported: they raise. The TPU
tiling does not carry over: there the y pulls are lane rolls over a
lane-resident Y and the x halos come as 8-row blocks, which is why
xlb_tpu needs 8 | tile_x | X. Here the single step is one thread per voxel
pulling through L1/L2, and the k-step stages a (32, 48) tile with a
depth-k halo in x and y in shared memory, so any (X, Y) goes. Both read
the aux field from device memory, at the voxels of the BCs that use it.

The k-step's plain version is k single plain steps, each rounded to the
store dtype, which is what the kernel computes.
"""

import ctypes

import torch

from xlb_tpu_torch.kernels import _cuda
from xlb_tpu_torch.kernels.collide_stream_2step import _align16
from xlb_tpu_torch.kernels.collide_stream import FIELDS, spec_uses_aux
from xlb_tpu_torch.kernels.collide_stream_dma import EXT_KINDS, FIELD_CODE, FusedKernel

MAX_STEPS = 8  # 2 <= k <= 8, as in xlb_tpu
# the k-step's output tile (x, y): the fastest of those timed on an H100
# (32x32, 24x32, 40x40, 32x48; PERF.md)
TILE = (32, 48)
# mirrors k2dKstepThreads and k2dKstepVoxels of csrc/collide_stream_2d.cu: a
# sweep's region must fit the voxels the block's threads hold in registers
KSTEP_THREADS, KSTEP_VOXELS = 1024, 3
# the 2D kernels' EXT codes (csrc/collide_stream.cuh): kExtNone, kExtAll
# (constant halfway / Zou-He / regularized), kExtHybrid (those with the aux
# field's prescriptions, and hybrid)
EXT_2D_NONE, EXT_2D_ALL, EXT_2D_HYBRID = 0, 1, 4


def ext_2d(bc_specs):
    """The EXT form a 2D scene's BCs need."""
    if any(s["kind"] == "hybrid" or spec_uses_aux(s) for s in bc_specs):
        return EXT_2D_HYBRID
    return EXT_2D_ALL if any(s["kind"] in EXT_KINDS for s in bc_specs) else EXT_2D_NONE


def kstep_2d_smem_bytes(steps, tile, itemsize, q=9):
    """Dynamic shared memory of the 2D k-step kernel; mirrors
    ``kstep_2d_smem_bytes`` in ``csrc/collide_stream_2d.cu``: the staged
    populations (depth k) and the int32 mask tile (depth k - 1)."""
    tx, ty = tile
    return _align16(q * (tx + 2 * steps) * (ty + 2 * steps) * itemsize) + (tx + 2 * steps - 2) * (ty + 2 * steps - 2) * 4


class _Fused2D(FusedKernel):
    dims = 2

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.ext = ext_2d(self.bc_specs)
        if self.field is not None and self.ext == EXT_2D_NONE:
            self.ext = EXT_2D_ALL  # the field modes have no kExtNone form: with no BC it runs the same


class CollideStream2DStep(_Fused2D):
    """One fused D2Q9 step: ``(f, mask_i32, omega) -> f_new``; with a
    field mode (``FIELDS``) the advection-diffusion step or the forced NSE
    step, the field in the aux field's first two channels."""

    launches = 0
    plain_calls = 0
    field_launches = dict.fromkeys(FIELDS, 0)
    fields = FIELDS

    def plain(self, f, mask_i32, omega, aux=None):
        CollideStream2DStep.plain_calls += 1
        return self._plain_step(f, mask_i32, omega, aux)

    def _launch(self, lib, f, mask_i32, out, omega, stream, aux=None):
        X, Y = self.shape
        if self.field is not None:
            return lib.xlb_collide_stream_2d_field_step(
                FIELD_CODE[self.field], _cuda.STORE_KIND[self.store_dtype], self.ext, f.data_ptr(),
                mask_i32.data_ptr(), out.data_ptr(), X, Y, omega, aux.data_ptr(), ctypes.byref(self.params), stream,
            )
        return lib.xlb_collide_stream_2d_step(
            _cuda.STORE_KIND[self.store_dtype], int(self.shifted), self.ext, f.data_ptr(), mask_i32.data_ptr(),
            out.data_ptr(), X, Y, omega, _cuda.data_ptr(aux), ctypes.byref(self.params), stream,
        )


class CollideStream2DKStep(_Fused2D):
    """``steps`` fused D2Q9 steps from one pass over device memory:
    ``(f, mask_i32, omega) -> f after k steps``."""

    launches = 0
    plain_calls = 0

    def __init__(self, velocity_set, shape, collision="BGK", bc_specs=(), compute_dtype=torch.float32,
                 store_dtype=torch.float32, shifted=False, has_solids=True, steps=MAX_STEPS, force_vector=None):
        super().__init__(velocity_set, shape, collision, bc_specs, compute_dtype, store_dtype, shifted, has_solids,
                         force_vector)
        if not 2 <= steps <= MAX_STEPS:
            raise ValueError(f"2D temporal blocking takes 2 <= steps <= {MAX_STEPS}, got {steps}")
        self.steps = int(steps)

    def plain(self, f, mask_i32, omega, aux=None):
        """k single plain steps, each rounded to the store dtype."""
        CollideStream2DKStep.plain_calls += 1
        for _ in range(self.steps):
            f = self._plain_step(f, mask_i32, omega, aux)
        return f

    def _launch(self, lib, f, mask_i32, out, omega, stream, aux=None):
        X, Y = self.shape
        TX, TY = TILE
        return lib.xlb_collide_stream_2d_kstep(
            _cuda.STORE_KIND[self.store_dtype], int(self.shifted), self.ext, self.steps, f.data_ptr(),
            mask_i32.data_ptr(), out.data_ptr(), X, Y, TX, TY, omega, _cuda.data_ptr(aux), ctypes.byref(self.params),
            stream,
        )
