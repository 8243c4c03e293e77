"""k fused LBM steps per pass over device memory: wrapper of the CUDA
k-step kernel and its plain version.

``CollideStreamKStep`` is the counterpart of
``xlb_tpu.kernels.collide_stream_2step.build_fused_collide_stream_3d_kstep``.
Its CUDA kernel (``csrc/collide_stream_3d.cuh::kstep_kernel``) replaces
that TPU kernel in its plain mode, for the configurations of the single
step (D3Q19 and D3Q27, every collision, force, halfway walls). Each block sweeps k times over regions that
shrink around its (TX, TY, TZ) tile, keeping the intermediate sweeps in
shared memory rounded to the store dtype -- so its result equals k single
steps to store-dtype roundoff, which is exactly what the plain version
computes.
"""

import ctypes

import torch

from xlb_tpu_torch.kernels import _cuda
from xlb_tpu_torch.kernels.collide_stream_dma import OPEN_KINDS_3D, FusedKernel

# default tiles leave room for two blocks on one SM (228 KB, 1 KB reserved per block)
TILE_BUDGET = 113 * 1024
# largest first: bigger tiles recompute fewer halo voxels in the first sweep.
# On an H100 the first fitting tile was also the fastest of those timed
# (bf16 4x8x32, f32 4x4x32 at k=2; PERF.md).
TILE_CANDIDATES = ((4, 8, 32), (4, 4, 32), (4, 4, 16), (2, 4, 16), (2, 2, 16), (2, 2, 8), (1, 1, 8))


def _align16(b):
    return (b + 15) & ~15


def kstep_smem_bytes(steps, tile, itemsize, q=19):
    """Dynamic shared memory of the k-step kernel; mirrors
    ``kstep_smem_bytes`` in ``csrc/collide_stream_3d.cuh``."""
    tx, ty, tz = tile

    def vol(h):
        return (tx + 2 * h) * (ty + 2 * h) * (tz + 2 * h)

    b = _align16(q * vol(steps - 1) * itemsize)
    if steps > 2:
        b += _align16(q * vol(steps - 2) * itemsize)
    return b


def default_tile(steps, store_dtype, q=19):
    """Largest candidate tile whose sweep buffers let two blocks share an SM."""
    for tile in TILE_CANDIDATES:
        if kstep_smem_bytes(steps, tile, store_dtype.itemsize, q) <= TILE_BUDGET:
            return tile
    raise ValueError(f"no k-step tile fits shared memory at steps={steps}, store {store_dtype}")


class CollideStreamKStep(FusedKernel):
    """``steps`` fused LBM steps: ``(f, mask_i32, omega) -> f after k steps``."""

    launches = 0
    plain_calls = 0
    zoo = True
    bc_kinds = OPEN_KINDS_3D
    kernel_kind = 2  # XLB_KERNEL_KSTEP

    def __init__(self, velocity_set, shape, collision="BGK", bc_specs=(), compute_dtype=torch.float32,
                 store_dtype=torch.float32, shifted=False, has_solids=True, steps=2, force_vector=None):
        super().__init__(velocity_set, shape, collision, bc_specs, compute_dtype, store_dtype, shifted, has_solids,
                         force_vector)
        if steps < 2:
            raise ValueError(f"temporal blocking needs steps >= 2, got {steps}")
        self.steps = int(steps)
        self.tile = default_tile(self.steps, store_dtype, velocity_set.q)

    def plain(self, f, mask_i32, omega, aux=None):
        """k single plain steps, each rounded to the store dtype."""
        CollideStreamKStep.plain_calls += 1
        for _ in range(self.steps):
            f = self._plain_step(f, mask_i32, omega, aux)
        return f

    def _launch(self, lib, f, mask_i32, out, omega, stream, aux=None):
        X, Y, Z = self.shape
        TX, TY, TZ = self.tile
        return lib.xlb_collide_stream_kstep(
            _cuda.STORE_KIND[self.store_dtype], int(self.shifted), self.steps, f.data_ptr(), mask_i32.data_ptr(),
            out.data_ptr(), X, Y, Z, TX, TY, TZ, omega, _cuda.data_ptr(aux), ctypes.byref(self.params), stream,
        )
