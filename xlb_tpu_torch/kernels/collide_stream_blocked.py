"""Block-tiled single fused step (``kernel="blocked"``): wrapper of the
CUDA kernel and its plain version.

``build_fused_collide_stream_3d`` is the counterpart of
``xlb_tpu.kernels.collide_stream.build_fused_collide_stream_3d``, the
TPU's block-mapped 3D step, which assembles a (q, TX+2, TY+2, Z) halo
tile in VMEM from nine BlockSpecs and runs the per-voxel body on it. Its
CUDA kernel (``csrc/collide_stream_blocked.cuh::blocked_kernel``) gives
each block a (TX, TY, TZ) box, one voxel per thread, and stages the box's
pull sources in shared memory with ``cp.async`` -- for each direction l
the box shifted by -c_l, all q directions in flight before the first is
read -- then runs the same ``collide_voxel`` as the single-step kernel
(K1): it computes K1's function for the same configurations. The nine
specs, the full-height y blocks and the divisibility of X and Y by the
tile are Mosaic constraints and are not carried over: the kernel takes
any (X, Y, Z), with ragged edge boxes and periodic wrap by index
arithmetic.
"""

import ctypes

import torch

from xlb_tpu_torch.kernels import _cuda
from xlb_tpu_torch.kernels.collide_stream_dma import OPEN_KINDS_3D, FusedKernel

# (TX, TY, TZ): 256 threads, 32 along z so that each warp's pulls of a
# direction cover one contiguous z run
DEFAULT_TILE = (1, 8, 32)
MAX_THREADS = 256  # the kernel's __launch_bounds__


class CollideStreamBlocked(FusedKernel):
    """One fused LBM step through the block-tiled kernel:
    ``(f, mask_i32, omega) -> f_new``."""

    launches = 0
    plain_calls = 0
    zoo = True
    bc_kinds = OPEN_KINDS_3D
    kernel_kind = 3  # XLB_KERNEL_BLOCKED

    def __init__(self, velocity_set, shape, collision="BGK", bc_specs=(), compute_dtype=torch.float32,
                 store_dtype=torch.float32, shifted=False, has_solids=True, force_vector=None, tile=None):
        super().__init__(velocity_set, shape, collision, bc_specs, compute_dtype, store_dtype, shifted, has_solids,
                         force_vector)
        self.tile = tuple(int(t) for t in (tile or DEFAULT_TILE))
        if len(self.tile) != 3 or min(self.tile) < 1 or self.tile[0] * self.tile[1] * self.tile[2] > MAX_THREADS:
            raise ValueError(f"tile must be (TX, TY, TZ) with at most {MAX_THREADS} voxels, got {tile}")

    def plain(self, f, mask_i32, omega, aux=None):
        CollideStreamBlocked.plain_calls += 1
        return self._plain_step(f, mask_i32, omega, aux)

    def _launch(self, lib, f, mask_i32, out, omega, stream, aux=None):
        if f.data_ptr() % 4:
            raise ValueError("the blocked kernel copies whole 32-bit words: f must start on a 4-byte boundary")
        X, Y, Z = self.shape
        TX, TY, TZ = self.tile
        return lib.xlb_collide_stream_blocked(
            _cuda.STORE_KIND[self.store_dtype], int(self.shifted), f.data_ptr(), mask_i32.data_ptr(), out.data_ptr(),
            X, Y, Z, TX, TY, TZ, omega, _cuda.data_ptr(aux), ctypes.byref(self.params), stream,
        )


def build_fused_collide_stream_3d(velocity_set, shape, collision="BGK", bc_specs=(), compute_dtype=torch.float32,
                                  store_dtype=torch.float32, tile=None, shifted=False, has_solids=True,
                                  force_vector=None):
    """Build the block-tiled fused 3D step: ``(f, mask_i32, omega) -> f_new``
    (a ``CollideStreamBlocked``; ``tile`` is its (TX, TY, TZ) box)."""
    return CollideStreamBlocked(velocity_set, shape, collision, bc_specs, compute_dtype, store_dtype, shifted,
                                has_solids, force_vector, tile)
