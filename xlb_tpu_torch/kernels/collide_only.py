"""The multires per-level collide (K5): wrapper of the CUDA kernel and its
plain version.

``LevelCollide`` is the counterpart of
``xlb_tpu.kernels.collide_only.build_level_collide`` around
``build_fused_collide``. Its kernel (``csrc/collide_only.cu::
collide_kernel``) computes, per voxel of a (q, *shape) float32 level:
moments, the quadratic equilibrium, BGK, the collision-step fullway
epilogue and the solid keep-out. There is no streaming, so the kernel is
one thread per voxel over the flattened level, and the TPU's padding of N
to a (8, 512) tile multiple with rest-state cells does not carry over:
Hopper masks the ragged last block instead.
"""

import ctypes

import numpy as np
import torch

from xlb_tpu_torch.kernels import _cuda
from xlb_tpu_torch.kernels.collide_stream import _equilibrium, _moments, f32_weights, kernel_bc_id, kernel_solid_id, unpack_bc_id
from xlb_tpu_torch.kernels.collide_stream_dma import FusedKernel


def collide_specs(bc_specs):
    """The BC specs the collide-only kernel applies (the collision-step
    ones); raises for kinds that need neighbour reads at collision time."""
    out = []
    for spec in bc_specs:
        if spec["kind"] == "extrapolation_outflow":
            raise NotImplementedError("aux-staging BCs need neighbor reads; use the TORCH tier for this level")
        if spec["step"] == "collision":
            out.append(spec)
    return out


def collide_only_plain(vs, specs, f, mask_i32, omega, has_solids=True):
    """The plain per-level collide: ``f`` float32 (q, *shape) -> float32,
    term by term as the kernel."""
    q, d, c, opp = vs.q, vs.d, vs._c, vs._opp_indices
    w = f32_weights(vs)
    omega = float(np.float32(omega))  # as the kernel reads it
    bc = unpack_bc_id(mask_i32, q)
    f_s = [f[l] for l in range(q)]
    rho, u = _moments(f_s, c, q, d)
    feq = _equilibrium(rho, u, c, w, opp, q, d)
    f_out = [f_s[l] - omega * (f_s[l] - feq[l]) for l in range(q)]
    for spec in specs:
        if spec["kind"] != "fullway":
            raise NotImplementedError(f"BC kind {spec['kind']!r} in the collide-only kernel")
        on = bc == kernel_bc_id(spec["id"], q)
        f_out = [torch.where(on, f_s[opp[l]], f_out[l]) for l in range(q)]
    if has_solids:
        solid = bc == kernel_solid_id(q)
        f_out = [torch.where(solid, f_s[l], f_out[l]) for l in range(q)]
    return torch.stack(f_out)


class LevelCollide(FusedKernel):
    """The collide phase of one multires sub-step on a whole level:
    ``(f float32 (q, *shape), mask_i32, omega) -> f_post_collision``.
    Collision-step BCs of ``bc_specs`` apply (the streaming-step ones are
    the stepper's); solid voxels keep their populations."""

    launches = 0
    plain_calls = 0
    bc_kinds = {"fullway"}

    def __init__(self, velocity_set, shape, collision="BGK", bc_specs=(), compute_dtype=torch.float32, has_solids=True):
        super().__init__(velocity_set, shape, collision, collide_specs(list(bc_specs)), compute_dtype,
                         store_dtype=compute_dtype, has_solids=has_solids)

    def plain(self, f, mask_i32, omega):
        LevelCollide.plain_calls += 1
        return collide_only_plain(self.vs, self.bc_specs, f, mask_i32, omega, self.has_solids)

    def _launch(self, lib, f, mask_i32, out, omega, stream):
        n = int(mask_i32.numel())
        return lib.xlb_collide_only(f.data_ptr(), mask_i32.data_ptr(), out.data_ptr(), n, omega,
                                    ctypes.byref(self.params), stream)
