"""Fused adjoint (backward) of the single collide-stream step: wrapper of
the CUDA adjoint kernel and its plain version.

``CollideStreamAdjoint`` is the counterpart of
``xlb_tpu.kernels.adjoint_step.build_fused_adjoint_3d``'s ``backward``:
``(f_primal, g, mask_i32, omega) -> (df, dom_field)``. ``f_primal`` is the
step's input in store form (deviation form when shifted), ``g`` the
cotangent of the step's output, in the compute dtype (float32) on both
sides, so reverse sweeps through 16-bit-storage windows never quantize
gradients. ``df`` is (q, X, Y, Z) and ``dom_field`` (X, Y, Z), both
float32; the scalar cotangent of omega is ``dom_field``'s sum, taken
outside the kernel.

Its CUDA kernel (``csrc/adjoint_step.cuh::adjoint_kernel``) replaces that
TPU kernel for every configuration of the single-step kernel K1: D3Q19 and
D3Q27, every collision, the body force, equilibrium, fullway and halfway
BCs. The TPU kernel takes the per-voxel Jacobian-transpose from
``jax.vjp`` of ``pointwise_core``; the CUDA kernel derives unforced BGK's
by hand and takes every other one in forward mode, differentiating the
forward's own device code on dual numbers (the source says how). The
plain version is ``torch.func.vjp`` of the plain step with omega promoted
to a per-voxel field, as the TPU kernel's own ``jax.vjp`` is.
"""

import ctypes

import numpy as np
import torch

from xlb_tpu_torch.kernels import _cuda
from xlb_tpu_torch.kernels.collide_stream_dma import FusedKernel, plain_collide

# BC kinds whose epilogue is not voxel-local and so has no fused adjoint.
# Every kind the port's fused 3D forward takes (equilibrium, fullway,
# halfway) is eligible, as in xlb_tpu.
ADJOINT_UNSUPPORTED_KINDS = ()


def adjoint_supported(bc_specs):
    """True when every BC epilogue is fused-adjoint eligible."""
    return all(s["kind"] not in ADJOINT_UNSUPPORTED_KINDS for s in bc_specs)


def collide_stream_adjoint_plain(vs, bc_specs, f_primal, g, mask_i32, omega, shifted=False, has_solids=True,
                                 collision="BGK", force_vector=None):
    """Plain torch version of the fused adjoint: the vector-Jacobian
    product of the plain step (before its constant store shift) at
    ``f_primal`` with the cotangent ``g``, omega promoted to a per-voxel
    float32 field. Returns ``(df, dom_field)`` in float32."""
    fc = f_primal.detach().to(torch.float32)
    om = torch.full(mask_i32.shape, float(np.float32(omega)), dtype=torch.float32, device=fc.device)
    _, vjp = torch.func.vjp(
        lambda f, o: plain_collide(vs, bc_specs, f, mask_i32, o, shifted, has_solids, collision, force_vector), fc, om)
    return vjp(g.detach().to(torch.float32))


class CollideStreamAdjoint(FusedKernel):
    """The backward of one fused step: ``(f_primal, g, mask_i32, omega) ->
    (df, dom_field)``."""

    launches = 0
    plain_calls = 0
    zoo = True
    kernel_kind = 4  # XLB_KERNEL_ADJOINT

    def __init__(self, velocity_set, shape, collision="BGK", bc_specs=(), compute_dtype=torch.float32,
                 store_dtype=torch.float32, shifted=False, has_solids=True, force_vector=None):
        if not adjoint_supported(bc_specs):
            raise NotImplementedError(f"no fused adjoint for BC kinds {ADJOINT_UNSUPPORTED_KINDS}")
        super().__init__(velocity_set, shape, collision, bc_specs, compute_dtype, store_dtype, shifted, has_solids,
                         force_vector)

    def plain(self, f_primal, g, mask_i32, omega):
        CollideStreamAdjoint.plain_calls += 1
        return collide_stream_adjoint_plain(self.vs, self.bc_specs, f_primal, g, mask_i32, omega, self.shifted,
                                            self.has_solids, self.collision, self.force_vector)

    def __call__(self, f_primal, g, mask_i32, omega):
        self._check(f_primal, mask_i32)
        if g.shape != f_primal.shape or g.dtype != torch.float32:
            raise ValueError(f"g must be float32 of shape {tuple(f_primal.shape)}, got {g.dtype} {tuple(g.shape)}")
        if g.device != f_primal.device or not g.is_contiguous() or g.requires_grad:
            raise ValueError("g must be a contiguous tensor on the primal's device that does not require grad")

        def launch(lib, stream):
            df = torch.empty_like(g)
            dom = torch.empty(self.shape, dtype=torch.float32, device=g.device)
            X, Y, Z = self.shape
            err = lib.xlb_collide_stream_adjoint(
                _cuda.STORE_KIND[self.store_dtype], int(self.shifted), f_primal.data_ptr(), g.data_ptr(),
                mask_i32.data_ptr(), df.data_ptr(), dom.data_ptr(), X, Y, Z, float(omega),
                ctypes.byref(self.params), stream,
            )
            return (df, dom), err

        return self._dispatch(f_primal, lambda: self.plain(f_primal, g, mask_i32, omega), launch)
