"""Fused adjoint (backward) of the single collide-stream step: wrapper of
the CUDA adjoint kernel and its plain version.

``CollideStreamAdjoint`` is the counterpart of
``xlb_tpu.kernels.adjoint_step.build_fused_adjoint_3d``'s ``backward``:
``(f_primal, g, mask_i32, omega[, aux]) -> (df, dom_field)``. ``f_primal`` is the
step's input in store form (deviation form when shifted), ``g`` the
cotangent of the step's output, in the compute dtype (float32) on both
sides, so reverse sweeps through 16-bit-storage windows never quantize
gradients. ``df`` is (q, X, Y, Z) and ``dom_field`` (X, Y, Z), both
float32; the scalar cotangent of omega is ``dom_field``'s sum, taken
outside the kernel.

Its CUDA kernel (``csrc/adjoint_step.cuh``) replaces that TPU kernel for
every configuration of the single-step kernel K1: D3Q19 and D3Q27, every
collision, the body force, equilibrium, fullway and halfway BCs, and on
``OPEN_PAIRS`` (D3Q19 BGK, D3Q27 KBC) the open-boundary epilogues (3D
Zou-He and regularized, do-nothing, free-slip, the extrapolation outflow
with its staging, per-voxel prescriptions) and the hybrid curved wall.
The TPU kernel takes the per-voxel Jacobian-transpose from ``jax.vjp`` of
``pointwise_core``; the CUDA kernel derives unforced BGK's collision by
hand and takes every other collision, and every epilogue, in forward
mode, differentiating the forward's own device code on dual numbers (the
source says how). In the open and hybrid forms it runs split by voxel
class (``split``, counted by ``split_launches``): the bulk of the voxels
through ``adjoint_kernel`` compiled as the walled form's, the voxels of an
epilogue BC (``boundary_voxels``) through a launch of their own. The aux field of the per-voxel prescriptions enters as
a constant: prescriptions carry no gradient, as in the TPU kernel. The
plain version is ``torch.func.vjp`` of the plain step with omega promoted
to a per-voxel field, as the TPU kernel's own ``jax.vjp`` is.
"""

import ctypes

import numpy as np
import torch

from xlb_tpu_torch.kernels import _cuda
from xlb_tpu_torch.kernels.collide_stream import bc_id_mask, bc_id_shift, kernel_bc_id
from xlb_tpu_torch.kernels.collide_stream_dma import OPEN_KINDS_3D, FusedKernel, plain_collide

# K8's kernels in launch order, as xlb_collide_stream_adjoint_shape reports them
ADJOINT_LAUNCHES = ("adjoint", "boundary", "centred", "staging")
# the BC kinds whose streaming-step epilogue K8's boundary launch transposes
EPILOGUE_KINDS = frozenset(k for k, code in _cuda.BC_KIND.items() if code >= _cuda.BC_KIND["halfway"])

# BC kinds the adjoint kernel does not take: none, as in xlb_tpu (the hook
# stays for epilogues that are not voxel-local)
ADJOINT_UNSUPPORTED_KINDS = ()


def adjoint_supported(bc_specs):
    """True when the adjoint kernel takes every BC epilogue of the scene."""
    return all(s["kind"] not in ADJOINT_UNSUPPORTED_KINDS for s in bc_specs)


def staging_keys(bc_specs, velocity_set):
    """Static (m, x0, y0, tz) tuples of the tangential staging reads the
    forward's extrapolation-outflow epilogue performs: direction m read at
    x - t, t = (1 - x0, 1 - y0, tz), as ``xlb_tpu``'s ``staging_keys``
    lists them (the reference's API, kept for comparing the two). The
    kernels take the same offsets from the BC's normal on the device
    (``staging_offset`` in ``csrc/adjoint_step.cuh``), where the adjoint
    gathers one cotangent per read back to the read population
    (``adjoint_staging_kernel``)."""
    c = velocity_set._c
    opp = velocity_set._opp_indices
    d, q = velocity_set.d, velocity_set.q
    keys = []
    for spec in bc_specs:
        if spec["kind"] != "extrapolation_outflow":
            continue
        n = spec["normal"]
        for l in range(q):
            m = int(opp[l])
            if d == 3:
                t = (int(n[0] + c[0, m]), int(n[1] + c[1, m]), int(n[2] + c[2, m]))
            else:
                t = (int(n[0] + c[0, m]), 0, int(n[1] + c[1, m]))
            if any(abs(tc) > 1 for tc in t):
                continue
            key = (m, 1 - t[0], 1 - t[1], t[2])
            if key not in keys:
                keys.append(key)
    return keys


def collide_stream_adjoint_plain(vs, bc_specs, f_primal, g, mask_i32, omega, shifted=False, has_solids=True,
                                 collision="BGK", force_vector=None, aux=None):
    """Plain torch version of the fused adjoint: the vector-Jacobian
    product of the plain step (before its constant store shift) at
    ``f_primal`` with the cotangent ``g``, omega promoted to a per-voxel
    float32 field, the aux field (or None) a constant. Returns ``(df,
    dom_field)`` in float32."""
    fc = f_primal.detach().to(torch.float32)
    om = torch.full(mask_i32.shape, float(np.float32(omega)), dtype=torch.float32, device=fc.device)
    _, vjp = torch.func.vjp(
        lambda f, o: plain_collide(vs, bc_specs, f, mask_i32, o, shifted, has_solids, collision, force_vector, aux),
        fc, om)
    return vjp(g.detach().to(torch.float32))


class CollideStreamAdjoint(FusedKernel):
    """The backward of one fused step: ``(f_primal, g, mask_i32, omega[,
    aux]) -> (df, dom_field)``; ``aux`` is the forward's aux field when the
    scene's BCs read one."""

    launches = 0
    split_launches = 0  # the CUDA calls in a split form (``split``)
    plain_calls = 0
    zoo = True
    bc_kinds = OPEN_KINDS_3D
    kernel_kind = 4  # XLB_KERNEL_ADJOINT

    @property
    def split(self):
        """Whether K8 runs split by voxel class (the kExtOpen and kExtHybrid
        forms): a bulk ``adjoint_kernel`` with no epilogue transpose, and a
        boundary launch at the voxels of an epilogue BC."""
        return self.params.walled >= 2

    def plain(self, f_primal, g, mask_i32, omega, aux=None):
        CollideStreamAdjoint.plain_calls += 1
        return collide_stream_adjoint_plain(self.vs, self.bc_specs, f_primal, g, mask_i32, omega, self.shifted,
                                            self.has_solids, self.collision, self.force_vector, aux)

    def __call__(self, f_primal, g, mask_i32, omega, aux=None):
        self._check(f_primal, mask_i32)
        self._check_aux(f_primal, aux)
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
                mask_i32.data_ptr(), df.data_ptr(), dom.data_ptr(), X, Y, Z, float(omega), _cuda.data_ptr(aux),
                ctypes.byref(self.params), stream,
            )
            return (df, dom), err

        out = self._dispatch(f_primal, lambda: self.plain(f_primal, g, mask_i32, omega, aux), launch)
        if f_primal.device.type != "cpu" and self.split:
            CollideStreamAdjoint.split_launches += 1
        return out

    def launch_shape(self, lib):
        """{launch: (resident blocks per SM, registers, local bytes per
        thread)} of this configuration's K8 kernels on the current device,
        for each of ``ADJOINT_LAUNCHES`` that the form has."""
        shape = (ctypes.c_int * (3 * len(ADJOINT_LAUNCHES)))()
        _cuda.check(lib, lib.xlb_collide_stream_adjoint_shape(
            _cuda.STORE_KIND[self.store_dtype], int(self.shifted), ctypes.byref(self.params), shape),
            f"{type(self).__name__} launch shape")
        return {name: tuple(shape[3 * i:3 * i + 3]) for i, name in enumerate(ADJOINT_LAUNCHES) if shape[3 * i + 1]}

    def boundary_voxels(self, mask_i32):
        """Where the packed mask ``mask_i32`` has a BC of
        ``EPILOGUE_KINDS`` (bool, (X, Y, Z)): in the split forms the voxels
        of the boundary launch (each BC has an id of its own, never the
        solid's)."""
        q = self.vs.q
        ids = [kernel_bc_id(int(s["id"]), q) for s in self.bc_specs if s["kind"] in EPILOGUE_KINDS]
        cell = (mask_i32 >> bc_id_shift(q)) & bc_id_mask(q)
        return torch.isin(cell, torch.tensor(ids, dtype=cell.dtype, device=cell.device))

    def boundary_share(self, mask_i32):
        """The share of the voxels that ``boundary_voxels`` holds: a
        reduction over the mask, off the hot path."""
        return float(self.boundary_voxels(mask_i32).sum()) / mask_i32.numel()
