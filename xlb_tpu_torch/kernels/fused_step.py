"""Glue between the NSE stepper and the fused collide-stream kernels.

Translates BC objects into static kernel epilogue specs, packs
``bc_mask`` / ``missing_mask`` into one int32 voxel field, and builds the
CUDA-tier step and window. BCs supported in the fused step so far:
EquilibriumBC and FullwayBounceBackBC; any other kind raises.

None of the TPU machinery of ``xlb_tpu.kernels.fused_step`` is carried
over: no z padding to lane multiples, no tile estimators for on-chip
memory.
"""

import numpy as np
import torch

from xlb_tpu_torch.boundary.base import ImplementationStep
from xlb_tpu_torch.boundary.bc_bounce_back import FullwayBounceBackBC
from xlb_tpu_torch.boundary.bc_equilibrium import EquilibriumBC
from xlb_tpu_torch.kernels.collide_stream import bc_id_shift
from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep

TEMPORAL_STEPS = 2  # k of the window's k-step groups, as in xlb_tpu


def bc_to_spec(bc, velocity_set):
    """Convert a BC object into a static spec dict for the kernel epilogue."""
    step = "streaming" if bc.implementation_step == ImplementationStep.STREAMING else "collision"
    if isinstance(bc, EquilibriumBC):
        return {"kind": "equilibrium", "id": bc.id, "step": step, "feq": bc.prescribed_feq_np().astype(np.float32)}
    if isinstance(bc, FullwayBounceBackBC):
        return {"kind": "fullway", "id": bc.id, "step": step}
    raise NotImplementedError(
        f"{type(bc).__name__} is not yet supported by the fused CUDA kernels; use ComputeBackend.TORCH"
    )


def pack_masks(bc_mask, missing_mask):
    """(bc_mask uint8 (1,*s), missing bool (q,*s)) -> one int32 (*s).

    Bits 0..q-1 hold the missing-direction bitfield and bits 19..26 the raw
    uint8 cell type (q <= 19), as in ``xlb_tpu.kernels.fused_step.pack_masks``.
    """
    q = missing_mask.shape[0]
    packed = bc_mask[0].to(torch.int32) << bc_id_shift(q)
    for l in range(q):
        packed |= missing_mask[l].to(torch.int32) << l
    return packed


def _stepper_config(stepper):
    pp = stepper.precision_policy
    return dict(
        collision=stepper.collision_type,
        bc_specs=[bc_to_spec(bc, stepper.velocity_set) for bc in stepper.boundary_conditions],
        compute_dtype=pp.compute_dtype,
        store_dtype=pp.store_dtype,
    )


def build_fused_step(stepper):
    """Build the CUDA-tier single step of an IncompressibleNavierStokesStepper:
    ``(f_0, f_1, bc_mask, missing_mask, omega, timestep) -> (f_0, f_1)``
    with ``f_1`` the new state, in plain (unshifted) storage."""
    fused = CollideStreamStep(stepper.velocity_set, stepper.grid.shape, **_stepper_config(stepper))

    def step(f_0, f_1, bc_mask, missing_mask, omega, timestep=0):
        return f_0, fused(f_0, pack_masks(bc_mask, missing_mask), omega)

    return step


def build_fused_window(stepper, num_steps):
    """A ``num_steps``-window of the fused step.

    Under a 16-bit store dtype the populations live in device memory in
    deviation form g = f - w during the window and are converted back at
    its boundary. The boundary shifts by the weights rounded to the store
    dtype (``w_shift``), while the kernels add and subtract float32 weights
    at every load and store -- the same pair of constants as ``xlb_tpu``,
    under which a 16-bit rest state maps to g = 0 exactly.

    Groups of ``TEMPORAL_STEPS`` (k) steps run through the k-step kernel,
    the ``num_steps % k`` remainder through the single-step kernel.

    Returns ``run(f_0, f_1, bc_mask, missing_mask, omega) -> (f, f)``: the
    new state twice, in the compute dtype when shifted (quantizing g + w
    back to 16 bits would erase the deviations) and in the store dtype
    otherwise.
    """
    vs = stepper.velocity_set
    pp = stepper.precision_policy
    shifted = pp.store_dtype.itemsize < 4
    k = min(TEMPORAL_STEPS, num_steps)
    cfg = dict(_stepper_config(stepper), shifted=shifted, has_solids=getattr(stepper, "has_solids", True))
    shape = stepper.grid.shape

    single = CollideStreamStep(vs, shape, **cfg)
    kstep = CollideStreamKStep(vs, shape, steps=k, **cfg) if k >= 2 else None
    n_k = num_steps // k if kstep is not None else 0
    w_shift = torch.as_tensor(vs._w).to(pp.store_dtype).reshape((vs.q,) + (1,) * vs.d)

    def run(f_0, f_1, bc_mask, missing_mask, omega):
        mask_i32 = pack_masks(bc_mask, missing_mask)
        if shifted:
            w_c = w_shift.to(device=f_0.device, dtype=pp.compute_dtype)
            g = (f_0.to(pp.compute_dtype) - w_c).to(pp.store_dtype)
        else:
            g = f_0
        for _ in range(n_k):
            g = kstep(g, mask_i32, omega)
        for _ in range(num_steps - n_k * k):
            g = single(g, mask_i32, omega)
        f = g.to(pp.compute_dtype) + w_c if shifted else g
        return f, f

    return run
