"""Carry simulation state, cotangents and gradients between ``xlb_tpu`` and
this port as NumPy arrays.

NumPy has no bfloat16 of its own: a bfloat16 field crosses as float32,
which holds every bfloat16 value exactly, and is cast back on arrival.
"""

import numpy as np
import torch


def _to_tensor(a, device, dtype=None):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # e.g. an xlb_tpu bf16 field
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy: jax hands out read-only views
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def fields_from_numpy(f_0, f_1, bc_mask, missing_mask, device="cuda", dtype=None):
    """Turn ``xlb_tpu``-layout fields (NumPy arrays) into the port's tensors
    on ``device`` (the card unless the caller asks for another device). Dtypes are kept (NumPy bfloat16 arrives as bfloat16);
    ``dtype``, when given, is the populations' dtype -- e.g. bfloat16 for
    populations that crossed as float32."""
    return (
        _to_tensor(f_0, device, dtype),
        _to_tensor(f_1, device, dtype),
        _to_tensor(bc_mask, device, torch.uint8),
        _to_tensor(missing_mask, device, torch.bool),
    )


def aux_from_numpy(aux, device="cuda"):
    """The aux field of per-voxel BC prescriptions (``xlb_tpu``'s or the
    port's ``build_aux_field``: a float32 (nchan, *shape) NumPy array, or
    None) as the contiguous float32 tensor the fused kernels read, on
    ``device``; None stays None."""
    return None if aux is None else _to_tensor(aux, device, torch.float32).contiguous()


def _as_numpy(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def fields_to_numpy(f_0, f_1, bc_mask, missing_mask):
    """The reverse of :func:`fields_from_numpy`: host NumPy arrays, with
    bfloat16 populations as (exact) float32."""
    return tuple(_as_numpy(t) for t in (f_0, f_1, bc_mask, missing_mask))


def level_fields_from_numpy(fs, bms, mms, device="cuda", dtype=None):
    """Per-level multires state (lists finest first: populations, bc_mask,
    missing_mask, as ``xlb_tpu``'s multires stepper holds them) from NumPy
    arrays into lists of the port's tensors on ``device``."""
    return (
        [_to_tensor(f, device, dtype) for f in fs],
        [_to_tensor(b, device, torch.uint8) for b in bms],
        [_to_tensor(m, device, torch.bool) for m in mms],
    )


def level_fields_to_numpy(fs, bms=(), mms=()):
    """The reverse of :func:`level_fields_from_numpy`: lists of host NumPy
    arrays (bfloat16 populations as exact float32)."""
    return [_as_numpy(f) for f in fs], [_as_numpy(b) for b in bms], [_as_numpy(m) for m in mms]


def cotangent_from_numpy(g, device="cuda"):
    """A cotangent of the populations (e.g. the ``g`` handed to
    ``xlb_tpu``'s adjoint) as a float32 tensor on ``device``: cotangents
    travel in the compute dtype."""
    return _to_tensor(g, device, torch.float32)


def gradients_to_numpy(df, dom_field):
    """The adjoint's ``(df, dom_field)`` pair as host NumPy arrays
    (bfloat16 as exact float32), to hold against ``xlb_tpu``'s."""
    return _as_numpy(df), _as_numpy(dom_field)
