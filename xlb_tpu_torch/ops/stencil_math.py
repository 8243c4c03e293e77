"""Exact small-stencil contractions.

LBM moment contractions have tiny static coefficient matrices whose
entries are mostly -1/0/+1. Unrolling them into adds and subtracts keeps
the arithmetic (and its order) identical to ``xlb_tpu.ops.stencil_math``,
at full compute precision.
"""

import numpy as np
import torch


def stencil_contract(coeffs, f):
    """Contract ``coeffs (k, q)`` (static NumPy) with ``f (q, *spatial)``.

    Returns ``(k, *spatial)`` = sum_l coeffs[k, l] * f[l], with +-1 entries
    turned into adds/subtracts and zeros skipped.
    """
    coeffs = np.asarray(coeffs)
    k, q = coeffs.shape
    if f.shape[0] != q:
        raise ValueError(f"stencil mismatch: coeffs q={q}, field q={f.shape[0]}")
    outs = []
    for row in coeffs:
        acc = None
        for l in range(q):
            cl = row[l]
            if cl == 0:
                continue
            if cl == 1:
                term = f[l]
            elif cl == -1:
                term = -f[l]
            else:
                term = f[l] * float(cl)
            acc = term if acc is None else acc + term
        outs.append(acc if acc is not None else torch.zeros_like(f[0]))
    return torch.stack(outs)
