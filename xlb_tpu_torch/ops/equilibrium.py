"""Equilibrium distribution operators.

Second-order (quadratic) Hermite equilibrium:

    feq_l = rho * w_l * (1 + cu_l * (1 + cu_l / 2) - 1.5 |u|^2),
    cu_l  = 3 (c_l . u)

and the linear equilibrium of advection-diffusion, geq_l = w_l phi (1 + cu_l).
"""

import numpy as np
import torch

from xlb_tpu_torch.operator import Operator
from xlb_tpu_torch.ops.stencil_math import stencil_contract


def quadratic_equilibrium(rho, u, c, w, compute_dtype=None):
    """feq for fields rho (1, *spatial) and u (d, *spatial).

    ``c`` is (d, q) static NumPy, ``w`` is (q,) NumPy. Returns (q, *spatial).
    """
    dtype = compute_dtype or u.dtype
    cu = 3.0 * stencil_contract(np.asarray(c).T, u)  # (q, *spatial), exact adds
    usqr = 1.5 * sum(u[a] * u[a] for a in range(u.shape[0]))[None]
    # f64 weights rounded once to the compute dtype, as xlb_tpu does in NumPy
    w = torch.as_tensor(np.asarray(w, dtype=np.float64), device=u.device).to(dtype)
    w = w.reshape((-1,) + (1,) * (u.ndim - 1))
    return rho * w * (1.0 + cu * (1.0 + 0.5 * cu) - usqr)


def quadratic_equilibrium_np(rho, u, c, w):
    """NumPy twin of :func:`quadratic_equilibrium` for host-side setup code:
    boundary values prescribed at setup stay in NumPy float64, so they are
    bit-equal to ``xlb_tpu``'s."""
    rho = np.asarray(rho, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    cu = 3.0 * np.tensordot(c, u, axes=(0, 0))
    usqr = 1.5 * np.sum(u**2, axis=0, keepdims=True)
    w = w.reshape((-1,) + (1,) * (u.ndim - 1))
    return rho * w * (1.0 + cu * (1.0 + 0.5 * cu) - usqr)


def linear_equilibrium(phi, u, c, w, compute_dtype=None):
    """First-order (linear) equilibrium of advection-diffusion for fields
    phi (1, *spatial) and u (d, *spatial): geq_l = w_l phi (1 + 3 c_l . u).
    The scalar needs only the first velocity moment to recover the
    advection term, so the quadratic terms are dropped."""
    dtype = compute_dtype or u.dtype
    cu = 3.0 * stencil_contract(np.asarray(c).T, u)  # (q, *spatial), exact adds
    w = torch.as_tensor(np.asarray(w, dtype=np.float64), device=u.device).to(dtype)
    w = w.reshape((-1,) + (1,) * (u.ndim - 1))
    return phi * w * (1.0 + cu)


class Equilibrium(Operator):
    """Base class for equilibrium operators."""


class QuadraticEquilibrium(Equilibrium):
    def __call__(self, rho, u):
        return quadratic_equilibrium(rho, u, self.velocity_set._c, self.velocity_set._w, self.compute_dtype)


class LinearEquilibrium(Equilibrium):
    """ADE equilibrium: geq_l = w_l phi (1 + 3 c_l . u)."""

    def __call__(self, phi, u):
        return linear_equilibrium(phi, u, self.velocity_set._c, self.velocity_set._w, self.compute_dtype)
