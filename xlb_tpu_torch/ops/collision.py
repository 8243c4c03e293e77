"""Collision operators: BGK, KBC, Smagorinsky-LES BGK, power-law BGK, TRT,
MRT and the forced wrapper -- ``xlb_tpu.ops.collision`` in plain torch.

Each ``*_collide`` function is the operator form of ``xlb_tpu``'s (same
formulas, same contraction order through ``stencil_contract``); the fused
kernels compute the kernel-body form of the same collisions
(``kernels/collide_stream.py::collide``), which agrees with these to
float32 roundoff. ``omega`` may be a float, a 0-d tensor or a per-voxel
field.
"""

import itertools

import numpy as np
import torch

from xlb_tpu_torch.operator import Operator
from xlb_tpu_torch.ops.force import ExactDifference
from xlb_tpu_torch.ops.macroscopic import Macroscopic, momentum_flux
from xlb_tpu_torch.ops.stencil_math import stencil_contract


def bgk_collide(f, feq, omega):
    """Single-relaxation-time BGK: f - omega (f - feq)."""
    return f - omega * (f - feq)


def kbc_shear(q, pi):
    """The KBC shear part of fneq as a list over the directions, None where
    it vanishes by construction, from pi = the packed second moment of fneq
    (xx, xy, yy) on D2Q9 or (xx, xy, xz, yy, yz, zz) on D3Q27."""
    ds = [None] * q
    if q == 27:
        nxz = pi[0] - pi[5]
        nyz = pi[3] - pi[5]
        ds[9] = ds[18] = (2.0 * nxz - nyz) / 6.0  # axis-aligned directions
        ds[3] = ds[6] = (-nxz + 2.0 * nyz) / 6.0
        ds[1] = ds[2] = (-nxz - nyz) / 6.0
        ds[12] = ds[24] = pi[1] / 4.0  # (i, j, 0) diagonals
        ds[21] = ds[15] = -pi[1] / 4.0
        ds[10] = ds[20] = pi[2] / 4.0  # (i, 0, k) diagonals
        ds[19] = ds[11] = -pi[2] / 4.0
        ds[8] = ds[4] = pi[4] / 4.0  # (0, j, k) diagonals
        ds[7] = ds[5] = -pi[4] / 4.0
    elif q == 9:
        n = pi[0] - pi[2]
        ds[3] = ds[6] = n / 4.0
        ds[2] = ds[1] = -n / 4.0
        ds[8] = ds[7] = pi[1] / 4.0
        ds[4] = ds[5] = -pi[1] / 4.0
    else:
        raise NotImplementedError(f"KBC supports D2Q9 and D3Q27 only, got q={q}")
    return ds


def kbc_collide(f, feq, omega, cc, d, epsilon=1e-32):
    """Entropic KBC collision (Karlin-Boesch-Chikatamarla)."""
    fneq = f - feq
    pi = momentum_flux(fneq, cc)
    delta_s = torch.stack([torch.zeros_like(fneq[0]) if s is None else s for s in kbc_shear(f.shape[0], pi)])
    beta = 0.5 * omega
    inv_beta = 1.0 / beta
    delta_h = fneq - delta_s
    # entropic scalar products <ds, dh>_feq and <dh, dh>_feq
    temp = delta_h / feq
    sp1 = torch.sum(temp * delta_s, dim=0)
    sp2 = torch.sum(temp * delta_h, dim=0)
    gamma = inv_beta - (2.0 - inv_beta) * sp1 / (epsilon + sp2)
    return f - beta * (2.0 * delta_s + gamma[None] * delta_h)


def _strain_squared(pi, d):
    """Pi : Pi of the packed symmetric tensor (off-diagonals counted twice)."""
    diag, offdiag = ((0, 3, 5), (1, 2, 4)) if d == 3 else ((0, 2), (1,))
    return torch.sum(pi[list(diag)] ** 2, dim=0) + 2.0 * torch.sum(pi[list(offdiag)] ** 2, dim=0)


def smagorinsky_collide(f, feq, omega, cc, d, smagorinsky_coef=0.17):
    """BGK with the Smagorinsky eddy-viscosity correction:
    tau_eff = (tau0 + sqrt(tau0^2 + 36 Cs^2 sqrt(S))) / 2."""
    fneq = f - feq
    strain = _strain_squared(momentum_flux(fneq, cc), d)
    tau0 = 1.0 / omega
    cs = smagorinsky_coef
    tau = 0.5 * (tau0 + torch.sqrt(tau0 * tau0 + 36.0 * cs * cs * torch.sqrt(strain)))
    return f - (1.0 / tau)[None] * fneq


def power_law_collide(f, feq, omega, cc, d, consistency, power_index, iterations=5):
    """BGK with a power-law (Ostwald-de Waele) viscosity nu = K gamma^(n-1):
    ``iterations`` Picard steps on tau = 3K (A / tau + eps)^(n-1) + 1/2 with
    A = 3 sqrt(2 Pi:Pi) / (2 rho), seeded at 1 / omega; the local rate is
    clipped to [0.05, 1.99]."""
    dt = f.dtype
    fneq = f - feq
    rho = torch.sum(f, dim=0)
    a = 1.5 * torch.sqrt(2.0 * _strain_squared(momentum_flux(fneq, cc), d)) / rho
    k3 = torch.tensor(3.0 * float(np.float32(consistency)), dtype=dt)
    nm1 = torch.tensor(float(np.float32(power_index - 1.0)), dtype=dt)
    eps = float(np.float32(1e-12))
    tau = torch.broadcast_to(1.0 / torch.as_tensor(omega, dtype=dt, device=f.device), a.shape)
    for _ in range(iterations):
        tau = k3 * (a / tau + eps) ** nm1 + 0.5
    om = torch.clamp(1.0 / tau, 0.05, 1.99)
    return f - om[None] * fneq


def trt_omega_minus(omega, magic):
    """Odd-part rate from the even rate and the magic parameter
    Lambda = (tau+ - 1/2)(tau- - 1/2)."""
    tau_p_half = 1.0 / omega - 0.5
    return 1.0 / (magic / tau_p_half + 0.5)


def trt_collide(f, feq, omega, opposite_indices, magic=0.25):
    """Two-relaxation-time collision: the parts of f - feq even and odd
    under direction reversal relax at ``omega`` and at
    ``trt_omega_minus(omega, magic)``."""
    om_m = trt_omega_minus(omega, float(np.float32(magic)))
    opp = torch.as_tensor(np.asarray(opposite_indices), dtype=torch.long, device=f.device)
    f_opp, feq_opp = f[opp], feq[opp]
    f_even, f_odd = 0.5 * (f + f_opp), 0.5 * (f - f_opp)
    e_even, e_odd = 0.5 * (feq + feq_opp), 0.5 * (feq - feq_opp)
    return f - omega * (f_even - e_even) - om_m * (f_odd - e_odd)


def _mrt_moment_groups(velocity_set):
    """Orthogonal moment basis of a stencil, grouped by physical content:
    lattice monomials in physics order (conserved 1 and c_a, bulk |c|^2,
    traceless second order, then every c_x^i c_y^j c_z^k with i, j, k <= 2
    by degree) through Gram-Schmidt, dropping dependent candidates.
    Returns a list of (group_name, orthogonal_row_vector) of length q."""
    c = velocity_set._c.astype(np.float64)
    d, q = c.shape
    cand = [("conserved", np.ones(q))]
    for a in range(d):
        cand.append(("conserved", c[a].copy()))
    cand.append(("bulk", (c**2).sum(axis=0)))
    for a in range(d - 1):
        cand.append(("shear", c[a] ** 2 - c[a + 1] ** 2))
    for a in range(d):
        for b in range(a + 1, d):
            cand.append(("shear", c[a] * c[b]))
    for _, es in sorted((sum(es), es) for es in itertools.product(range(3), repeat=d) if sum(es) >= 2):
        v = np.ones(q)
        for a, e in enumerate(es):
            v = v * c[a] ** e
        cand.append(("ghost", v))

    kept = []
    for g, v in cand:
        w = v.copy()
        for _, u in kept:
            w = w - (w @ u) / (u @ u) * u
        if np.sqrt(w @ w) > 1e-8 * max(1.0, np.sqrt(v @ v)):
            kept.append((g, w))
        if len(kept) == q:
            break
    if len(kept) != q:
        raise ValueError(f"MRT basis incomplete: {len(kept)} of {q} rows")
    return kept


def mrt_projectors(velocity_set):
    """Symmetric projectors onto the conserved / shear / bulk / ghost moment
    subspaces; they sum to the identity."""
    q = velocity_set.q
    P = {g: np.zeros((q, q)) for g in ("conserved", "shear", "bulk", "ghost")}
    for g, u in _mrt_moment_groups(velocity_set):
        P[g] += np.outer(u, u) / (u @ u)
    return P


def mrt_fixed_projectors(velocity_set, bulk_rate=None, ghost_rate=1.0):
    """(rate, projector) pairs of the groups that do not relax at omega:
    f' = f - omega fneq + sum_g (omega - s_g) (P_g @ fneq)."""
    P = mrt_projectors(velocity_set)
    return [(float(rate), P[grp]) for grp, rate in (("bulk", bulk_rate), ("ghost", ghost_rate)) if rate is not None]


def mrt_collide(f, feq, omega, fixed_projectors):
    """Multiple-relaxation-time collision through the static projectors of
    ``mrt_fixed_projectors``."""
    fneq = f - feq
    out = f - omega * fneq
    for s, P in fixed_projectors:
        out = out + (omega - s) * stencil_contract(P, fneq)
    return out


class Collision(Operator):
    """Base class for collision operators: ``(f, feq, omega) -> f_post``."""


class BGK(Collision):
    def __call__(self, f, feq, omega):
        return bgk_collide(f, feq, omega)


class KBC(Collision):
    epsilon = 1e-32

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.velocity_set.q not in (9, 27):
            raise NotImplementedError(f"KBC supports D2Q9 and D3Q27 only, got {self.velocity_set}")

    def __call__(self, f, feq, omega):
        return kbc_collide(f, feq, omega, self.velocity_set._cc, self.velocity_set.d, self.epsilon)


class SmagorinskyLESBGK(Collision):
    def __init__(self, velocity_set=None, precision_policy=None, compute_backend=None, smagorinsky_coef=0.17):
        super().__init__(velocity_set, precision_policy, compute_backend)
        self.smagorinsky_coef = float(smagorinsky_coef)

    def __call__(self, f, feq, omega):
        return smagorinsky_collide(f, feq, omega, self.velocity_set._cc, self.velocity_set.d, self.smagorinsky_coef)


class PowerLawBGK(Collision):
    """Generalized-Newtonian power-law fluid, nu = K gamma^(n-1):
    ``power_index`` n < 1 is shear-thinning, n > 1 shear-thickening."""

    def __init__(self, velocity_set=None, precision_policy=None, compute_backend=None, consistency=None,
                 power_index=1.0, iterations=5):
        super().__init__(velocity_set, precision_policy, compute_backend)
        if consistency is None:
            raise ValueError("PowerLawBGK needs `consistency` (K, lattice units): nu = K gamma^(n-1)")
        self.consistency = float(consistency)
        self.power_index = float(power_index)
        self.iterations = int(iterations)

    def __call__(self, f, feq, omega):
        return power_law_collide(f, feq, omega, self.velocity_set._cc, self.velocity_set.d, self.consistency,
                                 self.power_index, self.iterations)


class TRT(Collision):
    """Two-relaxation-time collision; ``magic`` is Lambda (1/4 by default)."""

    def __init__(self, velocity_set=None, precision_policy=None, compute_backend=None, magic=0.25):
        super().__init__(velocity_set, precision_policy, compute_backend)
        self.magic = float(magic)

    def __call__(self, f, feq, omega):
        return trt_collide(f, feq, omega, self.velocity_set._opp_indices, self.magic)


class MRT(Collision):
    """Multiple-relaxation-time collision on the stencil's orthogonal moment
    basis: shear moments relax at omega, ``bulk_rate`` / ``ghost_rate`` the
    trace and the higher moments (None: at omega; with both None MRT is
    BGK)."""

    def __init__(self, velocity_set=None, precision_policy=None, compute_backend=None, bulk_rate=None,
                 ghost_rate=1.0):
        super().__init__(velocity_set, precision_policy, compute_backend)
        self.bulk_rate = bulk_rate
        self.ghost_rate = ghost_rate
        self.fixed_projectors = mrt_fixed_projectors(self.velocity_set, bulk_rate, ghost_rate)

    def __call__(self, f, feq, omega):
        return mrt_collide(f, feq, omega, self.fixed_projectors)


class ForcedCollision(Collision):
    """A collision followed by an exact-difference body force."""

    def __init__(self, collision_operator, forcing_scheme="exact_difference", force_vector=None):
        if collision_operator is None:
            raise ValueError("ForcedCollision wraps a collision operator")
        self.collision_operator = collision_operator
        super().__init__(collision_operator.velocity_set, collision_operator.precision_policy,
                         collision_operator.compute_backend)
        if forcing_scheme != "exact_difference":
            raise NotImplementedError(f"forcing scheme {forcing_scheme!r} not implemented")
        self.force_vector = force_vector
        self.forcing_operator = ExactDifference(force_vector, velocity_set=self.velocity_set,
                                                precision_policy=self.precision_policy,
                                                compute_backend=self.compute_backend)
        self.macroscopic = Macroscopic(self.velocity_set, self.precision_policy, self.compute_backend)

    def __call__(self, f, feq, omega):
        fout = self.collision_operator(f, feq, omega)
        rho, u = self.macroscopic(fout)
        return self.forcing_operator(fout, feq, rho, u)
