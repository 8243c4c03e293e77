"""Lattice velocity sets (DdQq stencils) and their derived constants.

Every derived quantity is computed once in NumPy (the same code as
``xlb_tpu.velocity_set``, so the constants are bit-equal) and exposed both
as NumPy (setup code, kernel parameters) and as CPU torch tensors.
"""

import math

import numpy as np
import torch


class VelocitySet:
    """A DdQq lattice stencil.

    Parameters
    ----------
    d : int
        Spatial dimension (2 or 3).
    q : int
        Number of lattice directions.
    c : array-like, shape (d, q), int
        Direction vectors (columns).
    w : array-like, shape (q,), float
        Quadrature weights.

    Derived constants:

    - ``opp_indices``: index of the opposite direction for each direction.
    - ``cc``: second-moment basis, shape (q, d*(d+1)//2), the upper-triangular
      entries of c_a c_b per direction.
    - ``qi``: cc - cs^2 I with off-diagonal entries doubled.
    - ``main/right/left`` index sets and the rest-velocity ``center_index``.
    """

    def __init__(self, d, q, c, w, precision_policy=None, compute_backend=None):
        # precision_policy / compute_backend are accepted for API parity;
        # constants are stored dtype-neutral and cast by the operators
        self.d = int(d)
        self.q = int(q)
        self.precision_policy = precision_policy
        self.compute_backend = compute_backend

        c = np.asarray(c, dtype=np.int32)
        if c.shape != (self.d, self.q):
            raise ValueError(f"c must have shape (d, q), got {c.shape}")
        w = np.asarray(w, dtype=np.float64)
        if w.shape != (self.q,) or abs(w.sum() - 1.0) >= 1e-12:
            raise ValueError("w must have shape (q,) and sum to 1")

        # -- NumPy-side constants ------------------------------------------
        self._c = c
        self._w = w
        self._c_float = c.astype(np.float64)
        self._opp_indices = self._derive_opposites(c)
        self._cc = self._derive_second_moment_basis(c)
        self._qi = self._derive_qi(self._cc)

        self.cs = math.sqrt(3.0) / 3.0
        self.cs2 = 1.0 / 3.0
        self.inv_cs2 = 3.0

        abs_sum = np.abs(c).sum(axis=0)
        self.main_indices = np.nonzero(abs_sum == 1)[0]
        self.right_indices = np.nonzero(c[0] == 1)[0]
        self.left_indices = np.nonzero(c[0] == -1)[0]
        self.center_index = int(np.nonzero(abs_sum == 0)[0][0])

        # -- torch-side constants (CPU; operators move or cast them) --------
        self.c = torch.as_tensor(self._c, dtype=torch.int32)
        self.w = torch.as_tensor(self._w.astype(np.float32))
        self.opp_indices = torch.as_tensor(self._opp_indices, dtype=torch.int32)
        self.cc = torch.as_tensor(self._cc.astype(np.float32))
        self.c_float = torch.as_tensor(self._c_float.astype(np.float32))
        self.qi = torch.as_tensor(self._qi.astype(np.float32))

    @staticmethod
    def _derive_opposites(c):
        # direction i's opposite is the unique j with c[:, j] == -c[:, i]
        eq = (c[:, :, None] == -c[:, None, :]).all(axis=0)  # (q, q)
        opp = np.argmax(eq, axis=1)
        if not eq[np.arange(c.shape[1]), opp].all():
            raise ValueError("stencil is not symmetric")
        return opp.astype(np.int32)

    def _derive_second_moment_basis(self, c):
        pairs = [(a, b) for a in range(self.d) for b in range(a, self.d)]
        return np.stack([c[a].astype(np.float64) * c[b] for a, b in pairs], axis=1)  # (q, d*(d+1)//2)

    def _derive_qi(self, cc):
        qi = cc.copy()
        if self.d == 3:
            diagonal, offdiagonal = (0, 3, 5), (1, 2, 4)
        elif self.d == 2:
            diagonal, offdiagonal = (0, 2), (1,)
        else:
            raise ValueError(f"unsupported dimension {self.d}")
        qi[:, diagonal] -= 1.0 / 3.0
        # off-diagonal entries counted twice in the symmetric contraction
        qi[:, offdiagonal] *= 2.0
        return qi

    @property
    def diagonal_moment_indices(self):
        return (0, 3, 5) if self.d == 3 else (0, 2)

    @property
    def offdiagonal_moment_indices(self):
        return (1, 2, 4) if self.d == 3 else (1,)

    def __repr__(self):
        return f"D{self.d}Q{self.q}"

    __str__ = __repr__
