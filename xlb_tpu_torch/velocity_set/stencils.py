"""Concrete DdQq stencils: D2Q9, D3Q19, D3Q27.

Direction orderings are identical to ``xlb_tpu.velocity_set.stencils``, so
population indices line up one-to-one between the two packages.
"""

import itertools

import numpy as np

from xlb_tpu_torch.velocity_set.velocity_set import VelocitySet


class D2Q9(VelocitySet):
    """Two-dimensional nine-velocity stencil."""

    def __init__(self, precision_policy=None, compute_backend=None):
        cx = [0, 0, 0, 1, -1, 1, -1, 1, -1]
        cy = [0, 1, -1, 0, 1, -1, 0, 1, -1]
        c = np.array([cx, cy])
        w = np.array([4 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 36, 1 / 36, 1 / 9, 1 / 36, 1 / 36])
        super().__init__(2, 9, c, w, precision_policy, compute_backend)


def _weights_by_speed(c, table):
    speeds = np.abs(c).sum(axis=0)
    return np.array([table[s] for s in speeds], dtype=np.float64)


class D3Q19(VelocitySet):
    """Three-dimensional nineteen-velocity stencil."""

    def __init__(self, precision_policy=None, compute_backend=None):
        c = np.array([ci for ci in itertools.product([0, -1, 1], repeat=3) if sum(abs(x) for x in ci) <= 2]).T
        w = _weights_by_speed(c, {0: 1 / 3, 1: 1 / 18, 2: 1 / 36})
        super().__init__(3, 19, c, w, precision_policy, compute_backend)


class D3Q27(VelocitySet):
    """Three-dimensional twenty-seven-velocity stencil."""

    def __init__(self, precision_policy=None, compute_backend=None):
        c = np.array(list(itertools.product([0, -1, 1], repeat=3))).T
        w = _weights_by_speed(c, {0: 8 / 27, 1: 2 / 27, 2: 1 / 54, 3: 1 / 216})
        super().__init__(3, 27, c, w, precision_policy, compute_backend)
