"""Streaming (propagation) operator.

Pull-scheme propagation with periodic wrap: population l at voxel x reads
from voxel x - c_l, i.e. ``out[l] = roll(f[l], +c_l)`` -- ``torch.roll``
has the sign convention of ``jnp.roll`` used by ``xlb_tpu.ops.stream``.
Non-periodic physics is imposed afterwards by boundary conditions.
"""

import torch

from xlb_tpu_torch.operator import Operator


def stream_pull(f, c):
    """Pull-stream all q populations: out[l] = roll(f[l], shift=c[:, l])."""
    spatial_dims = tuple(range(f.ndim - 1))
    return torch.stack(
        [torch.roll(f[l], shifts=tuple(int(s) for s in c[:, l]), dims=spatial_dims) for l in range(c.shape[1])]
    )


class Stream(Operator):
    """Pull-scheme streaming operator (periodic by construction)."""

    def __call__(self, f):
        return stream_pull(f, self.velocity_set._c)
