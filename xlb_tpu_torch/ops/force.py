"""Body forcing and boundary-force readout -- ``xlb_tpu.ops.force``:
``ExactDifference`` (Kupershtokh's exact-difference body force), and
``FetchPopulations`` / ``MomentumTransfer``: momentum-exchange drag and
lift on a no-slip boundary, as a masked contraction and a global sum in
plain torch (the reference computes them outside any kernel too)."""

from enum import Enum, auto

import numpy as np
import torch

from xlb_tpu_torch.operator import Operator
from xlb_tpu_torch.ops.equilibrium import quadratic_equilibrium
from xlb_tpu_torch.ops.stencil_math import stencil_contract
from xlb_tpu_torch.ops.stream import stream_pull


class LBMOperationSequence(Enum):
    """Order of stream and collide in the stepper that produced the state."""

    STREAM_THEN_COLLIDE = auto()
    COLLIDE_THEN_STREAM = auto()


class ExactDifference(Operator):
    """Kupershtokh (2004) exact-difference forcing, applied after the
    collision: f_out += feq(rho, u + F) - feq(rho, u)."""

    def __init__(self, force_vector, velocity_set=None, precision_policy=None, compute_backend=None):
        super().__init__(velocity_set, precision_policy, compute_backend)
        self.force_vector = np.asarray(force_vector, dtype=np.float64)
        if self.force_vector.shape != (self.velocity_set.d,):
            raise ValueError("the force vector must have one entry per spatial dimension")

    def __call__(self, f_postcollision, feq, rho, u):
        vs = self.velocity_set
        delta_u = torch.as_tensor(self.force_vector, device=u.device).to(u.dtype).reshape((-1,) + (1,) * (u.ndim - 1))
        feq_force = quadratic_equilibrium(rho, u + delta_u, vs._c, vs._w, self.compute_dtype)
        return f_postcollision + (feq_force - feq)


class FetchPopulations(Operator):
    """Recover the (post-collision, post-stream) population pair from the
    stored state. With the stream-then-collide stepper, f_0 holds the
    post-collision values; the post-stream state is rebuilt by streaming
    once and re-applying the no-slip BC."""

    def __init__(self, no_slip_bc_instance, operation_sequence=LBMOperationSequence.STREAM_THEN_COLLIDE,
                 velocity_set=None, precision_policy=None, compute_backend=None):
        super().__init__(velocity_set, precision_policy, compute_backend)
        self.no_slip_bc_instance = no_slip_bc_instance
        self.operation_sequence = operation_sequence

    def __call__(self, f_0, f_1, bc_mask, missing_mask):
        if self.operation_sequence == LBMOperationSequence.STREAM_THEN_COLLIDE:
            f_post_collision = f_0
            f_post_stream = stream_pull(f_0, self.velocity_set._c)
            f_post_stream = self.no_slip_bc_instance(f_post_collision, f_post_stream, bc_mask, missing_mask)
            return f_post_collision, f_post_stream
        return f_1, f_0


class MomentumTransfer(Operator):
    """Drag and lift by momentum exchange (Ladd 1994; Mei et al. 2002):
    sums c_opp (f_postcollision[opp] + f_poststream) over the missing
    directions of the boundary's fluid-side voxels; returns the net force
    vector (d,)."""

    def __init__(self, no_slip_bc_instance, operation_sequence=LBMOperationSequence.STREAM_THEN_COLLIDE,
                 velocity_set=None, precision_policy=None, compute_backend=None):
        super().__init__(velocity_set, precision_policy, compute_backend)
        self.no_slip_bc_instance = no_slip_bc_instance
        self.operation_sequence = operation_sequence
        self.fetcher = FetchPopulations(no_slip_bc_instance, operation_sequence, velocity_set=self.velocity_set,
                                        precision_policy=self.precision_policy, compute_backend=self.compute_backend)
        self._opp = None

    def __call__(self, f_0, f_1, bc_mask, missing_mask):
        vs = self.velocity_set
        f_post_collision, f_post_stream = self.fetcher(f_0, f_1, bc_mask, missing_mask)
        boundary = (bc_mask == self.no_slip_bc_instance.id)[0]
        # fluid-side edge voxels: tagged, with their rest direction present
        is_edge = boundary[None] & ~missing_mask[0][None]
        if self._opp is None or self._opp.device != f_0.device:  # made once: a copy per call would stall the host
            self._opp = torch.as_tensor(vs._opp_indices, dtype=torch.long, device=f_0.device)
        phi = f_post_collision[self._opp] + f_post_stream
        phi = torch.where(missing_mask & is_edge, phi, 0.0)
        force = stencil_contract(vs._c[:, vs._opp_indices], phi)
        return torch.sum(force, dim=tuple(range(1, force.ndim)))
