"""The autograd glue (``kernels/fused_step.py::_FusedFunction``, and the
loss and Adam around it): the device time of operations that are neither
a stream nor an adjoint kernel (casts, copies, reductions, the loss,
Adam's update) over all device time in the traced stretch, in percent.
Moves ``train_mlups``."""

from lbm_bench import shares


def read(run):
    return shares.other_percent(run, ("stream", "adjoint"))
