"""The adjoint kernel K8 (``kernels/adjoint_step.py``;
``csrc/adjoint_step.cuh``: ``adjoint_kernel`` and, on open scenes,
``adjoint_centred_kernel`` and ``adjoint_staging_kernel``): the sum over
its adjoint steps in the traced stretch of the least time
(``kernels/adjoint.py``) over the device time of all three launches, in
percent. Moves ``train_mlups``."""

from lbm_bench import shares


def read(run):
    return shares.roofline_percent(run, "adjoint")
