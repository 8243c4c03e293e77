"""The autograd glue's blocking host syncs: the port's ``xlb.wait.*``
spans in the window call and its backward (``kernels/fused_step.py``:
``_host_float`` reading omega back) per training step in the traced
stretch. Moves ``train_mlups``."""

from lbm_bench import spans


def read(run):
    return spans.host_syncs(run)
