"""The window glue's blocking host syncs: the port's ``xlb.wait.*``
spans (a read-back of omega, a copy of ``w_shift`` from pageable host
memory, ``kernels/fused_step.py``) per window call in the traced stretch.
Each one holds the host until the card is done. Moves ``mlups`` (the
float32 forward cells)."""

from lbm_bench import spans


def read(run):
    return spans.host_syncs(run)
