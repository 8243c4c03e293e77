"""The window glue's blocking host syncs in a bfloat16 forward window:
``fwd.host_syncs`` in the cells whose rate is held to a bound of its
own. Moves ``mlups.bf16``."""

from lbm_bench import spans


def read(run):
    return spans.host_syncs(run)
