"""The stream kernels K2, K1, K0 in a bfloat16 forward window:
``fwd.stream_roofline`` in the cells whose rate is held to a bound of its
own. Moves ``mlups.bf16``."""

from lbm_bench import shares


def read(run):
    return shares.roofline_percent(run, "stream")
