"""The device in a bfloat16 forward window: ``fwd.device_idle`` in the
cells whose rate is held to a bound of its own. Moves ``mlups.bf16``."""

from lbm_bench import shares


def read(run):
    return shares.idle_percent(run)
