"""The window glue on the card in a bfloat16 forward window:
``fwd.glue_device_ms`` in the cells whose rate is held to a bound of its
own. Moves ``mlups.bf16``."""

from lbm_bench import spans


def read(run):
    return spans.glue_device_ms(run)
