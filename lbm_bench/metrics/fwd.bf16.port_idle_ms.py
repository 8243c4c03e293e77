"""The window glue holding the card idle in a bfloat16 forward window:
``fwd.port_idle_ms`` in the cells whose rate is held to a bound of its
own. Moves ``mlups.bf16``."""

from lbm_bench import spans


def read(run):
    return spans.port_idle_ms(run)
