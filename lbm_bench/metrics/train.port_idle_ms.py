"""The autograd glue holding the card idle: the traced stretch's idle
gaps after its first device operation where the host was inside the
port's ``xlb.window`` or ``xlb.backward`` range, in ms per training
step. Moves
``train_mlups``."""

from lbm_bench import spans


def read(run):
    return spans.port_idle_ms(run)
