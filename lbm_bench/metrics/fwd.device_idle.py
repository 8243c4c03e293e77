"""The device in a forward window: the share of the traced stretch in
which no operation ran on the card, in percent. Moves ``mlups``
(the float32 forward cells)."""

from lbm_bench import shares


def read(run):
    return shares.idle_percent(run)
