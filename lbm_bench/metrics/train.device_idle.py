"""The device in a training step: the share of the traced stretch in
which no operation ran on the card, in percent. Moves ``train_mlups``."""

from lbm_bench import shares


def read(run):
    return shares.idle_percent(run)
