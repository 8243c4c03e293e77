"""The port's share of the autograd glue: the busy device ms (a span's
CUDA events less the trace's idle gaps inside it) of the window calls
outside their ``xlb.window.sweep`` and of the reverse sweeps
(``xlb.backward``) outside their ``xlb.backward.replay`` and
``xlb.backward.adjoint`` (the dom reduction, casts, mask packing), over
the traced stretch's busy device time, in percent: the base of
``train.autograd_glue_share``, whose rest is the loss, its backward and
Adam. Moves ``train_mlups``."""

from lbm_bench import spans


def read(run):
    return spans.port_glue_share(run)
