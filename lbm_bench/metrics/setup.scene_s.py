"""Scene set-up (``models/nse.py::prepare_fields``, ``boundary/``,
``kernels/fused_step.py`` at construction): seconds from the first call
that builds the scene until ``prepare_fields`` returned and the card
finished (the benchmark's span ``setup.scene``). Moves ``setup_s``."""


def read(run):
    spans = run.spans.get("setup.scene")
    return spans[0] if spans else None
