"""The library and the first window (``kernels/_cuda.py`` loading the
kernel library, building it when the checkout has none;
``kernels/fused_step.py::build_fused_window``; the first launch of each
kernel): seconds of the warm-up window, or of the first training step,
ending in a synchronize (the benchmark's span ``setup.first_window``).
Moves ``setup_s``."""


def read(run):
    spans = run.spans.get("setup.first_window")
    return spans[0] if spans else None
