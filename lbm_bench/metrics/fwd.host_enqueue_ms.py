"""The window glue (``models/nse.py::build_multi_step``,
``kernels/fused_step.py::_FusedSweeps`` and ``pack_masks``): host
milliseconds for the first measured window's call to return, without a
synchronize, the card idle when it starts (the benchmark's span
``fwd.enqueue``). Later calls wait for the card while its queue is full,
so they would read the card's pace, not the host's. When it nears the
window's device time, the host sets the pace. Moves ``mlups``
(the float32 forward cells)."""


def read(run):
    spans = run.spans.get("fwd.enqueue")
    return spans[0] * 1e3 if spans else None
