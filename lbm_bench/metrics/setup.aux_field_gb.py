"""The aux field (``kernels/fused_step.py::build_aux_field``, built on
the host and copied to the card at the first window call, in the port's
span ``xlb.window.aux``): GB of the aux field the window reads, from the
port's counter ``_FusedSweeps.aux_bytes``, read on the host after the
run. The field is dense, (channels, *shape) float32, however few voxels
read it. None where the port has no such counter (a checkout from before
it) or the trace has no device operation (the CPU). Moves ``setup_s``."""

import importlib


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    try:
        sweeps = importlib.import_module("xlb_tpu_torch.kernels.fused_step")._FusedSweeps
    except (ImportError, AttributeError):
        return None
    count = getattr(sweeps, "aux_bytes", None)
    return None if count is None else count / 1e9
