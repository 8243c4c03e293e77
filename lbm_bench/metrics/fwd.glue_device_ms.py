"""The window glue on the card: per window call, the busy device ms of
the port's ``xlb.window`` span less those of its ``xlb.window.sweep``
(the K2 / K1 launches): ``pack_masks`` and the storage shifts. A span's
device ms come from CUDA events at its ends
(``xlb_tpu_torch.utils.tracing``), less the trace's idle gaps while the
host was inside it, so the card's waits on the host are left out (they
are ``fwd.port_idle_ms``). Moves ``mlups`` (the float32 forward
cells)."""

from lbm_bench import spans


def read(run):
    return spans.glue_device_ms(run)
