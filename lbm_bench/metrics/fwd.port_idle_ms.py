"""The window glue holding the card idle: the traced stretch's idle
gaps after its first device operation where the host was inside the
port's ``xlb.window`` range (a ``user_annotation`` in the profiler's
trace), in ms per window call. The gap before the first device operation
is the profiler's start (``lbm_bench/spans.py``).
Moves ``mlups`` (the float32 forward cells)."""

from lbm_bench import spans


def read(run):
    return spans.port_idle_ms(run)
