"""The stream kernels K2, K1, K0 (``kernels/collide_stream_2step.py``,
``collide_stream_dma.py``, ``collide_stream_blocked.py``;
``csrc/collide_stream_3d.cuh``, ``collide_stream_blocked.cuh``): the sum
over their calls in the traced stretch of the least time
(``kernels/stream.py``) over the sum of their device time, in percent.
Counted by family, so a window that trades K2 groups for K1 launches
still reads. Moves ``mlups``
(the float32 forward cells)."""

from lbm_bench import shares


def read(run):
    return shares.roofline_percent(run, "stream")
