"""The card's peaks, and the least time of a kernel call.

Published rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): 3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the
tensor cores. Every roofline share of the benchmark is stated against
these, with the card's power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def least_seconds(nbytes, flops):
    """The least time the card could take for a call that moves ``nbytes``
    and does ``flops`` float32 operations: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
