"""Compute-backend enum.

The port has two tiers, mirroring ``xlb_tpu``'s JAX/PALLAS pair:

- ``TORCH``: plain ``torch`` ops on any device. It is the oracle tier, as
  the pure-jnp tier is for ``xlb_tpu``.
- ``CUDA``: the hand-written Hopper kernels in ``xlb_tpu_torch/csrc`` for
  the hot loop; setup-time operators still run as plain torch ops. A
  CUDA-tier stepper needs a grid on a CUDA device and never runs on the
  CPU instead.
"""

from enum import Enum, auto


class ComputeBackend(Enum):
    TORCH = auto()
    CUDA = auto()


def check_backend_supported(backend: "ComputeBackend") -> "ComputeBackend":
    if not isinstance(backend, ComputeBackend):
        raise TypeError(f"expected a ComputeBackend, got {backend!r}")
    return backend
