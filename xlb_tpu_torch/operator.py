"""Operator base class.

An operator is a configured callable: ``__call__`` is a function of its
tensor arguments, closed over static configuration (velocity set, precision
policy, compute backend). It is not an ``nn.Module``: operators hold no
parameters or buffers.
"""

from xlb_tpu_torch.compute_backend import ComputeBackend, check_backend_supported
from xlb_tpu_torch.precision_policy import PrecisionPolicy
from xlb_tpu_torch.default_config import DefaultConfig


class Operator:
    """Base for all operators: holds the static configuration.

    Parameters default to the ``DefaultConfig`` singleton populated by
    ``xlb_tpu_torch.init``.
    """

    def __init__(self, velocity_set=None, precision_policy=None, compute_backend=None):
        self.velocity_set = velocity_set if velocity_set is not None else DefaultConfig.velocity_set
        self.precision_policy = precision_policy if precision_policy is not None else DefaultConfig.default_precision_policy
        backend = compute_backend if compute_backend is not None else DefaultConfig.default_backend
        self.compute_backend = check_backend_supported(backend) if backend is not None else ComputeBackend.TORCH

        if self.velocity_set is None or self.precision_policy is None:
            raise RuntimeError(
                f"{type(self).__name__} constructed without a velocity set / precision policy; "
                "call xlb_tpu_torch.init(...) first or pass them explicitly."
            )
        if not isinstance(self.precision_policy, PrecisionPolicy):
            raise TypeError(f"precision_policy must be a PrecisionPolicy, got {self.precision_policy!r}")

    @property
    def compute_dtype(self):
        return self.precision_policy.compute_dtype

    @property
    def store_dtype(self):
        return self.precision_policy.store_dtype

    def __repr__(self):
        return f"{type(self).__name__}({self.velocity_set}, {self.precision_policy.name})"
