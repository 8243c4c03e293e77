"""Global configuration singleton and ``init`` entry point.

``xlb_tpu_torch.init`` pins the default velocity set, backend tier, and
precision policy that every subsequently constructed operator reads when
not explicitly configured.
"""

from xlb_tpu_torch.compute_backend import ComputeBackend, check_backend_supported
from xlb_tpu_torch.precision_policy import PrecisionPolicy


class _DefaultConfig:
    velocity_set = None
    default_backend = None
    default_precision_policy = None

    def reset(self):
        self.velocity_set = None
        self.default_backend = None
        self.default_precision_policy = None


DefaultConfig = _DefaultConfig()


def init(velocity_set, default_backend=ComputeBackend.TORCH, default_precision_policy=PrecisionPolicy.FP32FP32):
    """One-time global setup.

    Parameters
    ----------
    velocity_set : VelocitySet
        The lattice stencil (D2Q9 / D3Q19 / D3Q27 instance).
    default_backend : ComputeBackend
        TORCH (plain torch ops) or CUDA (hand-written kernels for the hot loop).
    default_precision_policy : PrecisionPolicy
        Compute/store dtype pair.
    """
    check_backend_supported(default_backend)
    if not isinstance(default_precision_policy, PrecisionPolicy):
        raise TypeError(f"expected a PrecisionPolicy, got {default_precision_policy!r}")
    DefaultConfig.velocity_set = velocity_set
    DefaultConfig.default_backend = default_backend
    DefaultConfig.default_precision_policy = default_precision_policy
    return DefaultConfig
