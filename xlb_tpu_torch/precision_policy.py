"""Precision system: scalar precisions and compute/store precision policies.

Same members as ``xlb_tpu.precision_policy``, mapped to torch dtypes.
"""

from enum import Enum, auto

import torch


class Precision(Enum):
    FP64 = auto()
    FP32 = auto()
    FP16 = auto()
    BF16 = auto()
    UINT8 = auto()
    UINT32 = auto()
    BOOL = auto()

    @property
    def torch_dtype(self):
        return {
            Precision.FP64: torch.float64,
            Precision.FP32: torch.float32,
            Precision.FP16: torch.float16,
            Precision.BF16: torch.bfloat16,
            Precision.UINT8: torch.uint8,
            Precision.UINT32: torch.uint32,
            Precision.BOOL: torch.bool,
        }[self]


class PrecisionPolicy(Enum):
    """A (compute, store) dtype pair.

    The distribution functions live in device memory in the *store*
    precision; every operator upcasts to the *compute* precision on entry
    and downcasts on exit.
    """

    FP64FP64 = auto()
    FP64FP32 = auto()
    FP64FP16 = auto()
    FP32FP32 = auto()
    FP32FP16 = auto()
    FP32BF16 = auto()
    BF16BF16 = auto()

    @property
    def compute_precision(self) -> Precision:
        return {
            PrecisionPolicy.FP64FP64: Precision.FP64,
            PrecisionPolicy.FP64FP32: Precision.FP64,
            PrecisionPolicy.FP64FP16: Precision.FP64,
            PrecisionPolicy.FP32FP32: Precision.FP32,
            PrecisionPolicy.FP32FP16: Precision.FP32,
            PrecisionPolicy.FP32BF16: Precision.FP32,
            PrecisionPolicy.BF16BF16: Precision.BF16,
        }[self]

    @property
    def store_precision(self) -> Precision:
        return {
            PrecisionPolicy.FP64FP64: Precision.FP64,
            PrecisionPolicy.FP64FP32: Precision.FP32,
            PrecisionPolicy.FP64FP16: Precision.FP16,
            PrecisionPolicy.FP32FP32: Precision.FP32,
            PrecisionPolicy.FP32FP16: Precision.FP16,
            PrecisionPolicy.FP32BF16: Precision.BF16,
            PrecisionPolicy.BF16BF16: Precision.BF16,
        }[self]

    @property
    def compute_dtype(self):
        return self.compute_precision.torch_dtype

    @property
    def store_dtype(self):
        return self.store_precision.torch_dtype

    def cast_to_compute(self, tensor):
        return tensor.to(self.compute_dtype)

    def cast_to_store(self, tensor):
        return tensor.to(self.store_dtype)
