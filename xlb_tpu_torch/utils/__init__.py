from xlb_tpu_torch.utils.interop import cotangent_from_numpy, fields_from_numpy, fields_to_numpy, gradients_to_numpy

__all__ = ["cotangent_from_numpy", "fields_from_numpy", "fields_to_numpy", "gradients_to_numpy"]
