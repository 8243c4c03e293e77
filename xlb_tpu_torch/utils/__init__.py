from xlb_tpu_torch.utils.interop import fields_from_numpy, fields_to_numpy

__all__ = ["fields_from_numpy", "fields_to_numpy"]
