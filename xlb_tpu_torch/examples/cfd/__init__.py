"""Torch forms of ``examples/cfd/``'s scripts: the same scenes and
defaults, on the CUDA tier (``--backend cuda``, the default) or the TORCH
tier (``--backend torch``)."""
