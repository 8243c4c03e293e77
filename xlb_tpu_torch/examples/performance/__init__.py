"""Torch counterparts of ``examples/performance/``: the copy-bandwidth
probes (``memory_bandwidth``, ``dma_experiments``, through K9-K12) and the
MLUPS benchmarks (``mlups_2d``, ``mlups_3d``, ``mlups_3d_multires``).
Each is importable (its ``run`` / ``benchmark`` returns its numbers) and
runs as ``python -m xlb_tpu_torch.examples.performance.<name>``."""
