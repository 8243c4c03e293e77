"""Under pytest-xdist, share the cores between the workers: torch's own
threads in every worker would oversubscribe them many times over."""

import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _workers > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))
