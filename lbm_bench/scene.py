"""What the configurations share: the voxel index sets their scenes are
made of, and the port's stepper built through its public API from a
configuration's lattice, collision and BC objects."""

import numpy as np


def box_face(shape, axis, side, trim=0, skip=None):
    """(3, n) int64 indices of the face ``axis`` = 0 (``side`` 0) or = n - 1
    (``side`` 1), the other axes from ``trim`` to n - 1 - ``trim``;
    ``skip``: {axis: (lo, hi)} further ranges to keep the face inside."""
    ranges = []
    for a, n in enumerate(shape):
        if a == axis:
            ranges.append(np.array([0 if side == 0 else n - 1]))
        else:
            lo, hi = (skip or {}).get(a, (trim, n - 1 - trim))
            ranges.append(np.arange(lo, hi + 1))
    g = np.meshgrid(*ranges, indexing="ij")
    return np.stack([x.reshape(-1) for x in g]).astype(np.int64)


def ball(shape, center, radius):
    """(3, n) int64 indices of the voxels (x, y, z) with |(x, y, z) - center|^2
    < radius^2, the voxel at its integer coordinates."""
    lo = [max(0, int(np.floor(c - radius))) for c in center]
    hi = [min(n - 1, int(np.ceil(c + radius))) for c, n in zip(center, shape)]
    g = np.meshgrid(*[np.arange(a, b + 1) for a, b in zip(lo, hi)], indexing="ij")
    inside = sum((x - c) ** 2 for x, c in zip(g, center)) < radius**2
    return np.stack([x[inside] for x in g]).astype(np.int64)


def constant(value):
    """A zero-argument profile returning ``value``."""
    return lambda: value


def _unchanged(bc_mask, f):
    return f


def build(cfg, policy, device, backend, make_bcs):
    """(stepper, bc_mask, missing_mask) of the configuration's scene:
    ``xlb_tpu_torch.init`` with the lattice ``cfg["velocity_set"]``,
    ``grid_factory``, the BC objects ``make_bcs()`` returns (called once the
    port is initialised), ``IncompressibleNavierStokesStepper`` with the
    collision ``cfg["collision"]``, and ``prepare_fields``. The benchmark
    makes the initial populations from the seed, so ``prepare_fields``
    keeps its allocated ones as they are (an initializer that returns them)
    and they are dropped."""
    import xlb_tpu_torch as xlb
    from xlb_tpu_torch import velocity_set
    from xlb_tpu_torch.boundary.registry import boundary_condition_registry
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    xlb.DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=getattr(velocity_set, cfg["velocity_set"])(),
             default_backend=xlb.ComputeBackend[backend], default_precision_policy=xlb.PrecisionPolicy[policy])
    grid = xlb.grid_factory(tuple(cfg["shape"]), device=device)
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=make_bcs(),
                                                collision_type=cfg["collision"])
    f_0, f_1, bc_mask, missing_mask = stepper.prepare_fields(initializer=_unchanged)
    del f_0, f_1
    return stepper, bc_mask, missing_mask
