"""Equilibrium initialization of distribution fields."""

from xlb_tpu_torch.ops.equilibrium import quadratic_equilibrium


def initialize_eq(f, grid, velocity_set, precision_policy):
    """Return f initialized to feq(rho=1, u=0) in the store dtype (so under
    FP32BF16, f starts as bf16(w))."""
    rho = grid.create_field(cardinality=1, fill_value=1.0, dtype=precision_policy.compute_precision)
    u = grid.create_field(cardinality=velocity_set.d, fill_value=0.0, dtype=precision_policy.compute_precision)
    feq = quadratic_equilibrium(rho, u, velocity_set._c, velocity_set._w, precision_policy.compute_dtype)
    return feq.to(precision_policy.store_dtype)
