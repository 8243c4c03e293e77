"""Lattice-unit helpers -- ``xlb_tpu.utils.units``'s relaxation-rate
conversions. (``UnitConvertor`` is not ported yet.)"""


def omega_from_reynolds(reynolds: float, char_velocity_lbm: float, char_length_lbm: float) -> float:
    """Relaxation rate omega for a target Reynolds number:
    nu = u L / Re, tau = 3 nu + 1/2, omega = 1/tau."""
    nu = char_velocity_lbm * char_length_lbm / reynolds
    return 1.0 / (3.0 * nu + 0.5)


def viscosity_from_omega(omega: float) -> float:
    """Lattice kinematic viscosity nu = cs^2 (1/omega - 1/2)."""
    return (1.0 / omega - 0.5) / 3.0
