"""Collision operators. BGK only in this slice of the port; the other
models of ``xlb_tpu.ops.collision`` are still to be ported."""

from xlb_tpu_torch.operator import Operator


def bgk_collide(f, feq, omega):
    """Single-relaxation-time BGK: f - omega (f - feq)."""
    return f - omega * (f - feq)


class Collision(Operator):
    """Base class for collision operators: ``(f, feq, omega) -> f_post``."""


class BGK(Collision):
    def __call__(self, f, feq, omega):
        return bgk_collide(f, feq, omega)
