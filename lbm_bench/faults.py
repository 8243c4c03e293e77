"""Faults planted under the timed path, for the checks that have to see
``correct`` come out false: each wraps a window callable
``run(f_0, f_1, *masks, omega) -> (f, f)``, and ``Planted`` puts one
under a system's window."""

import torch


class Planted:
    """``system`` with ``fault`` wrapped around every window it builds."""

    def __init__(self, system, fault):
        self._system, self._fault = system, fault

    def __getattr__(self, name):
        return getattr(self._system, name)

    def window(self, stepper, steps):
        return self._fault(self._system.window(stepper, steps))


def unchanged(run):
    """A window that returns its input: the state left as it was."""
    def broken(f_0, f_1, *rest):
        out, _ = run(f_0, f_1, *rest)
        return f_0 + 0.0 * out, f_0 + 0.0 * out
    return broken


def half_domain(run):
    """A window that advances the first half of x and leaves the rest."""
    def broken(f_0, f_1, *rest):
        out, _ = run(f_0, f_1, *rest)
        X = out.shape[1]
        keep = torch.zeros_like(out, dtype=torch.bool)
        keep[:, X // 2:] = True
        res = torch.where(keep, f_0.to(out.dtype), out)
        return res, res
    return broken


def altered(run):
    """A window whose output loses one population at one voxel."""
    def broken(f_0, f_1, *rest):
        out, _ = run(f_0, f_1, *rest)
        mask = torch.ones_like(out)
        mask[3, out.shape[1] // 2, out.shape[2] // 2, out.shape[3] // 2] = 0.0
        res = out * mask
        return res, res
    return broken


class _Negated(torch.autograd.Function):
    """The identity forward, its cotangent negated backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def omega_sign(run):
    """A window whose gradient with respect to omega has the wrong sign
    (a float omega, as the forward windows pass it, is left as it is)."""
    def broken(f_0, f_1, *rest):
        *masks, omega = rest
        if isinstance(omega, torch.Tensor) and omega.requires_grad:
            omega = _Negated.apply(omega)
        return run(f_0, f_1, *masks, omega)
    return broken
