"""The inputs of a run, made on the device from ``--seed``: an initial flow
(and the training cell's target) as smooth random fields, the same sizes
for every seed, handed to the program and to the reference alike."""

import math

import torch

MODES = 8  # sine modes of a seeded field
K_MAX = 4  # their wave numbers, per axis, from 1 to K_MAX


def generator(seed, stream, device):
    """A generator on ``device`` for one stream of a seed's draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(stream)) % 2**63)
    return gen


def seeded_flow(shape, seed, stream, base_u, amplitude, device):
    """(rho (*shape), u (d, *shape)) float32: ``base_u`` plus MODES sine
    modes of seeded wave numbers, phases and amplitudes (u's of size
    ``amplitude``, rho's a tenth of that around 1)."""
    d = len(shape)
    gen = generator(seed, stream, device)
    k = torch.randint(1, K_MAX + 1, (MODES, d), generator=gen, device=device).cpu().tolist()
    a = (torch.randn((MODES, d + 1), generator=gen, device=device) * amplitude).cpu().tolist()
    ph = (torch.rand((MODES,), generator=gen, device=device) * 2.0 * math.pi).cpu().tolist()
    axes = [torch.arange(n, device=device, dtype=torch.float32) * (2.0 * math.pi / n) for n in shape]
    rho = torch.ones(shape, dtype=torch.float32, device=device)
    u = torch.empty((d,) + tuple(shape), dtype=torch.float32, device=device)
    for i in range(d):
        u[i] = float(base_u[i])
    for m in range(MODES):
        arg = sum((k[m][i] * axes[i] + (ph[m] if i == d - 1 else 0.0)).reshape([-1 if j == i else 1 for j in range(d)])
                  for i in range(d))
        s = torch.sin(arg)
        for i in range(d):
            u[i].add_(s, alpha=a[m][i])
        rho.add_(s, alpha=0.1 * a[m][d])
        del arg, s
    return rho, u


def populations(reference, shape, seed, stream, flow, device):
    """The equilibrium populations (q, *shape) float32, as ``reference``
    works them out, of the seeded flow ``flow`` (``base_u``,
    ``amplitude``)."""
    rho, u = seeded_flow(shape, seed, stream, flow["base_u"], flow["amplitude"], device)
    return reference.equilibrium(rho, u)
