"""The plain reference of the sphere-drag tunnel, in plain PyTorch.

The D3Q19 BGK pull step of ``lbm.py`` (stream, the streaming-step
boundaries, moments, the quadratic equilibrium, BGK; solid voxels kept;
x, y and z periodic under the boundaries) with the three boundary kinds
of ``examples/cfd/sphere_drag_validation.py``. Every kind acts on the
fluid side: f* below is the post-stream population, f*_l(x) =
f_l(x - c_l), f the pre-stream (post-collision) one of the same voxel,
and direction l of a voxel is missing where its pull source x - c_l lies
outside the domain or in a solid voxel.

- ``freeslip`` (specular reflection; Succi, The Lattice Boltzmann
  Equation, 2001): at a face with outward normal n along axis
  a, each missing l with c_l,a = -n_a takes f_s(l)(x), s(l) the direction
  with c_s = c_l - 2 (c_l . n) n: a stress-free wall at the halfway plane.
  Departure: at an edge voxel the missing directions that cross the other
  face (not this one's) keep their streamed, periodically wrapped value,
  as the program's ``FreeSlipBC`` leaves them.
- ``regularized``, velocity or pressure (Zou & He, Phys. Fluids 9 (1997)
  1591; Latt & Chopard, Phys. Rev. E 77 (2008) 056703): with n = -sum of
  c_l over the missing main directions (the outward normal) and
  S = sum_middle f* + 2 sum_known f* (known: opp(l) missing; middle:
  neither), the velocity form sets rho = S / (1 + n . u), the pressure
  form u = (S / rho - 1) n; then f*_l <- f*_opp(l) + feq_l - feq_opp(l)
  for missing l (non-equilibrium bounce-back), Pi = sum_l c_l c_l (f*_l -
  feq_l), and every population f_l = feq_l + 9/2 w_l Q_l : Pi, Q_l =
  c_l c_l - I / 3.
- ``hybrid`` with the method ``bounceback`` (Yu, Mei & Shyy, AIAA
  2003-953; "a unified boundary treatment in lattice Boltzmann method"):
  for each missing l with the link's wall fraction t (the crossing of the
  segment x -> x - c_l with the wall, clipped to [0, 1]; 1/2 where none
  is given),
      f*_l = ((1 - t) f*_opp(l) + t (f_l + f_opp(l))) / (1 + t),
  f*_opp(l)(x) = f_opp(l)(x + c_l) being the population the next fluid
  voxel sends towards the wall; where opp(l) is missing too (a voxel
  between two solid voxels), f*_l = f_opp(l), plain bounce-back.
  Departure: the published scheme interpolates between the wall and the
  next fluid node in the post-collision populations; this is the
  single-node form upstream XLB's ``HybridBC`` writes (bc_method
  "bounceback"), the one the scene states. The given voxels are solid
  and keep their values; the BC holds the shell one stencil hop around
  them.

The boundary list is the configuration's (``configs/tunnel_*.py``):
dicts with ``kind`` and ``indices``, and ``normal`` (freeslip), ``u`` or
``rho`` (regularized), ``method``, ``shell`` and ``distances`` ((19, n)
crossing fractions along c_l at the shell voxels, inf for none; hybrid).
The masks are worked out here from those index sets. The window runs in
slabs of x planes (``lbm.window``); float32 matrix products are kept out
of TF32. This module imports neither JAX nor the program.
"""

import numpy as np
import torch

from lbm_bench.reference import lbm
from lbm_bench.reference.lbm import C, CC, MAIN, MOMENTS, OPP, Q, QI, SOLID, W, equilibrium, exact_matmul, pull, window

__all__ = ["Lattice", "window", "equilibrium", "W"]

KINDS = ("freeslip", "regularized", "hybrid")


def mirror(normal):
    """(q,) int64: s(l), c_l with its component along ``normal``'s axis negated."""
    a = int(np.flatnonzero(normal)[0])
    target = C.copy()
    target[a] = -target[a]
    return np.array([int(np.flatnonzero((C == target[:, [l]]).all(axis=0))[0]) for l in range(Q)])


class Lattice(lbm.Lattice):
    """The masks and boundary data of the tunnel on ``device``; the slab
    bookkeeping (``voxels``, ``keep_solid``) is ``lbm.Lattice``'s. Every
    kind here is a fluid-side BC: on interior geometry its given voxels are
    solid and it holds their dilated shell. Refuses any lattice but D3Q19
    BGK, any other kind, and a hybrid method but ``bounceback``."""

    def __init__(self, shape, boundaries, device, velocity_set, collision):
        if (velocity_set, collision) != ("D3Q19", "BGK"):
            raise ValueError(f"the reference implements D3Q19 BGK, not {velocity_set} {collision}")
        exact_matmul()
        self.shape = tuple(int(s) for s in shape)
        self.device = torch.device(device)
        X, Y, Z = self.shape
        ids = torch.zeros((X + 2, Y + 2, Z + 2), dtype=torch.uint8, device=self.device)
        source = torch.ones((X + 2, Y + 2, Z + 2), dtype=torch.bool, device=self.device)
        source[1:-1, 1:-1, 1:-1] = False
        lim = np.array(self.shape)[:, None]
        self.bcs = []
        for bid, b in enumerate(boundaries, start=1):
            if b["kind"] not in KINDS:
                raise ValueError(f"the reference has no boundary kind {b['kind']!r}")
            idx = np.asarray(b["indices"], dtype=np.int64).reshape(3, -1)
            at = lambda i: tuple(torch.as_tensor(i + 1, device=self.device))  # noqa: E731
            if ((idx > 0) & (idx < lim - 1)).all(axis=0).any():  # interior geometry: solid voxels
                source[at(idx)] = True
                ids[at(lbm._dilate(idx))] = bid
                ids[at(idx)] = SOLID
            else:
                ids[at(idx)] = bid
            self.bcs.append(dict(b, id=bid))
        self.ids = ids[1:-1, 1:-1, 1:-1].contiguous()
        self.missing = torch.stack([torch.roll(source, tuple(int(s) for s in C[:, l]), (0, 1, 2))[1:-1, 1:-1, 1:-1]
                                    for l in range(Q)]).contiguous()
        del ids, source
        yz = Y * Z
        for b in self.bcs:
            flat = torch.nonzero(self.ids.reshape(-1) == b["id"]).reshape(-1)  # sorted, x-major
            b["flat"] = flat
            b["plane_start"] = torch.searchsorted(flat, torch.arange(X + 1, device=self.device) * yz).cpu().numpy()
            if b["kind"] == "freeslip":
                n = np.asarray(b["normal"], dtype=np.int64)
                a = int(np.flatnonzero(n)[0])
                b["reflect"] = torch.as_tensor(C[a] == -n[a], device=self.device)[:, None]
                b["mirror"] = torch.as_tensor(mirror(n), device=self.device)
            elif b["kind"] == "regularized":
                if "u" in b:
                    b["velocity"] = torch.tensor(b["u"], dtype=torch.float64).to(torch.float32).to(self.device)[:, None]
                else:
                    b["density"] = torch.tensor(float(b["rho"]), dtype=torch.float32, device=self.device)
            elif b["method"] != "bounceback":
                raise ValueError(f"the reference implements the hybrid method 'bounceback', not {b['method']!r}")
            else:
                b["weight"] = self._link_weights(b, flat)
        solid = torch.nonzero(self.ids.reshape(-1) == SOLID).reshape(-1)
        self._blocks = {}
        self.solid = {"flat": solid, "plane_start": torch.searchsorted(
            solid, torch.arange(X + 1, device=self.device) * yz).cpu().numpy()}

    def _link_weights(self, b, flat):
        """(19, n) float32 wall fractions of a hybrid BC's n voxels (``flat``
        order), in the missing-direction convention: row l is the crossing
        along c_opp(l), towards the pull source; non-finite ones and voxels
        without a distance 1/2, the rest clipped to [0, 1]."""
        X, Y, Z = self.shape
        shell = np.asarray(b["shell"], dtype=np.int64).reshape(3, -1)
        along_c = np.asarray(b["distances"], dtype=np.float64)[OPP]
        t = np.clip(np.where(np.isfinite(along_c), along_c, 0.5).astype(np.float32), 0.0, 1.0)
        key = torch.as_tensor((shell[0] * Y + shell[1]) * Z + shell[2], device=self.device)
        pos = torch.searchsorted(flat, key).clamp(max=max(flat.numel() - 1, 0))
        found = flat[pos] == key
        weight = torch.full((Q, flat.numel()), 0.5, dtype=torch.float32, device=self.device)
        weight[:, pos[found]] = torch.as_tensor(t, device=self.device)[:, found]
        return weight

    def step(self, fin, x0, omega):
        """One step for output planes [x0, x0 + L), from ``fin`` (19, L + 4,
        Y, Z) float32: the pre-stream populations of planes x0 - 2 ..
        x0 + L + 1 (x periodic). Returns the post-collision populations
        (19, L, Y, Z) float32 (solid voxels: see ``keep_solid``)."""
        X, Y, Z = self.shape
        L = fin.shape[1] - 4
        fs = torch.empty((Q, L, Y, Z), dtype=fin.dtype, device=fin.device)
        for l in range(Q):
            cx, cy, cz = (int(v) for v in C[:, l])
            pull(fs[l], fin[l, 2 - cx:L + 2 - cx], cy, cz)
        fsf, pref = fs.reshape(Q, -1), fin[:, 2:L + 2].reshape(Q, -1)
        miss_all = self.missing.reshape(Q, -1)
        planes = list(range(x0, x0 + L))
        for b in self.bcs:  # every kind reads and writes its own voxels alone
            loc, glob = self.voxels(b, planes)
            if loc.numel() == 0:
                continue
            cur, miss = fsf[:, loc], miss_all[:, glob]
            if b["kind"] == "freeslip":
                new = torch.where(miss & b["reflect"], pref[:, loc][b["mirror"]], cur)
            elif b["kind"] == "regularized":
                new = regularized(cur, miss, b.get("velocity"), b.get("density"))
            else:
                new = interpolated_bounceback(cur, pref[:, loc], miss, b["weight"][:, self._index_in(b, glob)])
            fsf[:, loc] = new
        mom = (MOMENTS.to(fin.device) @ fsf).reshape((4, L, Y, Z))  # rho, then rho u
        rho = mom[0]
        feq = equilibrium(rho, mom[1:] / rho)
        del mom, rho
        return torch.lerp(fs, feq, omega)


def regularized(fb, miss, velocity=None, density=None):
    """The regularized inlet or outlet at n voxels: post-stream populations
    ``fb`` (19, n), missing directions ``miss`` (19, n), and the prescribed
    ``velocity`` (3, 1) or ``density`` (a 0-d tensor), float32."""
    c = torch.as_tensor(C, dtype=fb.dtype, device=fb.device)
    opp = torch.as_tensor(OPP, device=fb.device)
    normals = -(c[:, MAIN] @ miss[MAIN].to(fb.dtype))
    known = miss[opp]
    middle = ~(miss | known)
    fsum = (fb * middle).sum(dim=0) + 2.0 * (fb * known).sum(dim=0)
    if velocity is not None:
        vel = velocity.expand_as(normals)
        rho = fsum / (1.0 + (normals * vel).sum(dim=0))
    else:
        vel = (-1.0 + fsum / density) * normals
        rho = density.expand_as(fsum)
    feq = equilibrium(rho, vel)
    fbd = torch.where(miss, fb[opp] + feq - feq[opp], fb)
    pi = torch.as_tensor(CC.T, dtype=fb.dtype, device=fb.device) @ (fbd - feq)
    w = torch.as_tensor(W, dtype=fb.dtype, device=fb.device)[:, None]
    return feq + 4.5 * w * (torch.as_tensor(QI, dtype=fb.dtype, device=fb.device) @ pi)


def interpolated_bounceback(fs, fpre, miss, t):
    """The hybrid ``bounceback`` closure at n voxels: post-stream ``fs`` and
    pre-stream ``fpre`` populations (19, n), missing directions ``miss``
    (19, n), wall fractions ``t`` (19, n) in the missing convention."""
    opp = torch.as_tensor(OPP, device=fs.device)
    interp = ((1.0 - t) * fs[opp] + t * (fpre + fpre[opp])) / (1.0 + t)
    interp = torch.where(miss & miss[opp], fpre[opp], interp)
    return torch.where(miss, interp, fs)
