"""The plain reference of the benchmark's scenes, in plain PyTorch.

A D3Q19 BGK lattice Boltzmann pull step (stream, the streaming-step
boundaries, moments, the quadratic equilibrium, BGK, the collision-step
boundaries and the outflow's staging, solid voxels kept) with the five
boundary kinds the configurations use:

- ``fullway``: no-slip wall; after the collision every population of the
  wall voxel is the opposite post-stream population;
- ``halfway``: the missing populations of a fluid-side voxel are the
  opposite pre-stream populations of the same voxel; on interior
  geometry the given voxels are solid (kept as they are) and the BC holds
  the shell one stencil hop around them;
- ``equilibrium``: the post-stream populations are feq(rho, u);
- ``regularized``: a velocity inlet with a per-voxel velocity (Zou-He's
  mass balance, non-equilibrium bounce-back, then every population rebuilt
  from the non-equilibrium momentum flux, Latt and Chopard 2008);
- ``outflow``: extrapolation outflow (Geier et al. 2015): after the
  collision, cs f(x - n) + (1 - cs) f(x) of each missing direction is
  staged in the opposite slot, and the next step's missing populations
  are read back from there.

The masks (cell type per voxel, missing directions) are worked out here
from the voxel index sets the configuration hands to both sides. The
storage forms of the precision policies: float32 (``"f32"``), and 16- or
8-bit deviation form g = f - w with the populations loaded as g + w and
stored as (f - w) rounded, the window's boundary shifting by the weights
rounded to the storage type (``"bf16"``, ``"fp8"``).

The forward window runs in slabs of x planes, so that two states and a
few slabs fit beside the program's output; ``steps_autograd`` runs whole
steps under autograd for the training cell. Float32 matrix products are
kept out of TF32. This module imports neither JAX nor the program.
"""

import itertools

import numpy as np
import torch

SOLID = 255
CS = float(1.0 / np.sqrt(3.0))
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def d3q19():
    """(c (3, 19) int, w (19,) float64, opp (19,) int) in the population
    order of the program's fields."""
    c = np.array([ci for ci in itertools.product([0, -1, 1], repeat=3) if sum(abs(x) for x in ci) <= 2]).T
    w = np.array([{0: 1 / 3, 1: 1 / 18, 2: 1 / 36}[int(s)] for s in np.abs(c).sum(axis=0)])
    opp = np.array([int(np.flatnonzero((c == -c[:, [l]]).all(axis=0))[0]) for l in range(c.shape[1])])
    return c, w, opp


C, W, OPP = d3q19()
Q = C.shape[1]
MAIN = np.flatnonzero(np.abs(C).sum(axis=0) == 1)
PAIRS = [(a, b) for a in range(3) for b in range(a, 3)]
CC = np.stack([C[a] * C[b] for a, b in PAIRS], axis=1).astype(np.float64)  # (19, 6): xx xy xz yy yz zz
QI = CC.copy()
QI[:, [0, 3, 5]] -= 1.0 / 3.0
QI[:, [1, 2, 4]] *= 2.0
MOMENTS = torch.as_tensor(np.concatenate([np.ones((1, 19)), C]), dtype=torch.float32)  # rho and rho u
PADDED_KINDS = ("halfway", "regularized")  # fluid-side BCs: on interior geometry they hold the shell


def feq_np(rho, u):
    """feq (19,) of one state (float64)."""
    cu = 3.0 * (C.T @ np.asarray(u, np.float64))
    return rho * W * (1.0 + cu * (1.0 + 0.5 * cu) - 1.5 * float(np.dot(u, u)))


def equilibrium(rho, u):
    """feq (19, *s) float32 of rho (*s) and u (3, *s) float32 tensors:
    w_l rho (1 - 1.5 |u|^2 + 3 cu (1 + 1.5 cu)), cu = c_l . u."""
    dev = rho.device
    cu = torch.tensordot(torch.as_tensor(C.T, dtype=torch.float32, device=dev), u, dims=([1], [0]))
    base = rho * (1.0 - 1.5 * (u * u).sum(dim=0))
    poly = torch.addcmul(cu, cu, cu, value=1.5)
    del cu
    q = torch.addcmul(base, 3.0 * rho, poly)
    del poly
    return q * torch.as_tensor(W, dtype=torch.float32, device=dev).reshape((Q,) + (1,) * rho.dim())


def _dilate(idx):
    return np.unique((idx[:, :, None] + C[:, None, :]).reshape(3, -1), axis=1)


class Lattice:
    """The masks and boundary data of a scene on ``device``.

    ``boundaries``: the configuration's list of dicts, in the order the
    program receives them, each with ``kind`` and ``indices`` ((3, n)
    voxel indices), and per kind ``rho`` and ``u`` (equilibrium), ``profile``
    ((3, 1, ny, nz) inlet velocity over the y-z face, regularized).
    ``velocity_set`` and ``collision``: the configuration's; this
    reference refuses any but D3Q19 and BGK."""

    def __init__(self, shape, boundaries, device, velocity_set, collision):
        if (velocity_set, collision) != ("D3Q19", "BGK"):
            raise ValueError(f"the reference implements D3Q19 BGK, not {velocity_set} {collision}")
        self.shape = tuple(int(s) for s in shape)
        self.device = torch.device(device)
        X, Y, Z = self.shape
        ids = torch.zeros((X + 2, Y + 2, Z + 2), dtype=torch.uint8, device=self.device)
        source = torch.ones((X + 2, Y + 2, Z + 2), dtype=torch.bool, device=self.device)
        source[1:-1, 1:-1, 1:-1] = False
        lim = np.array(self.shape)[:, None]
        self.bcs = []
        for bid, b in enumerate(boundaries, start=1):
            idx = np.asarray(b["indices"], dtype=np.int64).reshape(3, -1)
            at = lambda i: tuple(torch.as_tensor(i + 1, device=self.device))  # noqa: E731
            if ((idx > 0) & (idx < lim - 1)).all(axis=0).any():  # interior geometry: solid voxels
                source[at(idx)] = True
                if b["kind"] in PADDED_KINDS:
                    ids[at(_dilate(idx))] = bid
                    ids[at(idx)] = SOLID
                else:
                    ids[at(idx)] = bid
            else:
                ids[at(idx)] = bid
            self.bcs.append(dict(b, id=bid))
        self.ids = ids[1:-1, 1:-1, 1:-1].contiguous()
        # direction l of voxel x is missing when its pull source x - c_l is a missing source
        self.missing = torch.stack([torch.roll(source, tuple(int(s) for s in C[:, l]), (0, 1, 2))[1:-1, 1:-1, 1:-1]
                                    for l in range(Q)]).contiguous()
        del ids, source
        yz = Y * Z
        for b in self.bcs:
            flat = torch.nonzero(self.ids.reshape(-1) == b["id"]).reshape(-1)  # sorted, x-major
            b["flat"] = flat
            b["plane_start"] = torch.searchsorted(flat, torch.arange(X + 1, device=self.device) * yz).cpu().numpy()
            if b["kind"] == "equilibrium":
                b["feq"] = torch.tensor(feq_np(b["rho"], b["u"]), dtype=torch.float32, device=self.device)
            elif b["kind"] == "regularized":
                prof = torch.as_tensor(np.asarray(b["profile"], np.float64), device=self.device)
                yzi = flat % yz
                b["velocity"] = prof.reshape(3, Y * Z)[:, yzi].to(torch.float32)  # u at each voxel, rounded once
            elif b["kind"] == "outflow":
                b["normal"] = face_normal(np.asarray(b["indices"]).reshape(3, -1), self.shape)
            elif b["kind"] not in ("fullway", "halfway"):
                raise ValueError(f"the reference has no boundary kind {b['kind']!r}")
        solid = torch.nonzero(self.ids.reshape(-1) == SOLID).reshape(-1)
        self._blocks = {}
        self.solid = {"flat": solid, "plane_start": torch.searchsorted(
            solid, torch.arange(X + 1, device=self.device) * yz).cpu().numpy()}

    def voxels(self, entry, planes):
        """(local flat index in a block of ``planes`` (global x list), global
        flat index) of a voxel set's voxels on those planes; kept, since
        every step asks for the same blocks."""
        key = (entry.get("id"), planes[0], len(planes))
        if key not in self._blocks:
            self._blocks[key] = self._voxels(entry, planes)
        return self._blocks[key]

    def _voxels(self, entry, planes):
        yz = self.shape[1] * self.shape[2]
        loc, glob = [], []
        for p, x in enumerate(planes):
            s, e = entry["plane_start"][x], entry["plane_start"][x + 1]
            if e > s:
                g = entry["flat"][s:e]
                glob.append(g)
                loc.append(g - x * yz + p * yz)
        if not glob:
            empty = torch.zeros(0, dtype=torch.long, device=self.device)
            return empty, empty
        return torch.cat(loc), torch.cat(glob)

    def step(self, fin, x0, omega):
        """One step for output planes [x0, x0 + L), from ``fin`` (19, L + 4,
        Y, Z) float32: the pre-stream populations of planes x0 - 2 ..
        x0 + L + 1 (x periodic). Returns the post-collision populations
        (19, L, Y, Z) float32 (solid voxels: see ``keep_solid``)."""
        X, Y, Z = self.shape
        L = fin.shape[1] - 4
        yz = Y * Z
        # post-stream populations of planes x0 - 1 .. x0 + L (the outflow's staging reads a neighbour plane)
        fs = torch.empty((Q, L + 2, Y, Z), dtype=fin.dtype, device=fin.device)
        for l in range(Q):
            cx, cy, cz = (int(v) for v in C[:, l])
            pull(fs[l], fin[l, 1 - cx:L + 3 - cx], cy, cz)
        pre = fin[:, 1:L + 3]  # pre-stream populations on the same planes
        planes = [(x0 - 1 + p) % X for p in range(L + 2)]
        fsf, pref = fs.reshape(Q, -1), pre.reshape(Q, -1)
        miss_all = self.missing.reshape(Q, -1)
        opp = torch.as_tensor(OPP, device=fin.device)
        for b in self.bcs:  # streaming-step boundaries, in the program's order
            if b["kind"] == "fullway":
                continue
            loc, glob = self.voxels(b, planes)
            if loc.numel() == 0:
                continue
            cur = fsf[:, loc]
            miss = miss_all[:, glob]
            if b["kind"] == "equilibrium":
                new = b["feq"][:, None].expand_as(cur)
            elif b["kind"] in ("halfway", "outflow"):
                new = torch.where(miss, pref[:, loc][opp], cur)
            else:
                new = regularized(cur, miss, b["velocity"][:, self._index_in(b, glob)])
            fsf[:, loc] = new
        # collision on planes x0 .. x0 + L - 1
        inner = fs[:, 1:L + 1]
        mom = (MOMENTS.to(fin.device) @ inner.reshape(Q, -1)).reshape((4, L, Y, Z))  # rho, then rho u
        rho = mom[0]
        feq = equilibrium(rho, mom[1:] / rho)
        del mom, rho
        post = torch.lerp(inner, feq, omega)
        del feq
        postf = post.reshape(Q, -1)
        inner_planes = planes[1:L + 1]
        for b in self.bcs:
            if b["kind"] == "outflow":
                loc, glob = self.voxels(b, inner_planes)
                if loc.numel():
                    n = b["normal"]
                    # the neighbour x - n on the post-stream block (one plane of margin in x; y and z periodic)
                    vx, rem = loc // yz, loc % yz
                    vy, vz = rem // Z, rem % Z
                    nb = ((vx + 1 - n[0]) * Y + (vy - n[1]) % Y) * Z + (vz - n[2]) % Z
                    ext = CS * fsf[:, nb] + (1.0 - CS) * fsf[:, loc + yz]
                    staged = miss_all[:, glob][opp]
                    postf[:, loc] = torch.where(staged, ext[opp], postf[:, loc])
            elif b["kind"] == "fullway":
                loc, glob = self.voxels(b, inner_planes)
                if loc.numel():
                    postf[:, loc] = fsf[:, loc + yz][opp]
        return post

    def _index_in(self, b, glob):
        """Positions of the global flat indices ``glob`` in the BC's voxel list."""
        return torch.searchsorted(b["flat"], glob)

    def keep_solid(self, g_out, g_in, x0, L):
        """Solid voxels of planes [x0, x0 + L) keep their stored value."""
        loc, glob = self.voxels(self.solid, list(range(x0, x0 + L)))
        if loc.numel():
            g_out.reshape(Q, -1)[:, glob] = g_in.reshape(Q, -1)[:, glob]


def pull(dst, src, cy, cz):
    """dst (L, Y, Z) = src rolled by (cy, cz) over y and z: dst[:, y, z] =
    src[:, y - cy, z - cz], periodic, copied in up to four pieces."""
    Y, Z = src.shape[1], src.shape[2]

    def pieces(c, n):  # (destination slice, source slice) pairs of a shift by c
        return [(slice(0, n), slice(0, n))] if c == 0 else (
            [(slice(1, n), slice(0, n - 1)), (slice(0, 1), slice(n - 1, n))] if c == 1 else
            [(slice(0, n - 1), slice(1, n)), (slice(n - 1, n), slice(0, 1))])

    for dy, sy in pieces(cy, Y):
        for dz, sz in pieces(cz, Z):
            dst[:, dy, dz] = src[:, sy, sz]


def regularized(fb, miss, vel):
    """The regularized velocity inlet at n voxels: post-stream populations
    ``fb`` (19, n), missing directions ``miss`` (19, n), the prescribed
    velocity ``vel`` (3, n)."""
    c = torch.as_tensor(C, dtype=fb.dtype, device=fb.device)
    opp = torch.as_tensor(OPP, device=fb.device)
    normals = -(c[:, MAIN] @ miss[MAIN].to(fb.dtype))
    known = miss[opp]
    middle = ~(miss | known)
    fsum = (fb * middle).sum(dim=0) + 2.0 * (fb * known).sum(dim=0)
    rho = fsum / (1.0 + (normals * vel).sum(dim=0))
    feq = equilibrium(rho, vel)
    fbd = torch.where(miss, fb[opp] + feq - feq[opp], fb)
    pi = torch.as_tensor(CC.T, dtype=fb.dtype, device=fb.device) @ (fbd - feq)
    w = torch.as_tensor(W, dtype=fb.dtype, device=fb.device)[:, None]
    return feq + 4.5 * w * (torch.as_tensor(QI, dtype=fb.dtype, device=fb.device) @ pi)


def face_normal(idx, shape):
    """Outward normal of a planar face of voxel indices (3, n)."""
    n = np.zeros(3, dtype=np.int64)
    for a in range(3):
        if np.all(idx[a] == idx[a, 0]):
            n[a] = -1 if idx[a, 0] == 0 else 1
            return n
    raise ValueError("an outflow face must be planar")


def exact_matmul():
    """Float32 matrix products in full float32, never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def shift_weights(storage, device):
    """(the weights the window's boundary shifts by, the float32 weights
    loads and stores add and subtract), each (19, 1, 1, 1) float32."""
    w64 = torch.as_tensor(W, dtype=torch.float64, device=device)
    return (w64.to(STORAGE[storage]).to(torch.float32).reshape(Q, 1, 1, 1),
            w64.to(torch.float32).reshape(Q, 1, 1, 1))


def window(lat, f_in, steps, omega, storage="f32", planes=None):
    """``steps`` steps from the populations ``f_in`` (19, X, Y, Z), in the
    storage form ``storage``: returns the populations after the window,
    float32. Runs in slabs of ``planes`` x planes, none of it under
    autograd."""
    exact_matmul()
    X, Y, Z = lat.shape
    planes = planes or max(1, min(X, int(1.0e9 // (Q * 4 * Y * Z))))
    dt = STORAGE[storage]
    shifted = storage != "f32"
    w_shift, w32 = shift_weights(storage, f_in.device)
    with torch.no_grad():
        g = (f_in.float() - w_shift).to(dt) if shifted else f_in.float().clone()
        out = torch.empty_like(g)
        for _ in range(steps):
            for x0 in range(0, X, planes):
                L = min(planes, X - x0)
                if x0 >= 2 and x0 + L + 2 <= X:
                    fin = g[:, x0 - 2:x0 + L + 2]
                else:
                    fin = g.index_select(1, torch.arange(x0 - 2, x0 + L + 2, device=f_in.device) % X)
                fin = fin.float() + w32 if shifted else fin
                post = lat.step(fin, x0, omega)
                del fin
                if shifted:
                    post -= w32
                out[:, x0:x0 + L] = post.to(dt)
                del post
                lat.keep_solid(out, g, x0, L)
            g, out = out, g
        del out
        return g.float() + w_shift if shifted else g


def steps_autograd(lat, f, steps, omega):
    """``steps`` float32 steps of the whole domain under autograd (each step
    checkpointed: its graph is rebuilt in the backward)."""
    from torch.utils.checkpoint import checkpoint

    exact_matmul()
    X = lat.shape[0]
    xs = torch.arange(-2, X + 2, device=f.device) % X

    def one(g, om):
        out = lat.step(g.index_select(1, xs), 0, om)
        loc, glob = lat.voxels(lat.solid, list(range(X)))
        if loc.numel():
            out.reshape(Q, -1)[:, glob] = g.reshape(Q, -1)[:, glob]
        return out

    for _ in range(steps):
        f = checkpoint(one, f, omega, use_reentrant=False)
    return f
