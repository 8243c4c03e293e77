"""The multires collide-THEN-stream sub-step (K6, K7): wrapper of the CUDA
kernel family and its plain version.

A multires level advances as collide -> collision-step BCs -> stream ->
streaming-step BCs, the finest and middle levels over a ring-extended box
whose ring carries the parent's exploded post-collision populations (cell
type 254: kept through the collide). ``CollideThenStream`` runs that
sub-step in one pass over device memory, or both finest sub-steps of a
coarse step with ``pair=True``. It is the counterpart of two TPU kernels
of ``xlb_tpu.kernels.collide_then_stream``, which compute one function:

- ``build_fused_cts_pair_thin`` (K7): per-axis rings, the ``coalesce_out``
  side output (the fine->coarse average of the core), ``ring_freeze``,
  ``pair`` or a single sub-step (coarsest and middle levels);
- ``build_fused_collide_then_stream`` (K6): the pair over one common ring,
  without the side output. Here that is the same kernel with
  ``coalesce=False``; its block-mapped halo fetch is a TPU tiling choice.

The CUDA kernels (``csrc/collide_then_stream.cu``) push: each voxel's
thread collides its own populations and writes population l to
x + c_l, unless the destination's own thread writes that slot (a
streaming-step BC there, a solid or kept cell, a frozen ring cell), so
every output slot has exactly one writer. The pair stages sub-step A's
outputs for its tile in shared memory, rounded to the store dtype -- so
the pair equals two single passes with the ring frozen, bit for bit.

What a sub-step computes (the reference's ``_build_cts_substep``), per
voxel x of the extended box, with periodic wrap over the box:

- f_pc(x) = BGK(f(x)); a collision-step fullway BC takes f(x)[opp l];
  cell types >= 254 keep f(x);
- f_s(x)[l] = f_pc(x - c_l)[l];
- an equilibrium BC sets its constant feq, a halfway BC reflects each
  missing l as f_pc(x)[opp l] (+ a constant moving-wall term);
- a solid (255) ends with f(x);
- with ``ring_freeze``, cells in the outer ring end with f(x).

The pair restores cells of type >= 254 to their input between the two
sub-steps (both share one explosion), rounding each intermediate to the
store dtype. Shifted storage holds g = f - w: loads add the float32
weight, stores subtract it. Ring outputs without ``ring_freeze`` are
pulled across the wrap: the stepper never reads them.
"""

import ctypes

import numpy as np
import torch

from xlb_tpu_torch.kernels import _cuda
from xlb_tpu_torch.kernels.collide_stream import (
    _equilibrium,
    _f32,
    _moments,
    f32_weights,
    kernel_bc_id,
    kernel_sfv_id,
    kernel_solid_id,
    unpack_bc_id,
)
from xlb_tpu_torch.kernels.collide_stream_dma import FusedKernel

SUPPORTED_KINDS = {"fullway", "equilibrium", "halfway"}
# the pair kernel's output tile (x, y, z): 256 threads, 4 voxels each; the
# z extent is balanced against the box (see pair_tile)
PAIR_TILE = (4, 8, 32)


def _balanced(n, t):
    """The smallest tile extent <= t that covers n in as few tiles as t."""
    tiles = -(-n // t)
    return -(-n // tiles)


def pair_tile(ext_shape):
    """The pair kernel's tile for a box: PAIR_TILE with each extent
    shrunk as far as the box's tile count allows (a 194-long z takes
    seven tiles of 28, not of 32)."""
    return tuple(_balanced(n, t) for n, t in zip(ext_shape, PAIR_TILE))


def ring_mask(shape, ring, device=None):
    """(X, Y, Z) bool: the cells within ``ring`` = (gx, gy, gz) of the box
    faces (gz = 0 leaves z out), as the reference's ``ring_freeze``."""
    out = torch.zeros(shape, dtype=torch.bool, device=device)
    for a, g in enumerate(ring):
        if g:
            lo = [slice(None)] * 3
            lo[a] = slice(0, g)
            hi = [slice(None)] * 3
            hi[a] = slice(shape[a] - g, shape[a])
            out[tuple(lo)] = True
            out[tuple(hi)] = True
    return out


def cts_substep_plain(vs, specs, fp, packed, omega):
    """One collide-then-stream sub-step on float32 unshifted populations
    ``fp`` (q, X, Y, Z); returns f_s (q, X, Y, Z), float32."""
    q, d, c, opp = vs.q, vs.d, vs._c, vs._opp_indices
    w = f32_weights(vs)
    bc = unpack_bc_id(packed, q)
    f_pre = [fp[l] for l in range(q)]
    rho, u = _moments(f_pre, c, q, d)
    feq = _equilibrium(rho, u, c, w, opp, q, d)
    f_pc = [f_pre[l] - omega * (f_pre[l] - feq[l]) for l in range(q)]
    for spec in specs:
        if spec["step"] == "collision":
            on = bc == kernel_bc_id(spec["id"], q)
            f_pc = [torch.where(on, f_pre[opp[l]], f_pc[l]) for l in range(q)]
    keep = bc >= kernel_sfv_id(q)
    f_pc = [torch.where(keep, f_pre[l], f_pc[l]) for l in range(q)]

    f_s = [torch.roll(f_pc[l], shifts=tuple(int(s) for s in c[:, l]), dims=(0, 1, 2)) for l in range(q)]
    for spec in specs:
        if spec["step"] != "streaming":
            continue
        on = bc == kernel_bc_id(spec["id"], q)
        if spec["kind"] == "equilibrium":
            f_s = [torch.where(on, float(spec["feq"][l]), f_s[l]) for l in range(q)]
        elif spec["kind"] == "halfway":
            mw = spec.get("mw")
            for l in range(q):
                refl = f_pc[opp[l]] if mw is None else f_pc[opp[l]] + _f32(mw[l])
                f_s[l] = torch.where(on & (((packed >> l) & 1) == 1), refl, f_s[l])
    solid = bc == kernel_solid_id(q)
    return torch.stack([torch.where(solid, f_pre[l], f_s[l]) for l in range(q)])


def coalesce_plain(out, ring):
    """The 2^3-child average of the core of a stored box (float32, in the
    stored form: deviations when shifted), summing x pairs, then y pairs,
    then z pairs, as the kernel does."""
    gx, gy, gz = ring
    X, Y, Z = out.shape[1:]
    v = out[:, gx : X - gx, gy : Y - gy, gz : Z - gz].float()
    v = v[:, 0::2] + v[:, 1::2]
    v = v[:, :, 0::2] + v[:, :, 1::2]
    v = v[..., 0::2] + v[..., 1::2]
    return v * 0.125


class CollideThenStream(FusedKernel):
    """One sub-step, or both finest sub-steps (``pair``), of a multires
    level over its (ring-extended) box: ``(f, mask_i32, omega) -> f_new``,
    or ``(f_new, avg)`` with ``coalesce``, where ``avg`` (float32, (q,
    X'/2, Y'/2, Z'/2) for the core X' x Y' x Z' inside ``ring``) is the
    fine->coarse average of the new core in the stored form.

    ``ring`` = (gx, gy, gz) is the ring width per axis; ``ring_freeze``
    makes ring cells end with their input. Counts: ``launches`` of every
    mode, ``pair_launches`` of the pair mode alone (the function of the
    reference's K6)."""

    launches = 0
    pair_launches = 0
    plain_calls = 0
    bc_kinds = SUPPORTED_KINDS

    def __init__(self, velocity_set, ext_shape, collision="BGK", bc_specs=(), compute_dtype=torch.float32,
                 store_dtype=torch.float32, shifted=False, pair=False, ring=(1, 1, 1), ring_freeze=False,
                 coalesce=False):
        for spec in bc_specs:
            if spec["kind"] not in SUPPORTED_KINDS:
                raise NotImplementedError(f"BC kind {spec['kind']!r} unsupported by the multires CTS kernel")
        super().__init__(velocity_set, ext_shape, collision, bc_specs, compute_dtype, store_dtype, shifted,
                         has_solids=True)
        self.pair = bool(pair)
        self.ring = tuple(int(g) for g in ring)
        self.ring_freeze = bool(ring_freeze)
        self.coalesce = bool(coalesce)
        core = [n - 2 * g for n, g in zip(self.shape, self.ring)]
        if min(core) < 1 or min(self.ring) < 0:
            raise ValueError(f"ring {self.ring} leaves no core in the box {self.shape}")
        if self.coalesce and any(n % 2 for n in core):
            raise ValueError(f"the coalesced core {tuple(core)} must have even extents")
        self.core = tuple(core)
        self.tile = pair_tile(self.shape)
        self._w = torch.tensor(f32_weights(velocity_set)).reshape(-1, 1, 1, 1)

    def _load(self, f):
        fc = f.float()
        return fc + self._w.to(fc.device) if self.shifted else fc

    def _store(self, v):
        return (v - self._w.to(v.device) if self.shifted else v).to(self.store_dtype)

    def plain(self, f, mask_i32, omega):
        CollideThenStream.plain_calls += 1
        omega = float(np.float32(omega))
        fp = self._load(f)
        fs = cts_substep_plain(self.vs, self.bc_specs, fp, mask_i32, omega)
        if self.pair:
            keep = unpack_bc_id(mask_i32, self.vs.q) >= kernel_sfv_id(self.vs.q)
            fp = self._load(torch.where(keep, self._store(fp), self._store(fs)))
            fs = cts_substep_plain(self.vs, self.bc_specs, fp, mask_i32, omega)
        if self.ring_freeze:
            fs = torch.where(ring_mask(self.shape, self.ring, fs.device), fp, fs)
        out = self._store(fs)
        return (out, coalesce_plain(out, self.ring)) if self.coalesce else out

    def __call__(self, f, mask_i32, omega):
        self._check(f, mask_i32)

        def launch(lib, stream):
            out = torch.empty_like(f)
            avg = None
            if self.coalesce:
                avg = torch.empty((self.vs.q,) + tuple(n // 2 for n in self.core), dtype=torch.float32, device=f.device)
            X, Y, Z = self.shape
            gx, gy, gz = self.ring
            TX, TY, TZ = self.tile
            err = lib.xlb_collide_then_stream(
                _cuda.STORE_KIND[self.store_dtype], int(self.shifted), int(self.pair), int(self.ring_freeze),
                int(self.coalesce), f.data_ptr(), mask_i32.data_ptr(), out.data_ptr(),
                avg.data_ptr() if avg is not None else None, X, Y, Z, gx, gy, gz, TX, TY, TZ, float(omega),
                ctypes.byref(self.params), stream,
            )
            return ((out, avg) if self.coalesce else out), err

        result = self._dispatch(f, lambda: self.plain(f, mask_i32, omega), launch)
        if self.pair and f.device.type != "cpu":
            CollideThenStream.pair_launches += 1
        return result

