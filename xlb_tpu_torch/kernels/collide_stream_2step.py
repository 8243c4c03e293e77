"""k fused LBM steps per pass over device memory: wrapper of the CUDA
k-step kernel and its plain version.

``CollideStreamKStep`` is the counterpart of
``xlb_tpu.kernels.collide_stream_2step.build_fused_collide_stream_3d_kstep``.
Its CUDA kernel (``csrc/collide_stream_3d.cuh::kstep_kernel``) replaces
that TPU kernel in its plain mode, for the configurations of the single
step (D3Q19 and D3Q27, every collision, force, halfway walls, the open
boundaries and curved walls). It computes k single steps, each rounded to
the store dtype, which is exactly what the plain version computes.

Its byte bound is one read and one write of the populations and the
mask per k steps; on the H100 it runs at 0.12-0.5 of that bound, held
back by latency more than by bytes (PERF.md). A block owns a (TY, TZ)
column of the y-z plane and marches along x over a segment of X; at
each march step sweep s computes one plane of its depth-(k - s) region
and keeps it in a ring of three planes in shared memory, from which
sweep s + 1 pulls. The recomputed halo then costs (TY + 2)(TZ + 2) / (TY TZ) in
collides and L1/L2 reads (1.33 at 8x32) where a 3D box costs 2.0-2.4, and
each segment recomputes k - 1 planes at either end. ``march_schedule``
models the march (a CPU test holds its ring reads), ``segment_length``
splits X so that the grid fills the card, and ``TILES`` gives the
column per form (``examples/performance/kstep_sweep.py`` measured them).
"""

import ctypes

import torch

from xlb_tpu_torch.kernels import _cuda
from xlb_tpu_torch.kernels.collide_stream import split_collision
from xlb_tpu_torch.kernels.collide_stream_dma import OPEN_KINDS_3D, FusedKernel

MAX_SHARED = 232448  # the 227 KB opt-in limit of one block on sm_90 (kMaxSharedBytes)
RING = 3  # planes of each sweep's ring (kKstepRing)
# (TY, TZ) at k = 2 per (q, store dtype, form: walled 0 unwalled, 1 halfway / force, 2 kExtOpen, 3 kExtHybrid),
# the sweep's fastest (kstep_sweep.py on an H100, PERF.md); the walled forms, which it does not time, take the
# column of the form whose registers and spills theirs match (D3Q19: the open one; D3Q27: the hybrid one)
TILES = {
    (19, torch.float32, 0): (6, 32), (19, torch.bfloat16, 0): (12, 32),
    (19, torch.float32, 1): (8, 32), (19, torch.bfloat16, 1): (16, 32),
    (19, torch.float32, 2): (8, 32), (19, torch.bfloat16, 2): (16, 32),
    (19, torch.float32, 3): (8, 32), (19, torch.bfloat16, 3): (16, 32),
    (27, torch.float32, 0): (8, 32), (27, torch.bfloat16, 0): (16, 32),
    (27, torch.float32, 1): (16, 32), (27, torch.bfloat16, 1): (24, 32),
    (27, torch.float32, 2): (16, 32), (27, torch.bfloat16, 2): (24, 32),
    (27, torch.float32, 3): (16, 32), (27, torch.bfloat16, 3): (24, 32),
}
# columns that differ by collision: D3Q19's other collisions take 88-117 registers where BGK takes 75-80, so two
# blocks share an SM where BGK's 6x32 fits three (kstep_sweep.py; f32 timed)
COLLISION_TILES = {
    (19, "SmagorinskyLESBGK", torch.float32, 0): (8, 32), (19, "TRT", torch.float32, 0): (8, 32),
    (19, "MRT", torch.float32, 0): (8, 32), (19, "PowerLawBGK", torch.float32, 0): (12, 32),
}
# other k: the first column whose rings leave room for two blocks on one SM (228 KB, 1 KB reserved per block)
TILE_BUDGET = 113 * 1024
TILE_CANDIDATES = ((8, 32), (4, 32), (4, 16), (2, 16), (2, 8), (1, 8))
# the longest segment of x the rule picks (kstep_sweep.py: shorter marches, more waves of blocks, ran faster)
SEGMENT_MAX = 32


def _align16(b):
    return (b + 15) & ~15


def kstep_smem_bytes(steps, tile, itemsize, q=19):
    """Dynamic shared memory of the k-step kernel on column ``tile`` =
    (TY, TZ): the rings of sweeps 1 .. k-1; mirrors ``kstep_smem_bytes``
    in ``csrc/collide_stream_3d.cuh``."""
    ty, tz = tile
    return sum(_align16(RING * q * (ty + 2 * h) * (tz + 2 * h) * itemsize) for h in range(1, steps))


def default_tile(steps, store_dtype, q=19, walled=0, collision="BGK"):
    """(TY, TZ) of a configuration: at k = 2 COLLISION_TILES' or TILES',
    else the first of TILE_CANDIDATES within TILE_BUDGET; raises when none
    fits."""
    tile = COLLISION_TILES.get((q, collision, store_dtype, walled), TILES.get((q, store_dtype, walled)))
    if steps == 2 and tile is not None:
        return tile
    for tile in TILE_CANDIDATES:
        if kstep_smem_bytes(steps, tile, store_dtype.itemsize, q) <= TILE_BUDGET:
            return tile
    raise ValueError(f"no k-step tile fits shared memory at steps={steps}, store {store_dtype}, q={q}")


def segment_length(X, columns, slots, steps):
    """Planes of x per segment. The grid has ``columns`` x ceil(X / L)
    blocks, which run in waves of ``slots`` (SMs x resident blocks per
    SM); a block takes L + 2(k - 1) march steps. The rule: of the L up to
    SEGMENT_MAX, the one whose waves x march steps is least, ties to the
    longer segment (fewer recomputed planes)."""
    best = None
    for L in range(min(X, SEGMENT_MAX), 0, -1):
        cost = -(-columns * -(-X // L) // slots) * (L + 2 * (steps - 1))
        if best is None or cost < best[0]:
            best = (cost, L)
    return best[1]


def march_schedule(X, segment, steps):
    """The march of one column as ``kstep_kernel`` runs it, for a CPU model
    of its rings. Returns, per segment, the list of its phases (the work
    between two ``__syncthreads``: one sweep's plane); a phase is (sweep s,
    unwrapped plane x, written slot of ring s or None for sweep k, reads)
    where reads is ((plane, slot of ring s - 1) for x - 1, x, x + 1),
    empty for sweep 1 (device memory)."""
    out = []
    for xa in range(0, X, segment):
        length = min(segment, X - xa)
        phases = []
        for t in range(length + 2 * (steps - 1)):
            for s in range(1, steps + 1):
                h = steps - s
                i = t - 2 * (s - 1)  # sweep s runs two march steps behind sweep s - 1
                if not 0 <= i < length + 2 * h:
                    continue
                x = xa - h + i
                reads = () if s == 1 else tuple((x - 1 + d, (i + d) % RING) for d in range(3))
                phases.append((s, x, i % RING if s < steps else None, reads))
        out.append(phases)
    return out


class CollideStreamKStep(FusedKernel):
    """``steps`` fused LBM steps: ``(f, mask_i32, omega) -> f after k steps``.
    ``tile`` = (TY, TZ) and ``segment`` (planes of x) override the table
    and the segment rule."""

    launches = 0
    plain_calls = 0
    zoo = True
    bc_kinds = OPEN_KINDS_3D
    kernel_kind = 2  # XLB_KERNEL_KSTEP

    def __init__(self, velocity_set, shape, collision="BGK", bc_specs=(), compute_dtype=torch.float32,
                 store_dtype=torch.float32, shifted=False, has_solids=True, steps=2, force_vector=None, tile=None,
                 segment=None):
        super().__init__(velocity_set, shape, collision, bc_specs, compute_dtype, store_dtype, shifted, has_solids,
                         force_vector)
        if steps < 2:
            raise ValueError(f"temporal blocking needs steps >= 2, got {steps}")
        self.steps = int(steps)
        q = velocity_set.q
        self.tile = tuple(int(t) for t in tile) if tile else default_tile(self.steps, store_dtype, q,
                                                                          self.params.walled,
                                                                          split_collision(collision)[0])
        if len(self.tile) != 2 or min(self.tile) < 1:
            raise ValueError(f"tile is (TY, TZ), got {self.tile}")
        if kstep_smem_bytes(self.steps, self.tile, store_dtype.itemsize, q) > MAX_SHARED:
            raise ValueError(f"k-step tile {self.tile} at steps={self.steps} exceeds {MAX_SHARED} B of shared memory")
        self.segment = None if segment is None else int(segment)
        self._segment = {}  # the rule's segment length per device

    def plain(self, f, mask_i32, omega, aux=None):
        """k single plain steps, each rounded to the store dtype."""
        CollideStreamKStep.plain_calls += 1
        for _ in range(self.steps):
            f = self._plain_step(f, mask_i32, omega, aux)
        return f

    def launch_shape(self, lib):
        """(resident blocks per SM, registers, local bytes per thread) of
        this configuration's kernel on the current device."""
        shape = (ctypes.c_int * 3)()
        _cuda.check(lib, lib.xlb_collide_stream_kstep_shape(
            _cuda.STORE_KIND[self.store_dtype], int(self.shifted), self.steps, *self.tile, ctypes.byref(self.params),
            shape), f"{type(self).__name__} launch shape")
        return tuple(shape)

    def segment_on(self, lib, device):
        """Planes of x per segment on ``device``: ``segment``, or the rule's."""
        if self.segment is not None:
            return self.segment
        if device not in self._segment:
            X, Y, Z = self.shape
            TY, TZ = self.tile
            columns = -(-Y // TY) * -(-Z // TZ)
            slots = torch.cuda.get_device_properties(device).multi_processor_count * self.launch_shape(lib)[0]
            if slots < 1:
                raise RuntimeError(f"{type(self).__name__}: tile {self.tile} does not fit on an SM")
            self._segment[device] = segment_length(X, columns, slots, self.steps)
        return self._segment[device]

    def _launch(self, lib, f, mask_i32, out, omega, stream, aux=None):
        X, Y, Z = self.shape
        return lib.xlb_collide_stream_kstep(
            _cuda.STORE_KIND[self.store_dtype], int(self.shifted), self.steps, f.data_ptr(), mask_i32.data_ptr(),
            out.data_ptr(), X, Y, Z, self.segment_on(lib, f.device), *self.tile, omega, _cuda.data_ptr(aux),
            ctypes.byref(self.params), stream,
        )
