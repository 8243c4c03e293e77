"""Multi-resolution incompressible Navier-Stokes stepper, the port of
``xlb_tpu.models.multires``.

Algorithm (collide-then-stream with acoustic scaling)::

    advance(level L):                       # L counts from finest = 0
        collide(L)
        explode ghosts of level L-1 from level L's post-collision state
        advance(L-1); advance(L-1)          # two fine sub-steps per coarse
        coalesce level L-1 -> refined cells of L (2^d child average)
        stream(L) + BCs, solids frozen

with ``omega_L = 2^(L+1) omega_0 / ((2^L - 1) omega_0 + 2)``. Explosion is
a piecewise-constant gather of the parent's post-collision populations
into a one-cell ghost ring around the child's box; coalescence is the
2^d-child average.

Two tiers, chosen by ``mres_perf_opt``:

- TORCH (``NAIVE_COLLIDE_STREAM``): the recursion above in plain torch
  ops, on any device.
- CUDA (``FUSION_AT_FINEST``, ``FUSION_AT_FINEST_SFV[_ALL]``): the
  reference's fused routes, which reorganise the work without changing
  the result. The finest level's two sub-steps run in one pass of the
  collide-then-stream pair kernel over its ring-extended box (ring cells
  carry cell type 254 and the parent's faces), which also emits the
  coalesced average; the coarsest level runs one single-sub-step pass
  after the average is merged in, its refined region masked with 254;
  BC-less middle levels run single passes with their ring frozen; the
  explosion faces come from collides of only the parent layers that a
  child's ring reads. The SFV routes also run every remaining per-level
  collide through the collide-only kernel. The kernels
  (``kernels/collide_then_stream.py``, ``kernels/collide_only.py``) run
  on the card for CUDA tensors and their plain versions for CPU tensors.

Route choices follow the reference and go through ``notify_fallback``:
levels whose BCs the kernels do not take stay on the TORCH tier, middle
levels with BCs run the TORCH tier's sub-steps, and a coarsest-level BC
voxel inside the refined region keeps the coarsest level off its fused
pass. ``active_finest_tier``, ``active_coarsest_tier``,
``active_mid_tiers`` and ``active_collide_levels`` say which routes run.

The port's rings are one cell wide on every axis, the least its pulls
need: a sub-step reads the ring's innermost layer only. The reference's
tile ranking and ring alignment are TPU tiling and are not carried over.
Only BGK is ported; ``step_with_force``, differentiable windows and mesh
sharding (multires over several cards) are not.
"""

import numpy as np
import torch
import torch.nn.functional as F

from xlb_tpu_torch.boundary.base import ImplementationStep
from xlb_tpu_torch.boundary.maskers import IndicesBoundaryMasker
from xlb_tpu_torch.cell_type import BC_SOLID
from xlb_tpu_torch.kernels.collide_only import LevelCollide
from xlb_tpu_torch.kernels.collide_stream import kernel_solid_id, unpack_bc_id
from xlb_tpu_torch.kernels.collide_then_stream import CollideThenStream
from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks, ring_val
from xlb_tpu_torch.mres_perf_optimization_type import MresPerfOptimizationType
from xlb_tpu_torch.operator import Operator
from xlb_tpu_torch.ops.collision import BGK
from xlb_tpu_torch.ops.equilibrium import QuadraticEquilibrium
from xlb_tpu_torch.ops.macroscopic import Macroscopic
from xlb_tpu_torch.ops.stream import stream_pull
from xlb_tpu_torch.utils.tiers import notify_fallback

_FUSED_RING = (1, 1, 1)  # ring widths of the finest and middle levels' extended boxes


def compute_omega(omega_finest, level):
    """Relaxation rate at ``level`` from the finest-level omega (acoustic
    scaling)."""
    w0 = omega_finest
    return 2.0 ** (level + 1) * w0 / ((2.0**level - 1.0) * w0 + 2.0)


def _f32(x):
    return float(np.float32(x))


def _interior(ring):
    return (slice(None),) + tuple(slice(g, -g) if g else slice(None) for g in ring)


def _pad(x, ring, value=0):
    """Pad the spatial axes of ``x`` ((c, *s) or (*s)) by ``ring`` cells."""
    pads = []
    for g in reversed(ring):
        pads += [g, g]
    return F.pad(x, tuple(pads), value=value)


class MultiresIncompressibleNavierStokesStepper(Operator):
    """Dense multi-level LBM stepper.

    Parameters
    ----------
    grid : MultiresGrid
    boundary_conditions : dict level -> list of BCs, or a list (applied to
        the coarsest level, where domain walls live)
    collision_type : {"BGK"}
    mres_perf_opt : MresPerfOptimizationType
        ``NAIVE_COLLIDE_STREAM`` (the TORCH tier, default) or one of the
        fused routes (the CUDA tier).
    """

    def __init__(self, grid, boundary_conditions=None, collision_type="BGK", mres_perf_opt=None, velocity_set=None,
                 precision_policy=None, compute_backend=None):
        super().__init__(velocity_set, precision_policy, compute_backend)
        if collision_type != "BGK":
            raise NotImplementedError(
                f"multires collision_type {collision_type!r} is not ported yet: KBC and SmagorinskyLESBGK on "
                "multires are not ported yet (only BGK)"
            )
        self.grid = grid
        self.collision_type = collision_type
        common = dict(velocity_set=self.velocity_set, precision_policy=self.precision_policy,
                      compute_backend=self.compute_backend)
        self.collision = BGK(**common)
        self.equilibrium = QuadraticEquilibrium(**common)
        self.macroscopic = Macroscopic(**common)

        if boundary_conditions is None:
            boundary_conditions = {}
        if isinstance(boundary_conditions, (list, tuple)):
            boundary_conditions = {grid.num_levels - 1: list(boundary_conditions)}
        self.boundary_conditions = {int(k): list(v) for k, v in boundary_conditions.items()}

        L = grid.num_levels
        self._gather_cache = {}
        self._w_cache = {}
        if mres_perf_opt is None:
            mres_perf_opt = MresPerfOptimizationType.NAIVE_COLLIDE_STREAM
        self.mres_perf_opt = mres_perf_opt
        self._fused_collide = [None] * L
        self._cts = None  # the finest level's pair
        self._cts_ring = _FUSED_RING
        self._cts_shifted = False  # deviation-form (g = f - w) storage on the fused routes
        self._cts_coarse = None  # the coarsest level's single sub-step
        self._cts_mid = [None] * L  # the middle levels' single sub-steps
        self._mid_ring = [None] * L
        self._pending_mid_avg = {}  # level -> the average its last kernel pass emitted
        self._coarse_fused_ok = None  # the host-side BC-placement gate, evaluated once
        self.active_finest_tier = "torch"
        self.active_coarsest_tier = "torch"
        self.active_mid_tiers = {level: "torch" for level in range(1, L - 1)}
        self.active_collide_levels = ()
        if mres_perf_opt == MresPerfOptimizationType.FUSION_AT_FINEST:
            fused_levels = ()
            self._build_cts_finest()
        elif mres_perf_opt in (MresPerfOptimizationType.FUSION_AT_FINEST_SFV,
                               MresPerfOptimizationType.FUSION_AT_FINEST_SFV_ALL):
            fused_levels = tuple(range(1, L))
            self._build_cts_finest()
        else:
            fused_levels = ()
        if self._cts is not None:
            self._build_cts_coarsest()
            self._build_cts_mid()
        if fused_levels:
            self._build_fused_collides(fused_levels)

    # ------------------------------------------------------------------
    # Route construction
    # ------------------------------------------------------------------
    def _specs(self, level):
        return [bc_to_spec(bc, self.velocity_set) for bc in self.boundary_conditions.get(level, [])]

    def _cts_kwargs(self):
        pp = self.precision_policy
        return dict(collision=self.collision_type, compute_dtype=pp.compute_dtype, store_dtype=pp.store_dtype,
                    shifted=self._cts_shifted)

    def _build_cts_finest(self):
        """Both finest sub-steps of a coarse step in one pass of the pair
        kernel, with the coalesced average as its side output."""
        if self.grid.dim != 3 or self.grid.num_levels < 2:
            notify_fallback("multires fused routes are 3-D with at least two levels; this grid runs the TORCH tier")
            return
        # 16-bit storage runs in deviation form (g = f - w)
        self._cts_shifted = self.precision_policy.store_dtype.itemsize < 4
        shape = self.grid.levels[0].shape
        try:
            self._cts = CollideThenStream(
                self.velocity_set, tuple(s + 2 * g for s, g in zip(shape, self._cts_ring)), bc_specs=self._specs(0),
                ring=self._cts_ring, pair=True, ring_freeze=True, coalesce=True, **self._cts_kwargs(),
            )
        except (NotImplementedError, ValueError) as e:
            notify_fallback(f"multires finest level stays on the TORCH tier: {e}")
            return
        self.active_finest_tier = f"cts_pair ring {self._cts_ring} +coalesce" + (" shifted" if self._cts_shifted else "")

    def _build_cts_coarsest(self):
        """One single-sub-step pass for the coarsest level: collide (the
        refined region masked 254 keeps its merged average), stream over
        the periodic box, BCs, solid freeze."""
        L = self.grid.num_levels - 1
        try:
            self._cts_coarse = CollideThenStream(
                self.velocity_set, self.grid.levels[L].shape, bc_specs=self._specs(L), ring=(0, 0, 0), pair=False,
                **self._cts_kwargs(),
            )
        except (NotImplementedError, ValueError) as e:
            notify_fallback(f"multires coarsest level stays on the TORCH tier: {e}")
            return
        self.active_coarsest_tier = "cts_single" + (" shifted" if self._cts_shifted else "")

    def _build_cts_mid(self):
        """Single-sub-step passes for the BC-less middle levels, over their
        ring-extended boxes with the ring frozen and the coalesced average
        as the side output. A middle level with BCs runs the TORCH tier's
        sub-steps (a BC inside the 254-masked ring or refined region
        would be skipped), without blocking the levels around it."""
        for level in range(1, self.grid.num_levels - 1):
            if self.boundary_conditions.get(level, []):
                notify_fallback(f"multires middle level {level} has BCs: its sub-steps stay on the TORCH tier")
                continue
            shape = self.grid.levels[level].shape
            self._cts_mid[level] = CollideThenStream(
                self.velocity_set, tuple(s + 2 * g for s, g in zip(shape, _FUSED_RING)), bc_specs=[], ring=_FUSED_RING,
                pair=False, ring_freeze=True, coalesce=True, **self._cts_kwargs(),
            )
            self._mid_ring[level] = _FUSED_RING
            self.active_mid_tiers[level] = "cts_single ring (1, 1, 1) +coalesce" + (" shifted" if self._cts_shifted else "")

    def _build_fused_collides(self, levels):
        fused = []
        for l in levels:
            try:
                self._fused_collide[l] = LevelCollide(self.velocity_set, self.grid.levels[l].shape,
                                                      collision=self.collision_type, bc_specs=self._specs(l),
                                                      compute_dtype=self.precision_policy.compute_dtype)
                fused.append(l)
            except NotImplementedError as e:
                notify_fallback(f"multires level {l}'s collide stays on the TORCH tier: {e}")
        self.active_collide_levels = tuple(fused)

    # ------------------------------------------------------------------
    # Setup
    # ------------------------------------------------------------------
    def prepare_fields(self):
        """Per-level (f_0, f_1, bc_mask, missing_mask) lists, finest first,
        on the grid's device."""
        fs0, fs1, bms, mms = [], [], [], []
        vs, pp = self.velocity_set, self.precision_policy
        for l, lvl in enumerate(self.grid.levels):
            bc_mask = lvl.create_field(1, dtype=torch.uint8)
            missing = lvl.create_field(vs.q, dtype=torch.bool)
            bcs = self.boundary_conditions.get(l, [])
            missing_idx = [type(bc).__name__ for bc in bcs if bc.indices is None]
            if missing_idx:
                raise NotImplementedError(
                    f"mesh BCs per level (BCs without voxel indices) on multires are not ported yet: {missing_idx}"
                )
            if bcs:
                masker = IndicesBoundaryMasker(vs, pp, self.compute_backend)
                bc_mask, missing = masker(bcs, bc_mask, missing)
            feq0 = self.equilibrium(
                torch.ones((1,) + lvl.shape, dtype=pp.compute_dtype, device=lvl.device),
                torch.zeros((vs.d,) + lvl.shape, dtype=pp.compute_dtype, device=lvl.device),
            ).to(pp.store_dtype)
            fs0.append(feq0)
            fs1.append(feq0.clone())
            bms.append(bc_mask)
            mms.append(missing)
        return fs0, fs1, bms, mms

    # ------------------------------------------------------------------
    # Building blocks
    # ------------------------------------------------------------------
    def _omega(self, omega_finest, level):
        return _f32(compute_omega(float(omega_finest), level))

    def _w_col(self, device):
        """Lattice weights as a compute-dtype (q, 1, 1[, 1]) column."""
        key = torch.device(device)
        if key not in self._w_cache:
            w = torch.as_tensor(np.asarray(self.velocity_set._w, dtype=np.float64)).to(self.precision_policy.compute_dtype)
            self._w_cache[key] = w.reshape((-1,) + (1,) * self.grid.dim).to(key)
        return self._w_cache[key]

    def _collide(self, f, omega):
        rho, u = self.macroscopic(f)
        return self.collision(f, self.equilibrium(rho, u), omega)

    def _collide_with_bcs(self, level, f, bm, mm, omega):
        """Collision phase of one sub-step: the collide-only kernel on the
        SFV routes, the TORCH tier otherwise."""
        fused = self._fused_collide[level]
        if fused is not None:
            return fused(f.contiguous(), pack_masks(bm, mm), omega)
        return self._apply_bcs(ImplementationStep.COLLISION, level, f, self._collide(f, omega), bm, mm)

    def _apply_bcs(self, step, level, f_pre, f_post, bc_mask, missing_mask):
        for bc in self.boundary_conditions.get(level, []):
            if bc.implementation_step == step:
                f_post = bc(f_pre, f_post, bc_mask, missing_mask)
        return f_post

    def _freeze_solids(self, level, f_before, f_after, bms):
        """Voxels tagged 255 end the sub-step unchanged."""
        if not self.boundary_conditions.get(level, []):
            return f_after
        return torch.where(bms[level] == BC_SOLID, f_before, f_after)

    def _gather_maps(self, level, ring, host=False):
        """Per axis: every cell of the fine level's ring-extended box -> the
        parent cell containing it, as index tensors on the grid's device
        (NumPy arrays with ``host``; built once, so the hot loop never
        copies indices between host and card)."""
        ring = (ring,) * self.grid.dim if np.isscalar(ring) else tuple(ring)
        key = (level, ring)
        if key not in self._gather_cache:
            lvl = self.grid.levels[level]
            parent_shape = self.grid.levels[level + 1].shape
            maps = []
            for d in range(self.grid.dim):
                fine = np.arange(-ring[d], lvl.shape[d] + ring[d])
                idx = lvl.origin_in_parent[d] + np.floor((fine + 0.5) / 2.0).astype(np.int64)
                maps.append(np.clip(idx, 0, parent_shape[d] - 1))
            self._gather_cache[key] = (maps, [torch.as_tensor(m, device=lvl.device) for m in maps])
        return self._gather_cache[key][0 if host else 1]

    def _face_layers(self, child, ring, axis):
        """The parent layers along ``axis`` that the child's innermost ring
        layer reads, as (ring positions, index tensor on the device)."""
        ring = tuple(ring)
        key = ("faces", child, ring, axis)
        if key not in self._gather_cache:
            m = self._gather_maps(child, ring, host=True)[axis]
            positions = (ring[axis] - 1, len(m) - ring[axis])
            layers = torch.as_tensor([int(m[pos]) for pos in positions], device=self.grid.levels[child].device)
            self._gather_cache[key] = (positions, layers)
        return self._gather_cache[key]

    def _explode(self, f_coarse, level):
        """The parent's populations on the fine level's one-cell-extended
        box (piecewise-constant upsampling)."""
        out = f_coarse
        for axis, idx in enumerate(self._gather_maps(level, 1)):
            out = torch.index_select(out, axis + 1, idx)
        return out

    def _stream_with_ghosts(self, f_post_collision, ghost_ext, level):
        """Pull-stream a fine level through its ghost-extended box."""
        interior = _interior((1,) * self.grid.dim)
        ext = ghost_ext.clone()
        ext[interior] = f_post_collision
        return stream_pull(ext, self.velocity_set._c)[interior]

    def _coalesce_avg(self, f_fine, level_fine):
        """The 2^d-child average: pairs summed along x, then y, then z."""
        d = self.grid.dim
        avg = f_fine
        for a in range(d):
            s0 = [slice(None)] * (d + 1)
            s1 = [slice(None)] * (d + 1)
            s0[a + 1] = slice(0, None, 2)
            s1[a + 1] = slice(1, None, 2)
            avg = avg[tuple(s0)] + avg[tuple(s1)]
        return avg * (0.5**d)

    def _avg_from_out2(self, out2):
        """The coalesced average a kernel emitted (stored form) in the
        compute dtype, unshifted."""
        return out2 + self._w_col(out2.device) if self._cts_shifted else out2

    def _child_avg(self, fs, child, ext_state, shifted_state, mid_ext=False):
        """The child level's fine->coarse average: the one its last kernel
        pass emitted, or the TORCH tier's."""
        out2 = self._pending_mid_avg.pop(child, None)
        if out2 is not None:
            return self._avg_from_out2(out2)
        return self._coalesce_avg(self._fine_for_avg(fs, child, ext_state, shifted_state, mid_ext), child)

    def _merge_box(self, dst, src, lows, keep=None):
        """A copy of ``dst`` with ``src`` written at offsets ``lows``;
        ``keep`` (bool over the box, broadcast on dim 0) keeps dst."""
        out = dst.clone()
        box = (slice(None),) + tuple(slice(lo, lo + n) for lo, n in zip(lows, src.shape[1:]))
        src = src.to(dst.dtype)
        out[box] = src if keep is None else torch.where(keep, dst[box], src)
        return out

    def _coalesce_from_avg(self, f_coarse, avg, level_fine):
        return self._merge_box(f_coarse, avg, self.grid.levels[level_fine].origin_in_parent)

    def _fully_refined_fast(self, level):
        """True when ``level`` is wholly covered by its child, so its bulk
        collide is overwritten by the coalescence and only the explosion
        faces need collided values."""
        if level == 0:
            return False
        if self.grid.levels[level - 1].extent_in_parent != self.grid.levels[level].shape:
            return False
        return not any(bc.implementation_step == ImplementationStep.COLLISION
                       for bc in self.boundary_conditions.get(level, []))

    def _collide_face_slab(self, level, f, bms, mms, omega, axis, sel):
        """Post-collision populations of the parent layers ``sel`` (an index
        tensor) along ``axis``: the only coarse cells a child's ghost
        explosion reads."""
        f_slab = torch.index_select(f, axis + 1, sel)
        f_pc = self._collide(f_slab, omega)
        bcs = self.boundary_conditions.get(level, [])
        if bcs:
            bm_s = torch.index_select(bms[level], axis + 1, sel)
            mm_s = torch.index_select(mms[level], axis + 1, sel)
            for bc in bcs:
                if bc.implementation_step == ImplementationStep.COLLISION:
                    f_pc = bc(f_slab, f_pc, bm_s, mm_s)
            f_pc = torch.where(bm_s == BC_SOLID, f_slab, f_pc)
        return f_pc

    def _explode_faces_lazy(self, level_parent, f, bms, mms, omega, child, ring, for_kernel=True):
        """The ring's innermost face slabs without a full parent collide:
        collide only the <= 2d parent layers the ring reads. ``for_kernel``
        emits them in the kernel box's stored form (deviations when
        shifted); otherwise in the compute dtype. Returns [(index, slab)]."""
        maps = self._gather_maps(child, ring)
        d = self.grid.dim
        dtype = self.precision_policy.store_dtype if for_kernel else self.precision_policy.compute_dtype
        faces = []
        for axis in range(d):
            positions, layers = self._face_layers(child, ring, axis)
            slab2 = self._collide_face_slab(level_parent, f, bms, mms, omega, axis, layers)
            for a in range(d):
                if a != axis:
                    slab2 = torch.index_select(slab2, a + 1, maps[a])
            if for_kernel and self._cts_shifted:
                slab2 = slab2 - self._w_col(slab2.device)
            slab2 = slab2.to(dtype)
            for side, pos in enumerate(positions):
                sl = [slice(None)] * (d + 1)
                sl[axis + 1] = slice(side, side + 1)
                idx = [0] * (d + 1)
                idx[axis + 1] = pos
                faces.append((tuple(idx), slab2[tuple(sl)]))
        return faces

    def _explode_ring_faces(self, parent_pc, level, ring, dtype):
        """The ring's innermost layer gathered from a bulk-collided parent,
        as 2d depth-1 face slabs."""
        maps = self._gather_maps(level, ring)
        d = self.grid.dim
        faces = []
        for axis in range(d):
            for pos in (ring[axis] - 1, len(maps[axis]) - ring[axis]):
                slab = torch.index_select(parent_pc, axis + 1, maps[axis][pos : pos + 1])
                for a in range(d):
                    if a != axis:
                        slab = torch.index_select(slab, a + 1, maps[a])
                idx = [0] * (d + 1)
                idx[axis + 1] = pos
                if self._cts_shifted:
                    slab = slab - self._w_col(slab.device)
                faces.append((tuple(idx), slab.to(dtype)))
        return faces

    @staticmethod
    def _overlay_faces(ext, faces):
        """Write the face slabs into the extended box, in place (the box is
        the stepper's own carry)."""
        for idx, slab in faces:
            axis = next(a for a in range(1, ext.ndim) if slab.shape[a] == 1)
            sl = [slice(None)] * ext.ndim
            sl[axis] = slice(idx[axis], idx[axis] + 1)
            ext[tuple(sl)] = slab.to(ext.dtype)
        return ext

    def _fine_for_avg(self, fs, child, ext_state, shifted_state, mid_ext=False):
        """The child level's populations in the compute dtype, unshifted,
        ready for the TORCH tier's coalescence average."""
        pp = self.precision_policy
        f_fine = fs[child]
        shifted = False
        if child == 0 and ext_state:
            f_fine = f_fine[_interior(self._cts_ring)]
            shifted = self._cts_shifted
        elif child > 0:
            shifted = shifted_state
            if mid_ext and self._cts_mid[child] is not None:
                f_fine = f_fine[_interior(self._mid_ring[child])]
                shifted = self._cts_shifted
        f = pp.cast_to_compute(f_fine)
        return f + self._w_col(f.device) if shifted else f

    # ------------------------------------------------------------------
    # Masks of the fused routes
    # ------------------------------------------------------------------
    def _box_slices(self, level_fine, offset=(0, 0, 0)):
        lvl = self.grid.levels[level_fine]
        return tuple(slice(o + g, o + g + e) for o, e, g in zip(lvl.origin_in_parent, lvl.extent_in_parent, offset))

    def _fine_mask_ext(self, bms, mms):
        """Packed mask of the finest level's extended box: ring cells 254."""
        return _pad(pack_masks(bms[0], mms[0]), self._cts_ring, ring_val(self.velocity_set.q)).contiguous()

    def _mid_mask_ext(self, level, bms, mms):
        """Packed mask of a middle level's extended box: the ring and the
        refined region are 254 (BC-less levels only)."""
        packed = pack_masks(bms[level], mms[level])
        packed[self._box_slices(level - 1)] = ring_val(self.velocity_set.q)
        return _pad(packed, self._mid_ring[level], ring_val(self.velocity_set.q)).contiguous()

    def _coarse_mask_packed(self, bms, mms):
        """Packed mask of the coarsest level, its refined region 254 (solid
        voxels keep 255: the kernel's freeze matches _freeze_solids)."""
        L = self.grid.num_levels - 1
        q = self.velocity_set.q
        packed = pack_masks(bms[L], mms[L])
        slc = self._box_slices(L - 1)
        box = packed[slc]
        packed[slc] = torch.where(unpack_bc_id(box, q) == kernel_solid_id(q), box, torch.full_like(box, ring_val(q)))
        return packed.contiguous()

    def _coarse_bc_placement_ok(self):
        """True when no coarsest-level BC voxel lies inside the refined
        region (the fused coarse pass masks it 254, which would skip a BC
        there). BCs that need padding are tagged at their dilated shell, so
        that shell is tested. Evaluated once."""
        if self._coarse_fused_ok is None:
            L = self.grid.num_levels - 1
            lvl_c = self.grid.levels[L - 1]
            lo = np.asarray(lvl_c.origin_in_parent)
            hi = lo + np.asarray(lvl_c.extent_in_parent)
            ok = True
            for bc in self.boundary_conditions.get(L, []):
                idx = np.asarray(bc.pad_indices())
                if np.all((idx >= lo[:, None]) & (idx < hi[:, None]), axis=0).any():
                    ok = False
                    break
            if not ok:
                notify_fallback(
                    "multires coarsest level stays on the TORCH tier: a BC voxel lies inside the refined region "
                    "(the fused pass masks it as cell type 254)"
                )
                self.active_coarsest_tier = "torch (a coarse BC voxel inside the refined region)"
            self._coarse_fused_ok = ok
        return self._coarse_fused_ok

    # ------------------------------------------------------------------
    # The recursion
    # ------------------------------------------------------------------
    def _coarse_fused_step(self, level, fs, avg, bms, mms, omega, shifted_state, mask_coarse):
        """Finish a coarsest-level step in one pass: merge the average into
        the stored state (solid voxels keep theirs) and run the
        single-sub-step kernel."""
        pp = self.precision_policy
        slc = self._box_slices(level - 1)
        w = self._w_col(avg.device)
        if self._cts_shifted:
            avg_s = (avg - w).to(pp.store_dtype)
            state_in = fs[level] if shifted_state else (pp.cast_to_compute(fs[level]) - w).to(pp.store_dtype)
        else:
            avg_s = avg.to(pp.store_dtype)
            state_in = pp.cast_to_store(fs[level])
        solid = (bms[level][(0,) + slc] == BC_SOLID)[None]
        merged = self._merge_box(state_in, avg_s, tuple(s.start for s in slc), keep=solid)
        mask_c = mask_coarse if mask_coarse is not None else self._coarse_mask_packed(bms, mms)
        out = self._cts_coarse(merged, mask_c, omega)
        if self._cts_shifted and not shifted_state:
            out = pp.cast_to_compute(out) + w
        fs = list(fs)
        fs[level] = out
        return fs

    def _advance(self, level, fs, bms, mms, omega_finest, ext_state=False, mask_ext=None, shifted_state=False,
                 mask_coarse=None, mask_mid=None, mid_ext=False):
        """Advance ``level`` by one of its own steps; a coarsest-level
        advance starts and ends with no average pending."""
        if level == self.grid.num_levels - 1:
            self._pending_mid_avg = {}
            out = self._advance_impl(level, fs, bms, mms, omega_finest, ext_state, mask_ext, shifted_state,
                                     mask_coarse, mask_mid, mid_ext)
            assert not self._pending_mid_avg, f"averages of levels {sorted(self._pending_mid_avg)} were never merged"
            return out
        return self._advance_impl(level, fs, bms, mms, omega_finest, ext_state, mask_ext, shifted_state, mask_coarse,
                                  mask_mid, mid_ext)

    def _advance_impl(self, level, fs, bms, mms, omega_finest, ext_state=False, mask_ext=None, shifted_state=False,
                      mask_coarse=None, mask_mid=None, mid_ext=False):
        """One step of ``level`` (recursively two sub-steps of each finer
        level). ``ext_state``/``mask_ext``: the finest state stays
        ring-extended (build_window); ``shifted_state``: coarser states
        live in deviation form between sub-steps; ``mask_coarse`` /
        ``mask_mid``: masks the window builds once."""
        pp = self.precision_policy
        omega = self._omega(omega_finest, level)
        f = pp.cast_to_compute(fs[level])
        if shifted_state and level > 0:
            f = f + self._w_col(f.device)
        child = level - 1
        fused_coarse = level > 0 and self._cts_coarse is not None and self._coarse_bc_placement_ok()
        if fused_coarse:
            if child == 0 and self._cts is not None:
                faces = self._explode_faces_lazy(level, f, bms, mms, omega, child, self._cts_ring)
                fs, out2 = self._cts_fine_pair(fs, bms, mms, omega_finest, None, ext_state, mask_ext, faces)
                avg = self._avg_from_out2(out2)
            elif self._cts_mid[child] is not None:
                ghost_faces = self._explode_faces_lazy(level, f, bms, mms, omega, child, self._mid_ring[child])
                fs = self._advance_mid_fused(child, fs, bms, mms, omega_finest, ghost_faces, ext_state, mask_ext,
                                             shifted_state, mask_mid, mid_ext)
                avg = self._child_avg(fs, child, ext_state, shifted_state, mid_ext)
            else:
                fs = self._advance_child_from_faces(level, f, fs, bms, mms, omega, omega_finest, ext_state, mask_ext,
                                                    shifted_state, mask_mid, mid_ext)
                avg = self._coalesce_avg(self._fine_for_avg(fs, child, ext_state, shifted_state, mid_ext), child)
            return self._coarse_fused_step(level, fs, avg, bms, mms, omega, shifted_state, mask_coarse)

        fast_full = self._fully_refined_fast(level) and child == 0 and self._cts is not None
        if fast_full:
            # every coarse cell is overwritten by the coalescence: only the
            # explosion faces need collided values
            faces = self._explode_faces_lazy(level, f, bms, mms, omega, child, self._cts_ring)
            fs, out2 = self._cts_fine_pair(fs, bms, mms, omega_finest, None, ext_state, mask_ext, faces)
            f_pc = self._avg_from_out2(out2)
        else:
            f_pc = self._collide_with_bcs(level, f, bms[level], mms[level], omega)
            f_pc = self._freeze_solids(level, f, f_pc, bms)
        if level > 0 and not fast_full:
            fs, out2 = self._advance_children(level, fs, bms, mms, omega_finest, f_pc, ext_state, mask_ext,
                                              shifted_state, mask_mid, mid_ext)
            avg = self._avg_from_out2(out2) if out2 is not None else self._child_avg(fs, child, ext_state,
                                                                                      shifted_state, mid_ext)
            f_pc = self._coalesce_from_avg(f_pc, avg, child)

        f_ps = stream_pull(f_pc, self.velocity_set._c)
        f_ps = self._apply_bcs(ImplementationStep.STREAMING, level, f_pc, f_ps, bms[level], mms[level])
        f_ps = self._freeze_solids(level, f, f_ps, bms)
        fs = list(fs)
        if shifted_state and level > 0:
            f_ps = f_ps - self._w_col(f_ps.device)
        fs[level] = pp.cast_to_store(f_ps)
        return fs

    def _advance_child_from_faces(self, level, f, fs, bms, mms, omega, omega_finest, ext_state, mask_ext,
                                  shifted_state, mask_mid, mid_ext):
        """A TORCH-tier child against lazily collided faces: its ring only
        ever reads the innermost ghost layer, so a zero ghost box overlaid
        with the faces replaces the explosion of a bulk-collided parent."""
        child = level - 1
        faces = self._explode_faces_lazy(level, f, bms, mms, omega, child, (1,) * self.grid.dim, for_kernel=False)
        ghost_ext = torch.zeros((self.velocity_set.q,) + tuple(s + 2 for s in self.grid.levels[child].shape),
                                dtype=self.precision_policy.compute_dtype, device=f.device)
        ghost_ext = self._overlay_faces(ghost_ext, faces)
        return self._advance_fine_pair(child, fs, bms, mms, omega_finest, ghost_ext, ext_state, mask_ext,
                                       shifted_state, mask_mid=mask_mid, mid_ext=mid_ext)

    def _advance_children(self, level, fs, bms, mms, omega_finest, f_pc, ext_state=False, mask_ext=None,
                          shifted_state=False, mask_mid=None, mid_ext=False):
        """The two sub-steps of ``level - 1`` against this level's
        post-collision state. Returns (fs, the child's average or None)."""
        child = level - 1
        if child == 0 and self._cts is not None:
            return self._cts_fine_pair(fs, bms, mms, omega_finest, f_pc, ext_state, mask_ext)
        if self._cts_mid[child] is not None:
            ghost_faces = self._explode_ring_faces(f_pc, child, self._mid_ring[child], self.precision_policy.store_dtype)
            return self._advance_mid_fused(child, fs, bms, mms, omega_finest, ghost_faces, ext_state, mask_ext,
                                           shifted_state, mask_mid, mid_ext), None
        ghost_ext = self._explode(f_pc, child)
        return self._advance_fine_pair(child, fs, bms, mms, omega_finest, ghost_ext, ext_state, mask_ext,
                                       shifted_state, mask_mid=mask_mid, mid_ext=mid_ext), None

    def _cts_fine_pair(self, fs, bms, mms, omega_finest, parent_pc, ext_state=False, mask_ext=None, faces=None):
        """Both finest sub-steps of a coarse step in one pass of the pair
        kernel over the ring-extended state, whose ring carries the
        parent's faces. With ``ext_state`` ``fs[0]`` is already the
        extended box and stays so. Returns (fs, the coalesced average)."""
        pp = self.precision_policy
        g = self._cts_ring
        omega = self._omega(omega_finest, 0)
        if mask_ext is None:
            mask_ext = self._fine_mask_ext(bms, mms)
        if ext_state:
            ext = fs[0]
        else:
            f0 = fs[0]
            if self._cts_shifted:
                f0 = (pp.cast_to_compute(f0) - self._w_col(f0.device)).to(pp.store_dtype)
            ext = _pad(pp.cast_to_store(f0), g).contiguous()
        if faces is None:
            faces = self._explode_ring_faces(parent_pc, 0, g, pp.store_dtype)
        ext, out2 = self._cts(self._overlay_faces(ext, faces), mask_ext, omega)
        fs = list(fs)
        if ext_state:
            fs[0] = ext
        else:
            f0 = ext[_interior(g)]
            # unshift into the compute dtype: re-quantizing f = g + w to 16
            # bits would erase the deviations
            fs[0] = pp.cast_to_compute(f0) + self._w_col(f0.device) if self._cts_shifted else f0
        return fs, out2

    def _advance_mid_fused(self, level, fs, bms, mms, omega_finest, ghost_faces, ext_state, mask_ext, shifted_state,
                           mask_mid=None, mid_ext=False):
        """Both sub-steps of a fused middle level: per sub-step the child
        advances against lazily collided faces, its average merges into
        the ring-extended carry, and one kernel pass collides and streams
        the box. The parent's faces are overlaid once (the ring is frozen).
        With ``mid_ext`` ``fs[level]`` is already the extended box in the
        stored form and stays so."""
        pp = self.precision_policy
        omega = self._omega(omega_finest, level)
        child = level - 1
        g = self._mid_ring[level]
        mask_m = mask_mid[level] if mask_mid is not None else None
        if mask_m is None:
            mask_m = self._mid_mask_ext(level, bms, mms)
        slc_ext = self._box_slices(child, g)
        if mid_ext:
            ext_m = fs[level]
        else:
            if self._cts_shifted:
                state_in = fs[level] if shifted_state else (
                    pp.cast_to_compute(fs[level]) - self._w_col(fs[level].device)).to(pp.store_dtype)
            else:
                state_in = pp.cast_to_store(fs[level])
            ext_m = _pad(state_in, g).contiguous()
        ext_m = self._overlay_faces(ext_m, ghost_faces)
        m_out2 = None
        for _ in range(2):
            f = pp.cast_to_compute(ext_m[_interior(g)])
            if self._cts_shifted:
                f = f + self._w_col(f.device)
            if child == 0 and self._cts is not None:
                child_faces = self._explode_faces_lazy(level, f, bms, mms, omega, child, self._cts_ring)
                fs, out2 = self._cts_fine_pair(fs, bms, mms, omega_finest, None, ext_state, mask_ext, child_faces)
            elif self._cts_mid[child] is not None:
                child_faces = self._explode_faces_lazy(level, f, bms, mms, omega, child, self._mid_ring[child])
                fs = self._advance_mid_fused(child, fs, bms, mms, omega_finest, child_faces, ext_state, mask_ext,
                                             shifted_state, mask_mid, mid_ext)
                out2 = None
            else:
                fs = self._advance_child_from_faces(level, f, fs, bms, mms, omega, omega_finest, ext_state, mask_ext,
                                                    shifted_state, mask_mid, mid_ext)
                out2 = None
            avg = self._avg_from_out2(out2) if out2 is not None else self._child_avg(fs, child, ext_state,
                                                                                      shifted_state, mid_ext)
            # stored-form merge of the refined region; the level is BC-less,
            # so there are no solids to skip
            w = self._w_col(avg.device)
            avg_s = ((avg - w) if self._cts_shifted else avg).to(pp.store_dtype)
            ext_m = self._merge_box(ext_m, avg_s, tuple(s.start for s in slc_ext))
            ext_m, m_out2 = self._cts_mid[level](ext_m, mask_m, omega)
        # the last sub-step's average, for the parent's coalescence
        self._pending_mid_avg[level] = m_out2
        fs = list(fs)
        if mid_ext:
            fs[level] = ext_m
        else:
            out = ext_m[_interior(g)]
            if self._cts_shifted and not shifted_state:
                out = pp.cast_to_compute(out) + self._w_col(out.device)
            fs[level] = out
        return fs

    def _advance_fine_pair(self, level, fs, bms, mms, omega_finest, ghost_ext, ext_state=False, mask_ext=None,
                           shifted_state=False, ghost_faces=None, mask_mid=None, mid_ext=False):
        """Two TORCH-tier sub-steps of ``level`` through the parent's ghost
        box (or the fused middle route when ``ghost_faces`` are given)."""
        pp = self.precision_policy
        omega = self._omega(omega_finest, level)
        if ghost_faces is not None:
            return self._advance_mid_fused(level, fs, bms, mms, omega_finest, ghost_faces, ext_state, mask_ext,
                                           shifted_state, mask_mid, mid_ext)
        for _ in range(2):
            f = pp.cast_to_compute(fs[level])
            if shifted_state and level > 0:
                f = f + self._w_col(f.device)
            f_pc = self._collide_with_bcs(level, f, bms[level], mms[level], omega)
            f_pc = self._freeze_solids(level, f, f_pc, bms)
            if level > 0:
                fs, out2 = self._advance_children(level, fs, bms, mms, omega_finest, f_pc, ext_state, mask_ext,
                                                  shifted_state, mask_mid, mid_ext)
                avg = self._avg_from_out2(out2) if out2 is not None else self._child_avg(fs, level - 1, ext_state,
                                                                                          shifted_state, mid_ext)
                f_pc = self._coalesce_from_avg(f_pc, avg, level - 1)
            f_ps = self._stream_with_ghosts(f_pc, ghost_ext, level)
            f_ps = self._apply_bcs(ImplementationStep.STREAMING, level, f_pc, f_ps, bms[level], mms[level])
            f_ps = self._freeze_solids(level, f, f_ps, bms)
            fs = list(fs)
            if shifted_state and level > 0:
                f_ps = f_ps - self._w_col(f_ps.device)
            fs[level] = pp.cast_to_store(f_ps)
        return fs

    # ------------------------------------------------------------------
    # Entry points
    # ------------------------------------------------------------------
    def __call__(self, fs, bms, mms, omega_finest):
        """One coarsest-level step (2^(L-1) finest steps). Returns the new
        per-level population list."""
        return self._advance(self.grid.num_levels - 1, list(fs), bms, mms, omega_finest)

    def build_window(self, num_coarse_steps):
        """A ``num_coarse_steps``-coarse-step advance:
        ``run(fs, bms, mms, omega_finest) -> fs``.

        On the fused routes the finest and fused middle states stay
        ring-extended across the window (one pad before, one crop after)
        and the packed masks are built once. Under a 16-bit policy every
        state lives in deviation form during the window and comes back
        unshifted in the compute dtype (re-quantizing f = g + w would
        erase small deviations)."""
        L = self.grid.num_levels
        if self._cts is None or L < 2:
            def run_plain(fs, bms, mms, omega_finest):
                fs = list(fs)
                for _ in range(num_coarse_steps):
                    fs = self._advance(L - 1, fs, bms, mms, omega_finest)
                return fs

            return run_plain

        pp = self.precision_policy
        shifted = self._cts_shifted

        def run_ext(fs, bms, mms, omega_finest):
            mask_ext = self._fine_mask_ext(bms, mms)
            mask_coarse = (self._coarse_mask_packed(bms, mms)
                           if self._cts_coarse is not None and self._coarse_bc_placement_ok() else None)
            mask_mid = [self._mid_mask_ext(l, bms, mms) if self._cts_mid[l] is not None else None for l in range(L)]
            mid_ext = any(m is not None for m in mask_mid)
            f0, coarse = fs[0], list(fs[1:])
            if shifted:
                w = self._w_col(f0.device)
                f0 = (pp.cast_to_compute(f0) - w).to(pp.store_dtype)
                coarse = [(pp.cast_to_compute(fv) - w).to(pp.store_dtype) for fv in coarse]
            coarse = [_pad(pp.cast_to_store(fv), self._mid_ring[l + 1]).contiguous()
                      if self._cts_mid[l + 1] is not None else fv for l, fv in enumerate(coarse)]
            state = [_pad(pp.cast_to_store(f0), self._cts_ring).contiguous()] + coarse
            for _ in range(num_coarse_steps):
                state = self._advance(L - 1, state, bms, mms, omega_finest, ext_state=True, mask_ext=mask_ext,
                                      shifted_state=shifted, mask_coarse=mask_coarse,
                                      mask_mid=mask_mid if mid_ext else None, mid_ext=mid_ext)
            out = [state[0][_interior(self._cts_ring)]]
            out += [sv[_interior(self._mid_ring[l + 1])] if self._cts_mid[l + 1] is not None else sv
                    for l, sv in enumerate(state[1:])]
            if shifted:
                out = [pp.cast_to_compute(sv) + self._w_col(sv.device) for sv in out]
            return out

        return run_ext
