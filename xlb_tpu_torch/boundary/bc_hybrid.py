"""Hybrid curved-boundary condition (interpolated bounce-back and closures)
-- the port of ``xlb_tpu.boundary.bc_hybrid``, term for term in torch.

Four methods:

- ``bounceback``: Yu-Mei-Shyy single-node interpolated bounce-back of the
  missing populations, no reconstruction of the known ones (the
  Schafer-Turek benchmark's choice);
- ``bounceback_regularized``: the same, then Latt-Chopard regularization
  of all populations from (rho, u) of the post-bounce-back state;
- ``bounceback_grads``: interpolated bounce-back, then Grad's
  approximation for the missing populations;
- ``nonequilibrium_regularized``: Tao et al. (2018) one-point
  second-order closure, then regularization.

Fractional wall distances (t in [0, 1] per missing link) come from
``xlb_tpu_torch.geometry.distances`` (a mesh, at ``prepare_fields``) or
``set_link_distances`` (an analytic shape); voxels without a distance take
the halfway value t = 1/2. The fused kernels read the same weights from the
aux field (``kernels.fused_step.build_aux_field``).
"""

import numpy as np
import torch

from xlb_tpu_torch.boundary.base import BoundaryCondition, ImplementationStep
from xlb_tpu_torch.boundary.bc_bounce_back import takes_coordinates
from xlb_tpu_torch.ops.equilibrium import quadratic_equilibrium
from xlb_tpu_torch.ops.macroscopic import density, momentum_flux, velocity
from xlb_tpu_torch.ops.stencil_math import stencil_contract

METHODS = ("bounceback", "bounceback_regularized", "bounceback_grads", "nonequilibrium_regularized")


def scatter_index(idx, shape):
    """(index tuple, kept columns) of the (d, n) voxel indices ``idx`` in a
    field of ``shape``, with NumPy's (and ``jax.numpy``'s ``.at[]``)
    semantics: an index in [-s, 0) counts from the end, any other index
    outside [0, s) is dropped."""
    idx = np.asarray(idx, dtype=np.int64)
    s = np.asarray(shape, dtype=np.int64)[:, None]
    keep = np.all((idx >= -s) & (idx < s), axis=0)
    return tuple(np.where(idx < 0, idx + s, idx)[:, keep]), keep


class HybridBC(BoundaryCondition):
    def __init__(self, bc_method="bounceback_regularized", profile=None, prescribed_value=None,
                 use_mesh_distance=True, velocity_set=None, precision_policy=None, compute_backend=None,
                 indices=None, mesh_vertices=None, voxelization_method=None):
        if bc_method not in METHODS:
            raise ValueError(f"bc_method must be one of {METHODS}, got {bc_method!r}")
        self.bc_method = bc_method
        super().__init__(ImplementationStep.STREAMING, velocity_set, precision_policy, compute_backend, indices,
                         mesh_vertices, voxelization_method)
        self.needs_padding = True
        self.needs_mesh_distance = bool(use_mesh_distance and mesh_vertices is not None)
        self.needs_moving_wall_treatment = (profile is not None) or (prescribed_value is not None)
        self.profile = profile
        if prescribed_value is not None:
            value = np.asarray(prescribed_value, dtype=np.float64)
            if value.shape != (self.velocity_set.d,):
                raise ValueError(f"wall velocity must have {self.velocity_set.d} components, got {value.shape}")
            self.profile = lambda: value.reshape(-1, 1)
        # (q, n) distances in the missing-direction convention at the (d, n)
        # voxels _distance_voxels, set by compute_mesh_distances() after
        # voxelization or by set_link_distances()
        self._distance_voxels = None
        self._distances = None
        self._consts = {}

    def _const(self, key, make):
        """A constant tensor of the call (the weight field, the moving-wall
        terms, index and weight vectors), made once per key: copied to the
        device anew at every call, they would stall the host on each."""
        if key not in self._consts:
            self._consts[key] = make()
        return self._consts[key]

    @property
    def spatial(self):
        """True when the wall velocity varies in space (``profile(coords)``)."""
        return self.profile is not None and takes_coordinates(self.profile)

    # ------------------------------------------------------------------
    def compute_mesh_distances(self):
        """Per-voxel directional wall distances from the mesh, stored in the
        missing-direction convention: ``_distances[l]`` is the weight used
        when direction l is missing, the crossing fraction along c_opp(l)
        (the wall sits behind the pull source x - c_l)."""
        from xlb_tpu_torch.geometry.distances import directional_wall_distances

        if self.mesh_vertices is None or self.indices is None:
            return
        tris = np.asarray(self.mesh_vertices, dtype=np.float64)
        if tris.ndim == 2:
            tris = tris.reshape(-1, 3, 3)
        voxels = self.pad_indices()
        along_c = directional_wall_distances(tris, voxels.astype(np.float64), self.velocity_set._c)
        self.set_link_distances(voxels, along_c)

    def set_link_distances(self, voxels, distances_along_c):
        """Attach per-link wall distances computed elsewhere: (q, n) with
        entry [l, i] the crossing fraction of the link from voxel i along
        c_l (inf for none), the convention of
        ``geometry.distances.directional_wall_distances`` and
        ``implicit_link_distances``. Rows are re-indexed here to the
        missing-direction convention that both tiers read."""
        self._distance_voxels = np.asarray(voxels)
        self._distances = np.asarray(distances_along_c)[self.velocity_set._opp_indices]
        self.needs_mesh_distance = True
        self._consts = {}

    def weights_np(self):
        """The (q, n) float32 interpolation weights at ``_distance_voxels``:
        the distances clipped to [0, 1], non-finite ones at 1/2."""
        vals = np.where(np.isfinite(self._distances), self._distances, 0.5).astype(np.float32)
        return np.clip(vals, 0.0, 1.0)

    def _weight_field(self, shape, dtype, device):
        """Per-(direction, voxel) weights, 1/2 where no distance is known."""
        return self._const(("weights", tuple(shape), dtype, device), lambda: self._make_weight_field(shape, dtype, device))

    def _make_weight_field(self, shape, dtype, device):
        field = torch.full((self.velocity_set.q,) + tuple(shape), 0.5, dtype=dtype, device=device)
        if self._distances is not None:
            idx, keep = scatter_index(self._distance_voxels, shape)
            vals = torch.as_tensor(self.weights_np()[:, keep], device=device).to(dtype)
            field[(slice(None),) + tuple(torch.as_tensor(i, device=device) for i in idx)] = vals
        return field

    def wall_velocity_np(self):
        """The constant wall velocity (d,) float64 of a moving wall."""
        return np.asarray(self.profile(), dtype=np.float64).reshape(-1)

    def spatial_wall_velocity(self):
        """(pad_indices (d, n) int64, wall velocity (d, n) float64) of a
        spatial profile, evaluated once on the dilated voxel set."""
        if self.indices is None:
            raise ValueError("a spatial wall-velocity profile needs the BC's voxel indices (run prepare_fields first)")
        idx = np.asarray(self.pad_indices(), dtype=np.int64)
        u_wall = np.asarray(self.profile(idx.astype(np.float64)), dtype=np.float64)
        if u_wall.shape != idx.shape:
            raise ValueError(f"profile returned {u_wall.shape}, expected {idx.shape}")
        return idx, u_wall

    def _u_wall_term(self, f_post):
        """The moving-wall correction 6 w_l (c_l . u_wall) and the wall
        velocity, or (0.0, None): a broadcastable constant and the (d, 1)
        float64 velocity for a constant wall; (q, ...) and (d, ...) fields,
        zero off the dilated voxel set, for a spatial profile."""
        if not self.needs_moving_wall_treatment:
            return 0.0, None
        key = ("wall", tuple(f_post.shape), f_post.dtype, f_post.device)
        return self._const(key, lambda: self._make_u_wall_term(f_post))

    def _make_u_wall_term(self, f_post):
        vs = self.velocity_set
        dev, dtype = f_post.device, f_post.dtype
        ct = vs._c.T.astype(np.float64)
        if not self.spatial:
            u_wall = self.wall_velocity_np().reshape(vs.d, 1)
            mw = 6.0 * vs._w[:, None] * (ct @ u_wall)
            return torch.as_tensor(mw, device=dev).to(dtype).reshape((-1,) + (1,) * (f_post.ndim - 1)), u_wall
        idx, u_wall = self.spatial_wall_velocity()
        mw = 6.0 * vs._w[:, None] * (ct @ u_wall)  # (q, n)
        sel, keep = scatter_index(idx, f_post.shape[1:])
        sel = (slice(None),) + tuple(torch.as_tensor(i, device=dev) for i in sel)
        mw_field = torch.zeros_like(f_post)
        mw_field[sel] = torch.as_tensor(mw[:, keep], device=dev).to(dtype)
        uw_field = torch.zeros((vs.d,) + tuple(f_post.shape[1:]), dtype=dtype, device=dev)
        uw_field[sel] = torch.as_tensor(u_wall[:, keep], device=dev).to(dtype)
        return mw_field, uw_field

    def _w(self, like):
        """The weights as a (q, 1, ...) tensor of ``like``'s dtype."""
        def make():
            w = torch.as_tensor(self.velocity_set._w, device=like.device).to(like.dtype)
            return w.reshape((-1,) + (1,) * (like.ndim - 1))

        return self._const(("w", like.ndim, like.dtype, like.device), make)

    def _w45(self, like):
        """4.5 w_l rounded to float32 as a (q, 1, ...) tensor."""
        def make():
            w45 = torch.as_tensor(4.5 * self.velocity_set._w.astype(np.float32), device=like.device)
            return w45.reshape((-1,) + (1,) * (like.ndim - 1))

        return self._const(("w45", like.ndim, like.device), make)

    def _opp(self, device):
        return self._const(("opp", device), lambda: torch.as_tensor(self.velocity_set._opp_indices, dtype=torch.long,
                                                                     device=device))

    # ------------------------------------------------------------------
    def _interpolated_bounceback(self, f_pre, f_post, missing_mask, weights):
        """Yu-Mei-Shyy single-node interpolated bounce-back."""
        opp = self._opp(f_pre.device)
        if self.needs_mesh_distance:
            interp = ((1.0 - weights) * f_post[opp] + weights * (f_pre + f_pre[opp])) / (1.0 + weights)
        else:
            interp = f_pre[opp]
        # sandwich case: both directions missing -> plain bounce-back
        interp = torch.where(missing_mask & missing_mask[opp], f_pre[opp], interp)
        if self.needs_moving_wall_treatment:
            interp = interp + self._u_wall_term(f_post)[0]
        return torch.where(missing_mask, interp, f_post)

    def _regularize(self, fpop, feq):
        vs = self.velocity_set
        pi_neq = momentum_flux(fpop - feq, vs._cc)
        qipi = stencil_contract(vs._qi, pi_neq)
        return feq + self._w45(fpop) * qipi

    def _grads_approximation(self, missing_mask, rho, u, f_post):
        """Grad's closure for the missing populations: f_l = rho w_l (1 + 3
        c_l.u) + 4.5 w_l Q_l : (Pi - rho/3 I)."""
        vs = self.velocity_set
        pi = momentum_flux(f_post, vs._cc)
        diag = vs.diagonal_moment_indices
        pi_dev = torch.stack([pi[t] - rho[0] / 3.0 if t in diag else pi[t] for t in range(pi.shape[0])])
        qipi = stencil_contract(vs._qi, pi_dev)
        cu = 3.0 * stencil_contract(vs._c.T, u)
        grads = rho * self._w(f_post) * (1.0 + cu) + self._w45(f_post) * qipi
        return torch.where(missing_mask, grads, f_post)

    def _tao_closure(self, f_pre, f_post, missing_mask, weights):
        """Tao et al. (2018) one-point curved closure."""
        vs = self.velocity_set
        opp = self._opp(f_pre.device)
        rho = density(f_pre)
        u = velocity(f_pre, rho, vs._c)
        feq = quadratic_equilibrium(rho, u, vs._c, vs._w, f_pre.dtype)
        fneq = f_pre[opp] - feq[opp]
        if self.needs_moving_wall_treatment:
            _, u_wall = self._u_wall_term(f_post)
            if isinstance(u_wall, np.ndarray):  # a constant wall, broadcast
                u_wall = torch.as_tensor(u_wall, device=u.device).to(u.dtype).reshape(
                    (vs.d,) + (1,) * (u.ndim - 1)) + torch.zeros_like(u)
            feq_wall = quadratic_equilibrium(rho, u_wall, vs._c, vs._w, f_pre.dtype)
        else:
            feq_wall = self._w(f_pre) * rho  # the zero-velocity equilibrium
        f_wall = feq_wall + fneq
        closed = (f_wall + weights * f_pre) / (1.0 + weights)
        return torch.where(missing_mask, closed, f_post)

    # ------------------------------------------------------------------
    def __call__(self, f_pre, f_post, bc_mask, missing_mask):
        vs = self.velocity_set
        weights = None
        if self.needs_mesh_distance or self.bc_method == "nonequilibrium_regularized":
            weights = self._weight_field(f_post.shape[1:], f_post.dtype, f_post.device)

        if self.bc_method == "nonequilibrium_regularized":
            f_bd = self._tao_closure(f_pre, f_post, missing_mask, weights)
            rho = density(f_bd)
            f_bd = self._regularize(f_bd, quadratic_equilibrium(rho, velocity(f_bd, rho, vs._c), vs._c, vs._w,
                                                               f_bd.dtype))
        else:
            f_bd = self._interpolated_bounceback(f_pre, f_post, missing_mask, weights)
            if self.bc_method != "bounceback":
                rho = density(f_bd)
                u = velocity(f_bd, rho, vs._c)
                if self.bc_method == "bounceback_regularized":
                    f_bd = self._regularize(f_bd, quadratic_equilibrium(rho, u, vs._c, vs._w, f_bd.dtype))
                else:
                    f_bd = self._grads_approximation(missing_mask, rho, u, f_bd)
        return torch.where(self.boundary_map(bc_mask), f_bd, f_post)
