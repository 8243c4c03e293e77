"""Glue between the NSE stepper and the fused collide-stream kernels.

Translates BC objects into static kernel epilogue specs, packs
``bc_mask`` / ``missing_mask`` into one int32 voxel field, assembles the
aux field of per-voxel prescriptions (``build_aux_field``), and builds the
CUDA-tier step and window, in 3D (D3Q19, D3Q27) and 2D (D2Q9). BCs
supported in the fused step: EquilibriumBC, FullwayBounceBackBC and
HalfwayBounceBackBC with a constant wall everywhere; in 2D ZouHeBC,
RegularizedBC, HybridBC and per-voxel prescriptions (a halfway wall's
velocity, a Zou-He / regularized velocity or density); and in 3D on D3Q19
BGK and D3Q27 KBC (the open-boundary and curved-wall kernels) ZouHeBC and
RegularizedBC, DoNothingBC, FreeSlipBC, ExtrapolationOutflowBC, HybridBC
and the per-voxel prescriptions; any other kind or pair raises. In 3D every collision of
the TORCH tier and the exact-difference body force run in the kernels,
through the single-step kernel (``kernel="dma"``, the default, with the
k-step kernel in windows) or the block-tiled one (``kernel="blocked"``).
The field modes run through the single-step kernels (K1, K3):
``build_fused_ade_step`` (advection-diffusion, ``models/ade.py``) and
``build_fused_forced_step`` (a per-voxel force, the thermal and Shan-Chen
models), forward only, as in ``xlb_tpu``.

None of the TPU machinery of ``xlb_tpu.kernels.fused_step`` is carried
over: no z padding to lane multiples, no tile estimators for on-chip
memory.
"""

import numpy as np
import torch

from xlb_tpu_torch.boundary.base import ImplementationStep
from xlb_tpu_torch.boundary.bc_bounce_back import FullwayBounceBackBC, HalfwayBounceBackBC
from xlb_tpu_torch.boundary.bc_do_nothing import DoNothingBC
from xlb_tpu_torch.boundary.bc_equilibrium import EquilibriumBC
from xlb_tpu_torch.boundary.bc_extrapolation_outflow import ExtrapolationOutflowBC
from xlb_tpu_torch.boundary.bc_free_slip import FreeSlipBC
from xlb_tpu_torch.boundary.bc_hybrid import HybridBC
from xlb_tpu_torch.boundary.bc_regularized import RegularizedBC
from xlb_tpu_torch.boundary.bc_zouhe import ZouHeBC, _broadcast_prescribed
from xlb_tpu_torch.kernels.collide_stream import aux_layout, bc_id_shift, kernel_collision_spec, packed_cell
from xlb_tpu_torch.kernels.collide_stream_blocked import CollideStreamBlocked
from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
from xlb_tpu_torch.kernels.collide_stream_2d import CollideStream2DKStep, CollideStream2DStep
from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
from xlb_tpu_torch.utils.tracing import span, wait

# default k of the window's k-step groups by dimension, as in xlb_tpu
TEMPORAL_STEPS = {2: 8, 3: 2}


def bc_to_spec(bc, velocity_set):
    """Convert a BC object into a static spec dict for the kernel epilogue."""
    step = "streaming" if bc.implementation_step == ImplementationStep.STREAMING else "collision"
    if isinstance(bc, EquilibriumBC):
        return {"kind": "equilibrium", "id": bc.id, "step": step, "feq": bc.prescribed_feq_np().astype(np.float32)}
    if isinstance(bc, FullwayBounceBackBC):
        return {"kind": "fullway", "id": bc.id, "step": step}
    if isinstance(bc, HalfwayBounceBackBC):
        return {"kind": "halfway", "id": bc.id, "step": step, "mw": bc.moving_wall_np()}
    if isinstance(bc, DoNothingBC):
        return {"kind": "do_nothing", "id": bc.id, "step": step}
    if isinstance(bc, FreeSlipBC):
        # the plain body reflects through spec_indices / reflect_dirs, as
        # xlb_tpu's; the kernels derive both from the normal
        return {"kind": "free_slip", "id": bc.id, "step": step, "normal": np.asarray(bc.normal, dtype=np.int64),
                "spec_indices": bc.spec_indices, "reflect_dirs": bc.reflect_dirs}
    if isinstance(bc, ExtrapolationOutflowBC):
        return {"kind": "extrapolation_outflow", "id": bc.id, "step": step,
                "normal": np.asarray(bc.normal, dtype=np.int64)}
    if isinstance(bc, HybridBC):
        # as xlb_tpu's: the method, whether the wall distances ride the aux
        # field, and a static moving-wall term 6 w_l (c_l . u) with its u,
        # "aux" (the velocity in the aux field) or None
        spec = {"kind": "hybrid", "id": bc.id, "step": step, "method": bc.bc_method,
                "use_dist": bool(bc.needs_mesh_distance), "mw": None}
        if bc.needs_moving_wall_treatment:
            if bc.spatial:
                spec["mw"] = "aux"
            else:
                u_wall = bc.wall_velocity_np()
                spec["mw"] = 6.0 * velocity_set._w * (velocity_set._c.T.astype(np.float64) @ u_wall)
                spec["u_wall"] = u_wall
        return spec
    if isinstance(bc, (ZouHeBC, RegularizedBC)):
        kind = "regularized" if isinstance(bc, RegularizedBC) else "zouhe"
        value = np.asarray(bc.prescribed_values, dtype=np.float64)
        if bc.spatial:  # a per-voxel velocity or density from the aux field
            spec_value = "aux" if bc.bc_type == "velocity" else "aux_rho"
        else:
            spec_value = value.reshape(-1) if bc.bc_type == "velocity" else float(value.reshape(-1)[0])
        return {"kind": kind, "id": bc.id, "step": step, "bc_type": bc.bc_type, "value": spec_value}
    raise NotImplementedError(
        f"{type(bc).__name__} is not yet supported by the fused CUDA kernels; use ComputeBackend.TORCH"
    )


def build_aux_field(stepper):
    """The aux field of the BCs' per-voxel prescriptions, as a host NumPy
    (nchan, *shape) float32 array, or None when no BC has one -- the port
    of ``xlb_tpu.kernels.fused_step.build_aux_field``, channel for channel:
    d velocity channels (spatial Zou-He / regularized velocities,
    moving-wall velocities), then a density channel (spatial pressures; 1
    off the BC), then q wall-distance weights per hybrid BC with distances
    (1/2 off its voxels; its distances clipped to [0, 1], 1/2 where not
    finite), in the layout of ``collide_stream.aux_layout``. A moving wall
    is evaluated on its BC's dilated voxel set, a Zou-He / regularized
    prescription sampled at its voxels; indices outside the domain are
    dropped. Build it after ``prepare_fields`` (mesh BCs get their indices
    and distances there)."""
    vs = stepper.velocity_set
    shape = tuple(stepper.grid.shape)
    specs = [bc_to_spec(bc, vs) for bc in stepper.boundary_conditions]
    u_off, rho_off, w_offs, nchan = aux_layout(specs, vs)
    if nchan == 0:
        return None
    aux = np.zeros((nchan,) + shape, np.float32)
    if rho_off is not None:
        aux[rho_off] = 1.0  # inert default: keeps fsum / rho finite off the BC

    def inside(idx):
        return np.all((idx >= 0) & (idx < np.asarray(shape)[:, None]), axis=0)

    for bc, spec in zip(stepper.boundary_conditions, specs):
        if spec["kind"] == "hybrid" and spec["use_dist"]:
            if bc._distances is None:
                raise NotImplementedError("HybridBC wall distances are computed by prepare_fields; build the aux "
                                          "field after it")
            w_off = w_offs[bc.id]
            aux[w_off:w_off + vs.q] = 0.5
            idx = np.asarray(bc._distance_voxels, dtype=np.int64)
            keep = inside(idx)
            aux[(slice(w_off, w_off + vs.q),) + tuple(idx[:, keep])] = bc.weights_np()[:, keep]
        if isinstance(spec.get("mw"), str):
            idx, u_wall = bc.spatial_wall_velocity()
            keep = inside(idx)
            aux[(slice(u_off, u_off + vs.d),) + tuple(idx[:, keep])] = u_wall[:, keep].astype(np.float32)
        elif isinstance(spec.get("value"), str):
            if bc.indices is None:
                raise NotImplementedError("spatial Zou-He / regularized profiles need voxel indices (prepare_fields)")
            idx = np.asarray(bc.indices, dtype=np.int64)
            idx = tuple(idx[:, inside(idx)])
            values = np.asarray(bc.prescribed_values, dtype=np.float32)
            if spec["value"] == "aux":
                full = np.broadcast_to(_broadcast_prescribed(values, (vs.d,) + shape), (vs.d,) + shape)
                aux[(slice(u_off, u_off + vs.d),) + idx] = full[(slice(None),) + idx]
            else:
                full = np.broadcast_to(_broadcast_prescribed(values, (1,) + shape), (1,) + shape)
                aux[(rho_off,) + idx] = full[(0,) + idx]
    return aux


def device_aux_field(stepper, device):
    """``build_aux_field``'s field as a contiguous tensor on ``device``:
    built on the host and copied over inside the span ``xlb.window.aux``."""
    with span("xlb.window.aux", device):
        return torch.as_tensor(build_aux_field(stepper), device=device).contiguous()


def ring_val(q):
    """Packed mask value of a multires ring or refined-region cell: cell
    type 254 with no missing directions (254 << 19 for q <= 19)."""
    return packed_cell(254, q)


def stepper_force_vector(stepper):
    """The constant body-force vector of a forced stepper (float64 NumPy),
    or None."""
    fv = getattr(getattr(stepper, "collision", None), "force_vector", None)
    return None if fv is None else np.asarray(fv, dtype=np.float64)


def pack_masks(bc_mask, missing_mask):
    """(bc_mask uint8 (1,*s), missing bool (q,*s)) -> one int32 (*s).

    Bits 0..q-1 hold the missing-direction bitfield; the id field follows
    ``collide_stream.bc_id_shift``: the raw uint8 cell type in bits 19..26
    for q <= 19, a 5-bit id in bits 27..31 for D3Q27 (254 -> 30, 255 -> 31,
    the other ids below 30), bit for bit as
    ``xlb_tpu.kernels.fused_step.pack_masks``.
    """
    q = missing_mask.shape[0]
    bc = bc_mask[0].to(torch.int32)
    if q > 19:  # the BC ids themselves are checked against the id space in kernel_params
        bc = torch.where(bc >= 254, bc - 224, bc)
    packed = bc << bc_id_shift(q)
    for l in range(q):
        packed |= missing_mask[l].to(torch.int32) << l
    return packed


def _stepper_config(stepper):
    pp = stepper.precision_policy
    return dict(
        collision=kernel_collision_spec(stepper),
        bc_specs=[bc_to_spec(bc, stepper.velocity_set) for bc in stepper.boundary_conditions],
        compute_dtype=pp.compute_dtype,
        store_dtype=pp.store_dtype,
    )


def _host_float(omega):
    """omega as the Python float the kernels read (one read per call; a
    CUDA tensor's read waits for its device)."""
    if not isinstance(omega, torch.Tensor):
        return float(omega)
    with wait("omega", omega.device):
        return float(omega.detach())


class _FusedFunction(torch.autograd.Function):
    """A fused step or window with its reverse sweep as its backward, in
    place of ``xlb_tpu``'s ``custom_vjp``s (``fused_step.py::
    build_fused_step`` and ``build_fused_window``): the adjoint kernel, or
    the TORCH tier's VJP (the 2D step, and ``kernel="blocked"``). The
    gradient of ``f_0`` comes back in ``f_0``'s dtype and that of a tensor
    omega in omega's; the masks and BC prescriptions get none."""

    @staticmethod
    def forward(ctx, f_0, omega, mask_i32, omega_f, sweeps, masks):
        ctx.save_for_backward(f_0, mask_i32, *masks)
        ctx.omega_f, ctx.sweeps = omega_f, sweeps
        if isinstance(omega, torch.Tensor):
            ctx.omega_like = (omega.device, omega.dtype, omega.shape)
        return sweeps.value(f_0.detach(), mask_i32, omega_f)

    @staticmethod
    def backward(ctx, gbar):
        with span("xlb.backward", gbar.device):
            f_0, mask_i32, *masks = ctx.saved_tensors
            df, dom = ctx.sweeps.reverse(f_0.detach(), gbar, mask_i32, ctx.omega_f, masks)
            d_omega = None
            if ctx.needs_input_grad[1]:
                device, dtype, shape = ctx.omega_like
                d_omega = dom.to(device=device, dtype=dtype).reshape(shape)
            return df.to(f_0.dtype), d_omega, None, None, None, None


class _FusedSweeps:
    """The kernels of ``num_steps`` fused steps, and their forward and
    reverse sweeps.

    ``kernel="dma"``: groups of k (``temporal_steps``) steps run through
    the k-step kernel, the remainder through the single-step kernel; 3D
    takes k <= num_steps and 2D the k it is given, as ``xlb_tpu``'s
    windows do. ``kernel="blocked"`` (3D): one block-tiled step per step,
    no temporal blocking, as ``xlb_tpu``'s blocked window.

    The reverse sweep (``backward``): "adjoint" -- the adjoint kernel
    (every 3D "dma" configuration, the open boundaries and curved walls
    included, as ``xlb_tpu``'s fused adjoint); "torch" -- the TORCH tier's
    VJP (the 2D step, and every 3D "blocked" configuration, as ``xlb_tpu``
    differentiates its blocked kernel through the jnp tier); None -- no
    backward (the 2D window, as in ``xlb_tpu``), and ``no_backward`` says
    why. The aux field of the BCs' per-voxel prescriptions is built at the
    first call, after ``prepare_fields`` gave mesh BCs their indices; the
    reverse sweep passes it to the replayed steps and the adjoint kernel
    (a constant: prescriptions carry no gradient). ``aux_bytes`` counts the
    bytes of the aux fields put on a device, over all instances, as the
    kernel wrappers count ``launches``."""

    aux_bytes = 0

    def __init__(self, stepper, num_steps, shifted, temporal_steps=None, kernel="dma", tile=None):
        vs = stepper.velocity_set
        self.stepper = stepper
        self.pp = pp = stepper.precision_policy
        self.shifted = shifted
        self.num_steps = num_steps
        if kernel not in ("dma", "blocked"):
            raise ValueError(f"kernel must be 'dma' or 'blocked', got {kernel!r}")
        if tile is not None and (kernel != "blocked" or vs.d != 3):
            raise ValueError("tile sets the (TX, TY, TZ) box of the 3D kernel='blocked' step only")
        k = TEMPORAL_STEPS[vs.d] if temporal_steps is None else int(temporal_steps)
        cfg = dict(_stepper_config(stepper), shifted=shifted, has_solids=getattr(stepper, "has_solids", True),
                   force_vector=stepper_force_vector(stepper))
        shape = stepper.grid.shape
        self.adjoint, self.no_backward = None, None
        self._aux = None
        if vs.d == 2:
            if kernel != "dma":
                raise NotImplementedError("kernel='blocked' is a 3D kernel; the 2D step has its own (K3, K4)")
            self.k = k
            self.single = CollideStream2DStep(vs, shape, **cfg)
            self.kstep = CollideStream2DKStep(vs, shape, steps=k, **cfg) if k >= 2 and num_steps >= 2 else None
            # xlb_tpu's 2D window has no backward and its step differentiates
            # through the jnp tier; there is no 2D adjoint kernel
            self.backward = "torch" if num_steps == 1 and not shifted else None
            self.no_backward = ("the 2D fused window has no backward (as in xlb_tpu); differentiate 2D rollouts "
                                "through ComputeBackend.TORCH, or the CUDA tier's single stepper(...)")
        elif kernel == "blocked":
            self.k = 1
            self.single = CollideStreamBlocked(vs, shape, tile=tile, **cfg)
            self.kstep = None
            self.backward = "torch"
        else:
            self.k = k = min(k, num_steps)
            self.single = CollideStreamStep(vs, shape, **cfg)
            self.kstep = CollideStreamKStep(vs, shape, steps=k, **cfg) if k >= 2 else None
            self.backward = "adjoint"
            self.adjoint = CollideStreamAdjoint(vs, shape, **cfg)
        self.n_k = num_steps // self.k if self.kstep is not None else 0
        self.w_shift = torch.as_tensor(vs._w).to(pp.store_dtype).reshape((vs.q,) + (1,) * vs.d)

    def _weights_on(self, device):
        """``w_shift`` in the compute dtype on ``device``: a copy from host
        memory, which on a CUDA device waits until the device is done."""
        with wait("w_shift", device):
            return self.w_shift.to(device=device, dtype=self.pp.compute_dtype)

    def _to_store_form(self, f_0):
        if not self.shifted:
            return f_0
        return (f_0.to(self.pp.compute_dtype) - self._weights_on(f_0.device)).to(self.pp.store_dtype)

    def _aux_args(self, device):
        """``(aux,)`` when the scene's BCs read an aux field, else ``()``."""
        if not self.single.aux_channels:
            return ()
        if self._aux is None:  # built at the first call: mesh BCs have their indices after prepare_fields
            self._aux = device_aux_field(self.stepper, device)
            _FusedSweeps.aux_bytes += self._aux.numel() * self._aux.element_size()
        return (self._aux,)

    def value(self, f_0, mask_i32, omega):
        g = f_0
        if self.shifted:
            with span("xlb.window.shift_in", f_0.device):
                g = self._to_store_form(f_0)
        extra = self._aux_args(f_0.device)
        with span("xlb.window.sweep", f_0.device):
            for _ in range(self.n_k):
                g = self.kstep(g, mask_i32, omega, *extra)
            for _ in range(self.num_steps - self.n_k * self.k):
                g = self.single(g, mask_i32, omega, *extra)
        if self.shifted:
            with span("xlb.window.shift_out", g.device):
                return g.to(self.pp.compute_dtype) + self._weights_on(g.device)
        return g

    def reverse(self, f_0, gbar, mask_i32, omega, masks):
        """With the adjoint kernel: replay the forward with the single-step
        kernel, keeping every step's input (store dtype), then run the
        adjoint kernel backwards from the cotangent ``gbar``; the shift at
        the window boundary is the identity for gradients. Otherwise the
        TORCH tier's VJP of the ``num_steps`` steps, as ``xlb_tpu`` takes
        the jnp tier's (``fused_step.py:436-438``). Returns (df_0,
        d omega as a 0-d float32 tensor)."""
        if self.backward == "torch":
            return self._reverse_torch_tier(f_0, gbar, omega, masks)
        extra = self._aux_args(f_0.device)
        states = [self._to_store_form(f_0)] if self.num_steps else []
        with span("xlb.backward.replay", f_0.device):
            while len(states) < self.num_steps:
                states.append(self.single(states[-1], mask_i32, omega, *extra))
        ct = gbar.to(self.pp.compute_dtype).contiguous()
        dom = torch.zeros((), dtype=torch.float32, device=ct.device)
        while states:  # popped as the sweep goes, so each state is freed once used
            with span("xlb.backward.adjoint", ct.device):
                ct, dom_field = self.adjoint(states.pop(), ct, mask_i32, omega, *extra)
            dom = dom + torch.sum(dom_field.to(torch.float32))
        return ct, dom

    def _reverse_torch_tier(self, f_0, gbar, omega, masks):
        bc_mask, missing_mask = masks
        om = torch.tensor(omega, dtype=self.pp.compute_dtype, device=f_0.device)

        def steps(f, o):
            for _ in range(self.num_steps):
                f = self.stepper._step_pull(f, f, bc_mask, missing_mask, o, 0)[1]
            return f

        _, vjp = torch.func.vjp(steps, f_0, om)
        return vjp(gbar.to(self.pp.store_dtype))

    def check_backward(self, f_0, omega):
        """Raise ``NotImplementedError`` when autograd asks for a gradient
        that this configuration has no backward for."""
        wants_grad = f_0.requires_grad or (isinstance(omega, torch.Tensor) and omega.requires_grad)
        if self.backward is None and wants_grad and torch.is_grad_enabled():
            raise NotImplementedError(self.no_backward)


def build_fused_step(stepper, kernel="dma", tile=None):
    """Build the CUDA-tier single step of an IncompressibleNavierStokesStepper:
    ``(f_0, f_1, bc_mask, missing_mask, omega, timestep) -> (f_0, f_1)``
    with ``f_1`` the new state, in plain (unshifted) storage.

    ``kernel``: "dma" (the single-step kernel K1, the default) or
    "blocked" (3D: the block-tiled kernel K0, whose (TX, TY, TZ) box
    ``tile`` sets). Both compute the same function.

    The step is differentiable with respect to ``f_0`` and ``omega`` (a
    float or a 0-d tensor): its backward is the adjoint kernel
    (``kernels/adjoint_step.py``) for "dma", and ``torch.func.vjp`` of the
    TORCH-tier step for "blocked" and in 2D, where the forward still runs
    the kernel; the open boundaries and curved walls included."""
    sweeps = _FusedSweeps(stepper, 1, shifted=False, kernel=kernel, tile=tile)

    def step(f_0, f_1, bc_mask, missing_mask, omega, timestep=0):
        sweeps.check_backward(f_0, omega)
        mask_i32 = pack_masks(bc_mask, missing_mask)
        if sweeps.backward is None:
            return f_0, sweeps.value(f_0.detach(), mask_i32, _host_float(omega))
        return f_0, _FusedFunction.apply(f_0, omega, mask_i32, _host_float(omega), sweeps, (bc_mask, missing_mask))

    return step


def build_fused_window(stepper, num_steps, temporal_steps=None, kernel="dma", tile=None):
    """A ``num_steps``-window of the fused step.

    Under a 16-bit store dtype the populations live in device memory in
    deviation form g = f - w during the window and are converted back at
    its boundary. The boundary shifts by the weights rounded to the store
    dtype (``w_shift``), while the kernels add and subtract float32 weights
    at every load and store -- the same pair of constants as ``xlb_tpu``,
    under which a 16-bit rest state maps to g = 0 exactly.

    ``kernel="dma"`` (default): groups of ``temporal_steps`` (k; by
    default ``TEMPORAL_STEPS``: 8 in 2D, 2 in 3D, as in ``xlb_tpu``;
    2 <= k <= 8 in 2D, or 1 for single steps only) steps run through the
    k-step kernel, the ``num_steps % k`` remainder through the single-step
    kernel. ``kernel="blocked"`` (3D): one block-tiled step (K0) per step,
    no temporal blocking, as ``xlb_tpu``'s blocked window; ``tile`` sets
    its box.

    The window is differentiable with respect to ``f_0`` and ``omega`` (a
    float or a 0-d tensor; ``float(omega)`` is read once per window). With
    "dma", its backward saves only the window's input, replays the
    forward with the single-step kernel while keeping all ``num_steps``
    states in the store dtype -- memory is ``num_steps`` x one field --
    and runs the adjoint kernel in reverse. Differentiate
    long rollouts by chaining moderate windows under
    ``torch.utils.checkpoint``. With "blocked" the backward is the TORCH
    tier's VJP over the window. The gradient of ``f_0`` comes back in
    ``f_0``'s dtype. The 2D window has no backward, as in ``xlb_tpu``:
    under autograd it raises ``NotImplementedError``.

    Returns ``run(f_0, f_1, bc_mask, missing_mask, omega) -> (f, f)``: the
    new state twice, in the compute dtype when shifted (quantizing g + w
    back to 16 bits would erase the deviations) and in the store dtype
    otherwise.
    """
    sweeps = _FusedSweeps(stepper, num_steps, shifted=stepper.precision_policy.store_dtype.itemsize < 4,
                          temporal_steps=temporal_steps, kernel=kernel, tile=tile)

    def run(f_0, f_1, bc_mask, missing_mask, omega):
        with span("xlb.window", f_0.device):
            sweeps.check_backward(f_0, omega)
            with span("xlb.window.pack_masks", f_0.device):
                mask_i32 = pack_masks(bc_mask, missing_mask)
            if sweeps.backward is None:
                f = sweeps.value(f_0.detach(), mask_i32, _host_float(omega))
            else:
                f = _FusedFunction.apply(f_0, omega, mask_i32, _host_float(omega), sweeps, (bc_mask, missing_mask))
        return f, f

    return run


class _FieldStep:
    """The CUDA-tier step of a field mode (``collide_stream.FIELDS``): K1
    in 3D, K3 in 2D, one launch per call, forward only as in ``xlb_tpu``
    (a tensor that requires grad raises: differentiate through the TORCH
    tier). The per-voxel field goes first in the aux field, the BCs'
    channels (``build_aux_field``, built at the first call, after
    ``prepare_fields``) after it. The packed mask is reused while the same
    mask tensors come back unmodified."""

    def __init__(self, stepper, field, collision):
        vs = stepper.velocity_set
        pp = stepper.precision_policy
        specs = [bc_to_spec(bc, vs) for bc in stepper.boundary_conditions]
        kernel = CollideStream2DStep if vs.d == 2 else CollideStreamStep
        self.stepper = stepper
        self.kernel = kernel(vs, stepper.grid.shape, collision=collision, bc_specs=specs,
                             compute_dtype=pp.compute_dtype, store_dtype=pp.store_dtype,
                             has_solids=getattr(stepper, "has_solids", True), field=field)
        self.has_bc_aux = self.kernel.aux_channels > vs.d
        self._aux_bc = None
        self._masks = None

    def _mask(self, bc_mask, missing_mask):
        versions = (bc_mask._version, missing_mask._version)
        m = self._masks
        if m is None or m[0] is not bc_mask or m[1] is not missing_mask or m[2] != versions:
            self._masks = m = (bc_mask, missing_mask, versions, pack_masks(bc_mask, missing_mask))
        return m[3]

    def __call__(self, f_0, bc_mask, missing_mask, omega, field):
        aux = field.to(torch.float32)
        if self.has_bc_aux:
            if self._aux_bc is None:
                self._aux_bc = device_aux_field(self.stepper, f_0.device)
            aux = torch.cat([aux, self._aux_bc])
        return self.kernel(f_0, self._mask(bc_mask, missing_mask), _host_float(omega), aux.contiguous())


def build_fused_ade_step(stepper):
    """The CUDA-tier advection-diffusion step (``models/ade.py``), the port
    of ``xlb_tpu.kernels.fused_step.build_fused_ade_step``: one pass of
    stream, the voxel-local BCs (equilibrium, do-nothing, halfway, fullway,
    Zou-He and regularized with constant prescriptions) and BGK relaxation
    to the linear equilibrium, with the advecting velocity (d, *shape) as
    the aux field's first d channels -- it changes every step in coupled
    flows, so it is a call argument. ``xlb_tpu``'s padding of z to a
    multiple of 128 lanes has no counterpart: the kernels take any shape.

    Returns ``(g_0, g_1, bc_mask, missing_mask, omega_phi, u, timestep) ->
    (g_0, g_1)``. Forward only, as in ``xlb_tpu``: differentiate through
    the TORCH tier."""
    step = _FieldStep(stepper, "ade", "BGK")

    def run(g_0, g_1, bc_mask, missing_mask, omega_phi, u, timestep=0):
        return g_0, step(g_0, bc_mask, missing_mask, omega_phi, u)

    return run


def build_fused_forced_step(stepper):
    """The CUDA-tier NSE step with a per-voxel exact-difference force field
    (the field form of a constant ``force_vector``), the port of
    ``xlb_tpu.kernels.fused_step.build_fused_forced_step``: one pass with
    the force (d, *shape) as the aux field's first d channels and the
    BCs' per-voxel prescriptions (profile inlets, hybrid wall distances)
    after them. Used by the Boussinesq coupling (``models/ade.py``) and
    Shan-Chen (``models/multiphase.py``), whose force changes every step.

    Returns ``(f_0, f_1, bc_mask, missing_mask, omega, force_field,
    timestep) -> (f_0, f_1)``. Forward only, as in ``xlb_tpu``."""
    if stepper_force_vector(stepper) is not None:
        raise NotImplementedError("use either a static force_vector or the per-voxel force field, not both")
    step = _FieldStep(stepper, "extern_force", kernel_collision_spec(stepper))

    def run(f_0, f_1, bc_mask, missing_mask, omega, force_field, timestep=0):
        return f_0, step(f_0, bc_mask, missing_mask, omega, force_field)

    return run
