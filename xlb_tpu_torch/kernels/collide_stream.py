"""Packed-mask ABI and the plain per-voxel body of the fused kernels.

``pointwise_core`` is the plain torch version of the per-voxel physics of
``xlb_tpu.kernels.collide_stream._build_kernel_body`` for the epilogue
kinds this port supports: the streaming-step ``equilibrium``,
``do_nothing``, ``halfway`` (constant or per-voxel moving wall),
``free_slip``, ``zouhe`` and ``regularized`` (constant or per-voxel
velocity or density), ``extrapolation_outflow`` and ``hybrid`` (the
curved walls: four methods, wall distances, static or per-voxel moving
wall) BCs, the collision-step ``fullway`` BC, the outflow's post-collision staging, the
solid keep-out and shifted (g = f - w) load and store, around moments, the
pair-shared quadratic equilibrium, the collision (BGK, KBC, Smagorinsky,
PowerLaw, TRT, MRT, in the kernel body's form: TRT per opposite pair, MRT
as unrolled projector rows without their zero entries, KBC with the
pair-shared entropic products) and the exact-difference body force,
constant or per voxel; and the advection-diffusion step (the field modes
``ade`` and ``extern_force``, ``FIELDS``). The
CUDA kernels (``csrc/collide_stream.cuh``) compute the same terms in the
same order; this version is what the CPU tests run and what
``chip_smoke.py`` holds the kernels against. Per-voxel prescriptions ride
the aux field of ``fused_step.build_aux_field``, in the channel layout of
``aux_layout``, with the hybrid BCs' wall-distance weights.
"""

import numpy as np
import torch

from xlb_tpu_torch.ops.collision import kbc_shear


def bc_id_shift(q):
    """Bit position of the BC id field in the packed int32 mask. The
    missing-direction bitfield occupies bits 0..q-1, so:

    - q <= 19 (D2Q9, D3Q19): bits 19..26 hold the raw uint8 cell type;
    - q > 19 (D3Q27): bits 27..31 hold a 5-bit id: ids 0..29 as they are,
      254 -> 30 and 255 -> 31 (the packed value is then negative).
    """
    return 19 if q <= 19 else 27


def bc_id_mask(q):
    """Bitmask of the BC id field width (after shifting)."""
    return 0xFF if q <= 19 else 31


def kernel_bc_id(bc_id, q):
    """Packed-mask kernel id of a cell-type code (identity for q <= 19)."""
    if q <= 19:
        if not 0 <= bc_id <= 255:
            raise ValueError(f"BC id {bc_id} outside the uint8 cell-type space")
        return bc_id
    if bc_id in (254, 255):
        return bc_id - 224
    if not 0 <= bc_id < 30:
        raise ValueError(
            f"BC id {bc_id} does not fit the D3Q27 packed-mask 5-bit id space (0..29 + specials); "
            "D2Q9/D3Q19 scenes carry the full uint8 id space"
        )
    return bc_id


def kernel_solid_id(q):
    """Packed id of cell type 255 (solid)."""
    return kernel_bc_id(255, q)


def kernel_sfv_id(q):
    """Packed id of cell type 254 (the multires ghost ring and refined
    region: kept through the collide)."""
    return kernel_bc_id(254, q)


def spec_uses_aux(spec):
    """True when a BC spec reads a per-voxel aux channel (a prescribed
    velocity or density, a moving-wall velocity, or a hybrid BC's wall
    distances) -- as ``xlb_tpu.kernels.collide_stream.spec_uses_aux``."""
    return (_names(spec.get("mw"), "aux") or _names(spec.get("value"), "aux", "aux_rho")
            or (spec["kind"] == "hybrid" and spec["use_dist"]))


def _names(x, *names):
    """True when the prescription ``x`` is one of the strings ``names``
    (it may also be a NumPy vector or a float)."""
    return isinstance(x, str) and x in names


def aux_layout(bc_specs, vs, base=0):
    """The channel layout of the aux field shared by the kernel body and
    ``fused_step.build_aux_field``, as ``xlb_tpu``'s ``aux_layout``: d
    velocity channels first (spatial prescribed-velocity and moving-wall
    BCs), then one prescribed-density channel (spatial pressure BCs), then
    one block of q wall-distance weights per hybrid BC with distances,
    keyed by BC id. ``base`` shifts the whole layout: the field modes
    (``FIELDS``) put their d per-voxel channels (the advecting velocity,
    or the force) at 0 and the BCs' channels after them (base = d).
    Returns (u_off, rho_off, w_offs, nchan), an offset None when no BC
    needs that channel; ``nchan`` includes the ``base`` prefix."""
    has_u = any(_names(s.get("mw"), "aux") or _names(s.get("value"), "aux") for s in bc_specs)
    has_rho = any(_names(s.get("value"), "aux_rho") for s in bc_specs)
    u_off = base if has_u else None
    off = base + (vs.d if has_u else 0)
    rho_off = off if has_rho else None
    off += 1 if has_rho else 0
    w_offs = {}
    for s in bc_specs:
        if s["kind"] == "hybrid" and s["use_dist"]:
            w_offs[s["id"]] = off
            off += vs.q
    return u_off, rho_off, w_offs, off


# the field modes of the fused step (K1, K3), their per-voxel field at aux
# channels [0, d): "ade" the advection-diffusion step (the advecting
# velocity; BGK relaxation to the linear equilibrium of the scalar),
# "extern_force" the exact-difference force f += feq(rho, u + F) -
# feq(rho, u)
FIELDS = ("ade", "extern_force")


def field_base(field, vs):
    """The aux channel where a scene's BC channels start: d under a field
    mode, 0 without one."""
    return vs.d if field is not None else 0


def outflow_cs():
    """The extrapolation outflow's sound speed 1 / sqrt(3) in float32."""
    return float(np.float32(1.0 / np.sqrt(3.0)))


def packed_cell(cell_type, q):
    """The packed int32 value of a cell of type ``cell_type`` with no
    missing directions, as a Python int with int32 wraparound."""
    v = kernel_bc_id(cell_type, q) << bc_id_shift(q)
    return v - (1 << 32) if v >= (1 << 31) else v


def unpack_bc_id(packed, q):
    """Extract the BC id field from a packed int32 mask tensor."""
    return (packed >> bc_id_shift(q)) & bc_id_mask(q)


def kernel_collision_spec(stepper):
    """The collision argument of the fused kernels: the collision-type
    string when the operator has no parameters, else ``(string, params)``
    with the operator's constructor parameters (TRT magic, MRT rates and
    projectors, Smagorinsky coefficient, PowerLaw consistency, index and
    iterations), so the kernels match the TORCH tier exactly."""
    ct = stepper.collision_type
    inner = getattr(stepper.collision, "collision_operator", stepper.collision)  # unwrap ForcedCollision
    if ct == "TRT":
        return (ct, {"magic": inner.magic})
    if ct == "MRT":
        return (ct, {"fixed": inner.fixed_projectors, "bulk_rate": inner.bulk_rate, "ghost_rate": inner.ghost_rate})
    if ct == "SmagorinskyLESBGK":
        return (ct, {"smagorinsky_coef": inner.smagorinsky_coef})
    if ct == "PowerLawBGK":
        return (ct, {"consistency": inner.consistency, "power_index": inner.power_index,
                     "iterations": inner.iterations})
    return ct


def split_collision(collision):
    """(collision-type string, params dict) of a ``kernel_collision_spec``."""
    return collision if isinstance(collision, tuple) else (collision, {})


def collision_constants(collision):
    """The float32 constants of a collision's kernel body, derived on the
    host once, as the kernels and the plain version read them."""
    name, params = split_collision(collision)
    f32 = np.float32
    if name == "TRT":
        return {"magic": float(f32(params.get("magic", 0.25)))}
    if name == "SmagorinskyLESBGK":
        cs = f32(params.get("smagorinsky_coef", 0.17))
        return {"c36": float(f32(36.0 * cs * cs))}  # 36 Cs^2
    if name == "PowerLawBGK":
        return {"k3": float(f32(3.0 * f32(params["consistency"]))),
                "nm1": float(f32(params["power_index"] - 1.0)), "eps": float(f32(1e-12)),
                "iterations": int(params.get("iterations", 5))}
    if name == "MRT":
        return {"fixed": [(float(f32(s)), P) for s, P in params["fixed"]]}
    return {}


def f32_weights(vs):
    """The velocity set's weights rounded to float32, as Python floats (the
    constants the kernel body adds and subtracts in shifted storage)."""
    return [float(x) for x in vs._w.astype(np.float32)]


def _moments(f_s, c, q, d):
    rho = f_s[0]
    for l in range(1, q):
        rho = rho + f_s[l]
    inv_rho = 1.0 / rho
    u = []
    for a in range(d):
        acc = None
        for l in range(q):
            if c[a, l] == 0:
                continue
            t = f_s[l] if c[a, l] == 1 else -f_s[l]
            acc = t if acc is None else acc + t
        u.append(acc * inv_rho)
    return rho, u


def _equilibrium(rho, u, c, w, opp, q, d):
    # pair-shared Hermite form: for a direction l and its opposite o,
    # w_l == w_o and c_o = -c_l, so feq_{l,o} = rho w (t +- cu3) with the
    # shared even part t = (1 - 1.5 u^2) + cu3^2 / 2
    usqr = u[0] * u[0]
    for a in range(1, d):
        usqr = usqr + u[a] * u[a]
    base = 1.0 - 1.5 * usqr
    feq = [None] * q
    for l in range(q):
        if feq[l] is not None:
            continue
        cu = None
        for a in range(d):
            if c[a, l] == 0:
                continue
            t = u[a] if c[a, l] == 1 else -u[a]
            cu = t if cu is None else cu + t
        rw = rho * w[l]
        if cu is None:
            feq[l] = rw * base
            continue
        cu3 = 3.0 * cu
        even = base + 0.5 * (cu3 * cu3)
        feq[l] = rw * (even + cu3)
        o = int(opp[l])
        if feq[o] is None:
            feq[o] = rw * (even - cu3)
    return feq


def _linear_equilibrium(rho, u, c, w, opp, q, d):
    # pair-shared linear form of the advection-diffusion step, as
    # xlb_tpu's kernel body: geq_{l,o} = rho w (1 +- 3 c_l . u)
    feq = [None] * q
    for l in range(q):
        if feq[l] is not None:
            continue
        cu = _cu_list(c, l, d, u)
        rw = rho * w[l]
        if cu is None:
            feq[l] = rw
            continue
        cu3 = 3.0 * cu
        feq[l] = rw * (1.0 + cu3)
        o = int(opp[l])
        if feq[o] is None:
            feq[o] = rw * (1.0 - cu3)
    return feq


def second_moment(vs, fneq):
    """Packed upper-triangular Pi = sum_l cc_l fneq_l, as a list."""
    cc = vs._cc  # (q, nt)
    pis = []
    for t in range(cc.shape[1]):
        acc = None
        for l in range(vs.q):
            coef = cc[l, t]
            if coef == 0:
                continue
            term = fneq[l] if coef == 1 else (-fneq[l] if coef == -1 else fneq[l] * float(np.float32(coef)))
            acc = term if acc is None else acc + term
        pis.append(acc if acc is not None else torch.zeros_like(fneq[0]))
    return pis


def _f32(x):
    """A float64 constant rounded to float32, as the kernels hold it."""
    return float(np.float32(x))


def _zouhe_epilogue(vs, spec, on, missing, f_s, w, aux=None, u_off=None, rho_off=None):
    """Zou-He / regularized closure, term by term as ``xlb_tpu``'s kernel
    body (``_zouhe_epilogue``): a constant prescription, or ``"aux"`` /
    ``"aux_rho"`` -- the per-voxel velocity or density of the aux field
    ``aux`` (nchan, *s) at channel ``u_off`` / ``rho_off``."""
    q, d, c, opp = vs.q, vs.d, vs._c, vs._opp_indices
    miss_f = [missing(l).to(torch.float32) for l in range(q)]
    known_f = [miss_f[opp[l]] for l in range(q)]
    middle_f = [1.0 - torch.maximum(miss_f[l], known_f[l]) for l in range(q)]

    fsum = None
    for l in range(q):
        term = f_s[l] * middle_f[l] + 2.0 * f_s[l] * known_f[l]
        fsum = term if fsum is None else fsum + term

    # inward normal from the missing main directions
    normals = []
    for a in range(d):
        acc = None
        for l in vs.main_indices:
            if c[a, l] == 0:
                continue
            t = miss_f[l] if c[a, l] == 1 else -miss_f[l]
            acc = t if acc is None else acc + t
        normals.append(-acc)

    if spec["bc_type"] == "velocity":
        if _names(spec["value"], "aux"):  # per-voxel prescribed velocity
            u = [aux[u_off + a] for a in range(d)]
            unormal = normals[0] * u[0]
            for a in range(1, d):
                unormal = unormal + normals[a] * u[a]
        else:
            vel = spec["value"]  # (d,) float64
            unormal = None
            for a in range(d):
                if vel[a] == 0.0:
                    continue
                t = normals[a] * _f32(vel[a])
                unormal = t if unormal is None else unormal + t
            if unormal is None:
                unormal = torch.zeros_like(fsum)
            u = [torch.full_like(fsum, _f32(vel[a])) for a in range(d)]
        rho = fsum / (1.0 + unormal)
    else:
        if _names(spec["value"], "aux_rho"):  # per-voxel prescribed density
            rho = aux[rho_off] + torch.zeros_like(fsum)
        else:
            rho = torch.full_like(fsum, _f32(spec["value"]))
        unormal = -1.0 + fsum / rho
        u = [unormal * normals[a] for a in range(d)]

    feq = _equilibrium(rho, u, c, w, opp, q, d)
    f_bd = [torch.where(missing(l), f_s[opp[l]] + feq[l] - feq[opp[l]], f_s[l]) for l in range(q)]

    if spec["kind"] == "regularized":
        pi = second_moment(vs, [f_bd[l] - feq[l] for l in range(q)])
        qi = vs._qi  # (q, nt)
        out = []
        for l in range(q):
            qipi = None
            for t in range(qi.shape[1]):
                if qi[l, t] == 0:
                    continue
                term = pi[t] * _f32(qi[l, t])
                qipi = term if qipi is None else qipi + term
            out.append(feq[l] + _f32(4.5 * vs._w[l]) * qipi)
        f_bd = out
    return [torch.where(on, f_bd[l], f_s[l]) for l in range(q)]


def _cu_list(c, l, d, u):
    """c_l . u as a sum of +-u_a in axis order, or None when c_l = 0."""
    cu = None
    for a in range(d):
        if c[a, l] == 0:
            continue
        t = u[a] if c[a, l] == 1 else -u[a]
        cu = t if cu is None else cu + t
    return cu


def _qi_contract(vs, pi):
    """Q_l : Pi per direction l, every coefficient as a product (a list of
    q slabs), as ``xlb_tpu``'s body contracts it."""
    qi = vs._qi
    out = []
    for l in range(vs.q):
        acc = None
        for t in range(qi.shape[1]):
            if qi[l, t] == 0:
                continue
            term = pi[t] * _f32(qi[l, t])
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def _regularize_list(vs, f_bd, feq):
    """Latt-Chopard: feq_l + 4.5 w_l Q_l : Pi_neq."""
    qipi = _qi_contract(vs, second_moment(vs, [f_bd[l] - feq[l] for l in range(vs.q)]))
    return [feq[l] + _f32(4.5 * vs._w[l]) * qipi[l] if qipi[l] is not None else feq[l] for l in range(vs.q)]


def _hybrid_epilogue(vs, spec, on, missing, f_s, f_pre, w, aux=None, u_off=None, w_offs=None):
    """The hybrid curved-boundary closure, term by term as ``xlb_tpu``'s
    kernel body (``_hybrid_epilogue``): Yu-Mei-Shyy interpolated
    bounce-back (plain bounce-back where both l and opp(l) are missing),
    then nothing, Latt-Chopard regularization or Grad's approximation of
    the missing populations; or Tao's one-point closure, then
    regularization. The weights t_l ride the aux field's block
    ``w_offs[id]`` when the BC has distances, else t = 1/2; a moving wall
    is a static 6 w_l (c_l . u) or the aux field's velocity."""
    q, d, c, opp = vs.q, vs.d, vs._c, vs._opp_indices
    method, use_dist, mw = spec["method"], spec["use_dist"], spec["mw"]
    miss = [missing(l) for l in range(q)]
    u_aux = [aux[u_off + a] for a in range(d)] if _names(mw, "aux") else None

    def mw_term(l):
        if mw is None:
            return None
        if u_aux is not None:
            cu = _cu_list(c, l, d, u_aux)
            return None if cu is None else _f32(6.0 * vs._w[l]) * cu
        return _f32(mw[l])

    if use_dist:
        t_w = [aux[w_offs[spec["id"]] + l] for l in range(q)]
    else:
        t_w = [0.5] * q  # only the Tao closure reads these

    if method != "nonequilibrium_regularized":
        f_bd = []
        for l in range(q):
            o = int(opp[l])
            if use_dist:
                interp = ((1.0 - t_w[l]) * f_s[o] + t_w[l] * (f_pre(l) + f_pre(o))) / (1.0 + t_w[l])
                interp = torch.where(miss[l] & miss[o], f_pre(o), interp)  # sandwich: plain bounce-back
            else:
                interp = f_pre(o)
            mwl = mw_term(l)
            if mwl is not None:
                interp = interp + mwl
            f_bd.append(torch.where(miss[l], interp, f_s[l]))
        if method == "bounceback":
            return [torch.where(on, f_bd[l], f_s[l]) for l in range(q)]
        rho, u = _moments(f_bd, c, q, d)
        if method == "bounceback_regularized":
            f_bd = _regularize_list(vs, f_bd, _equilibrium(rho, u, c, w, opp, q, d))
        else:  # Grad's approximation for the missing populations
            pi = second_moment(vs, f_bd)
            diag = vs.diagonal_moment_indices
            qipi = _qi_contract(vs, [pi[t] - rho / 3.0 if t in diag else pi[t] for t in range(len(pi))])
            for l in range(q):
                cu = _cu_list(c, l, d, u)
                grads = rho * w[l] * (1.0 if cu is None else 1.0 + 3.0 * cu)
                if qipi[l] is not None:
                    grads = grads + _f32(4.5 * vs._w[l]) * qipi[l]
                f_bd[l] = torch.where(miss[l], grads, f_bd[l])
    else:  # Tao et al.'s one-point closure
        fp = [f_pre(l) for l in range(q)]
        rho_p, u_p = _moments(fp, c, q, d)
        feq_p = _equilibrium(rho_p, u_p, c, w, opp, q, d)
        if u_aux is not None:
            feq_w = _equilibrium(rho_p, u_aux, c, w, opp, q, d)
        elif mw is not None:
            feq_w = _equilibrium(rho_p, [torch.full_like(rho_p, _f32(x)) for x in spec["u_wall"]], c, w, opp, q, d)
        else:
            feq_w = [w[l] * rho_p for l in range(q)]
        f_bd = []
        for l in range(q):
            o = int(opp[l])
            f_wall = feq_w[l] + (fp[o] - feq_p[o])
            f_bd.append(torch.where(miss[l], (f_wall + t_w[l] * fp[l]) / (1.0 + t_w[l]), f_s[l]))
        rho2, u2 = _moments(f_bd, c, q, d)
        f_bd = _regularize_list(vs, f_bd, _equilibrium(rho2, u2, c, w, opp, q, d))
    return [torch.where(on, f_bd[l], f_s[l]) for l in range(q)]


def _scalar_f32(x, like):
    """A float or tensor as float32 on ``like``'s device (the kernels hold
    omega and the per-voxel rates in float32)."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _strain(pi, d):
    diag, offd = ((0, 3, 5), (1, 2, 4)) if d == 3 else ((0, 2), (1,))
    acc_d = pi[diag[0]] * pi[diag[0]]
    for t in diag[1:]:
        acc_d = acc_d + pi[t] * pi[t]
    acc_o = pi[offd[0]] * pi[offd[0]]
    for t in offd[1:]:
        acc_o = acc_o + pi[t] * pi[t]
    return acc_d + 2.0 * acc_o


def collide(vs, collision, f_s, feq, rho, omega):
    """The collision of the kernel body (``_build_kernel_body.collide``)
    on the lists of post-streaming and equilibrium slabs; float32."""
    name, _ = split_collision(collision)
    k = collision_constants(collision)
    q, d, opp = vs.q, vs.d, vs._opp_indices
    if name == "BGK":
        return [f_s[l] - omega * (f_s[l] - feq[l]) for l in range(q)]
    om = _scalar_f32(omega, f_s[0])
    fneq = [f_s[l] - feq[l] for l in range(q)]
    if name == "TRT":
        # even part at omega, odd part at omega_minus, per opposite pair
        om_m = 1.0 / (k["magic"] / (1.0 / om - 0.5) + 0.5)
        out = [None] * q
        for l in range(q):
            o = int(opp[l])
            if out[l] is not None:
                continue
            if o == l:
                out[l] = f_s[l] - om * (f_s[l] - feq[l])
                continue
            h_even = om * (0.5 * (f_s[l] + f_s[o]) - 0.5 * (feq[l] + feq[o]))
            h_odd = om_m * (0.5 * (f_s[l] - f_s[o]) - 0.5 * (feq[l] - feq[o]))
            out[l] = f_s[l] - h_even - h_odd
            out[o] = f_s[o] - h_even + h_odd
        return out
    if name == "MRT":
        # BGK plus one projector correction per fixed-rate group: unrolled
        # rows, entries below 1e-14 skipped, +-1 as adds
        out = [f_s[l] - om * fneq[l] for l in range(q)]
        for rate, P in k["fixed"]:
            coef = om - rate
            for i in range(q):
                acc = None
                for j in range(q):
                    m = float(P[i, j])
                    if abs(m) < 1e-14:
                        continue
                    t = fneq[j] if m == 1.0 else (-fneq[j] if m == -1.0 else fneq[j] * _f32(m))
                    acc = t if acc is None else acc + t
                if acc is not None:
                    out[i] = out[i] + coef * acc
        return out
    pi = second_moment(vs, fneq)
    if name == "SmagorinskyLESBGK":
        tau0 = 1.0 / om
        tau = 0.5 * (tau0 + torch.sqrt(tau0 * tau0 + k["c36"] * torch.sqrt(_strain(pi, d))))
        om_loc = 1.0 / tau
        return [f_s[l] - om_loc * fneq[l] for l in range(q)]
    if name == "PowerLawBGK":
        a_sh = 1.5 * torch.sqrt(2.0 * _strain(pi, d)) / rho
        k3, nm1 = _scalar_f32(k["k3"], a_sh), _scalar_f32(k["nm1"], a_sh)
        tau = torch.broadcast_to(1.0 / om, a_sh.shape)
        for _ in range(k["iterations"]):
            tau = k3 * torch.pow(a_sh / tau + k["eps"], nm1) + 0.5
        om_loc = torch.clamp(1.0 / tau, 0.05, 1.99)
        return [f_s[l] - om_loc * fneq[l] for l in range(q)]
    if name == "KBC":
        ds = kbc_shear(q, pi)
        beta = 0.5 * om
        inv_beta = 1.0 / beta
        dh = [fneq[l] if ds[l] is None else fneq[l] - ds[l] for l in range(q)]
        # entropic products <ds, dh> and <dh, dh> weighted by 1 / feq, one
        # reciprocal per opposite pair (ds is even: ds_l == ds_opp)
        sp1 = sp2 = None
        for l in range(q):
            o = int(opp[l])
            if o < l:
                continue
            if o == l:
                tmp = dh[l] * (1.0 / feq[l])
                t1 = None if ds[l] is None else tmp * ds[l]
                t2 = tmp * dh[l]
            else:
                inv = 1.0 / (feq[l] * feq[o])
                a = dh[l] * feq[o]
                b = dh[o] * feq[l]
                t1 = None if ds[l] is None else ds[l] * ((a + b) * inv)
                t2 = (dh[l] * a + dh[o] * b) * inv
            if t1 is not None:
                sp1 = t1 if sp1 is None else sp1 + t1
            sp2 = t2 if sp2 is None else sp2 + t2
        gamma = inv_beta - (2.0 - inv_beta) * sp1 * (1.0 / (_f32(1e-32) + sp2))
        return [f_s[l] - beta * (gamma * dh[l]) if ds[l] is None else f_s[l] - beta * (2.0 * ds[l] + gamma * dh[l])
                for l in range(q)]
    raise NotImplementedError(f"collision {name!r} is not ported to the fused step")


def pointwise_core(vs, bc_specs, fs_raw, fp_raw, packed, omega, shifted=False, has_solids=True, collision="BGK",
                   force_vector=None, aux=None, staging_read=None, field=None):
    """Per-voxel physics given already-gathered populations (float32).

    ``fs_raw[l]`` is the raw (store-form) pulled slab of direction l;
    ``fp_raw(l)`` returns the raw centered (pre-streaming) slab. ``packed``
    is the int32 mask of ``fused_step.pack_masks``. ``omega`` is a float
    (rounded to float32, as the kernels read it) or a float32 tensor that
    broadcasts against the slabs: a 0-d tensor, or the per-voxel field
    through which the adjoint takes omega's cotangent. ``collision`` is a
    ``kernel_collision_spec``; ``force_vector`` a constant body force or
    None. ``aux`` is the (nchan, *s) float32 aux field of the BCs with
    per-voxel prescriptions (``aux_layout``), or None. ``staging_read(m,
    t)`` returns the raw slab of direction m pulled from x - t (``t`` a
    d-tuple with |t_a| <= 1): the extrapolation outflow's post-collision
    staging reads the pre-streaming population m at x - n - c_m through it,
    the only read of the body that is not voxel-local. ``field`` (one of
    ``FIELDS``, or None) reads aux channels [0, d): "ade" relaxes (BGK,
    ``omega``) to the linear equilibrium of phi = sum f with that advecting
    velocity, "extern_force" adds the exact-difference force of that
    per-voxel F; the BCs' channels then start at d. Returns the list of
    post-collision slabs (unshifted, uncast)."""
    q, d = vs.q, vs.d
    c, opp = vs._c, vs._opp_indices
    w = f32_weights(vs)
    if not isinstance(omega, torch.Tensor):
        omega = float(np.float32(omega))
    u_off, rho_off, w_offs, _ = aux_layout(bc_specs, vs, field_base(field, vs))
    bc = unpack_bc_id(packed, q)
    f_s = [fs_raw[l] + w[l] if shifted else fs_raw[l] for l in range(q)]

    def f_pre(l):
        return fp_raw(l) + w[l] if shifted else fp_raw(l)

    def missing(l):
        return ((packed >> l) & 1) == 1

    for spec in bc_specs:
        if spec["step"] != "streaming":
            continue
        on = bc == kernel_bc_id(spec["id"], q)
        kind = spec["kind"]
        if kind == "equilibrium":
            f_s = [torch.where(on, float(spec["feq"][l]), f_s[l]) for l in range(q)]
        elif kind == "do_nothing":
            f_s = [torch.where(on, f_pre(l), f_s[l]) for l in range(q)]
        elif kind == "halfway":
            mw = spec.get("mw")
            for l in range(q):
                if _names(mw, "aux"):
                    # per-voxel moving wall: 6 w_l (c_l . u_wall(x))
                    cu = None
                    for a in range(d):
                        if c[a, l] == 0:
                            continue
                        t = aux[u_off + a] if c[a, l] == 1 else -aux[u_off + a]
                        cu = t if cu is None else cu + t
                    refl = f_pre(opp[l]) if cu is None else f_pre(opp[l]) + _f32(6.0 * vs._w[l]) * cu
                else:
                    refl = f_pre(opp[l]) if mw is None else f_pre(opp[l]) + _f32(mw[l])
                f_s[l] = torch.where(on & missing(l), refl, f_s[l])
        elif kind == "free_slip":
            # specular reflection: a missing direction that crosses the wall
            # takes the pre-streaming population of its mirror
            for l in range(q):
                if spec["reflect_dirs"][l]:
                    f_s[l] = torch.where(on & missing(l), f_pre(int(spec["spec_indices"][l])), f_s[l])
        elif kind in ("zouhe", "regularized"):
            f_s = _zouhe_epilogue(vs, spec, on, missing, f_s, w, aux, u_off, rho_off)
        elif kind == "hybrid":
            f_s = _hybrid_epilogue(vs, spec, on, missing, f_s, f_pre, w, aux, u_off, w_offs)
        elif kind == "extrapolation_outflow":
            # missing directions take the values staged in the outgoing
            # slots by the previous step
            for l in range(q):
                f_s[l] = torch.where(on & missing(l), f_pre(opp[l]), f_s[l])
        else:
            raise NotImplementedError(f"BC kind {kind!r} is not ported to the fused step")

    if field == "ade":
        # the transported scalar phi = sum g and the advecting velocity of
        # the aux field's first d channels; BGK to the linear equilibrium
        rho = f_s[0]
        for l in range(1, q):
            rho = rho + f_s[l]
        feq = _linear_equilibrium(rho, [aux[a] for a in range(d)], c, w, opp, q, d)
        f_out = [f_s[l] - omega * (f_s[l] - feq[l]) for l in range(q)]
    else:
        rho, u = _moments(f_s, c, q, d)
        feq = _equilibrium(rho, u, c, w, opp, q, d)
        f_out = collide(vs, collision, f_s, feq, rho, omega)

    # exact-difference body force with the pre-collision rho and u:
    # f += feq(rho, u + F) - feq(rho, u), F constant or the aux field's
    if force_vector is not None or field == "extern_force":
        if field == "extern_force":
            u_f = [u[a] + aux[a] for a in range(d)]
        else:
            u_f = [u[a] + _f32(force_vector[a]) for a in range(d)]
        feq_f = _equilibrium(rho, u_f, c, w, opp, q, d)
        f_out = [f_out[l] + (feq_f[l] - feq[l]) for l in range(q)]

    for spec in bc_specs:
        if spec["step"] != "collision":
            continue
        if spec["kind"] != "fullway":
            raise NotImplementedError(f"BC kind {spec['kind']!r} is not ported to the fused step")
        on = bc == kernel_bc_id(spec["id"], q)
        f_out = [torch.where(on, f_s[opp[l]], f_out[l]) for l in range(q)]

    # extrapolation outflow: stage cs f_s[m](x - n) + (1 - cs) f_s[m](x)
    # in the outgoing slot l = opp(m) of each missing m. f_s[m](x - n) is
    # the pre-streaming m at x - t, t = n + c_m, tangential wherever m is
    # missing at the face (|t_a| <= 1).
    for spec in bc_specs:
        if spec["kind"] != "extrapolation_outflow":
            continue
        on = bc == kernel_bc_id(spec["id"], q)
        n = [int(x) for x in spec["normal"]]
        cs = outflow_cs()
        cs1 = float(np.float32(1.0) - np.float32(cs))
        for l in range(q):
            m = int(opp[l])
            t = tuple(n[a] + int(c[a, m]) for a in range(d))
            if any(abs(x) > 1 for x in t):
                continue  # c_m . n >= 1: never a staged slot at this face
            neighbour = staging_read(m, t)
            if shifted:
                neighbour = neighbour + w[m]
            f_out[l] = torch.where(on & missing(m), cs * neighbour + cs1 * f_s[m], f_out[l])

    # solid voxels keep their previous populations
    if has_solids:
        solid = bc == kernel_solid_id(q)
        f_out = [torch.where(solid, f_pre(l), f_out[l]) for l in range(q)]
    return f_out
