"""Packed-mask ABI and the plain per-voxel body of the fused kernels.

``pointwise_core`` is the plain torch version of the per-voxel physics of
``xlb_tpu.kernels.collide_stream._build_kernel_body`` for the epilogue
kinds this port supports: the streaming-step ``equilibrium``,
``halfway`` (constant moving wall), ``zouhe`` and ``regularized`` BCs
(constant prescriptions), the collision-step ``fullway`` BC, the solid
keep-out and shifted (g = f - w) load and store, around moments, the
pair-shared quadratic equilibrium and BGK. The CUDA kernels
(``csrc/collide_stream.cuh``) compute the same terms in the same order;
this version is what the CPU tests run and what ``chip_smoke.py`` holds
the kernels against.
"""

import numpy as np
import torch


def bc_id_shift(q):
    """Bit position of the BC id field in the packed int32 mask: the
    missing-direction bitfield occupies bits 0..q-1, and for q <= 19 bits
    19..26 hold the raw uint8 cell type. The q > 19 (D3Q27) layout is not
    ported yet."""
    if q > 19:
        raise NotImplementedError("the D3Q27 packed-mask layout is not ported yet")
    return 19


def bc_id_mask(q):
    """Bitmask of the BC id field width (after shifting)."""
    return 0xFF


def kernel_bc_id(bc_id, q):
    """Packed-mask kernel id of a cell-type code (identity for q <= 19)."""
    bc_id_shift(q)
    if not 0 <= bc_id <= 255:
        raise ValueError(f"BC id {bc_id} outside the uint8 cell-type space")
    return bc_id


def kernel_solid_id(q):
    """Packed id of cell type 255 (solid)."""
    bc_id_shift(q)
    return 255


def kernel_sfv_id(q):
    """Packed id of cell type 254 (the multires ghost ring and refined
    region: kept through the collide)."""
    bc_id_shift(q)
    return 254


def unpack_bc_id(packed, q):
    """Extract the BC id field from a packed int32 mask tensor."""
    return (packed >> bc_id_shift(q)) & bc_id_mask(q)


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


def _zouhe_epilogue(vs, spec, on, missing, f_s, w):
    """Zou-He / regularized closure with a constant prescription, term by
    term as ``xlb_tpu``'s kernel body (``_zouhe_epilogue``)."""
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
        vel = spec["value"]  # (d,) float64
        unormal = None
        for a in range(d):
            if vel[a] == 0.0:
                continue
            t = normals[a] * _f32(vel[a])
            unormal = t if unormal is None else unormal + t
        if unormal is None:
            unormal = torch.zeros_like(fsum)
        rho = fsum / (1.0 + unormal)
        u = [torch.full_like(fsum, _f32(vel[a])) for a in range(d)]
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


def pointwise_core(vs, bc_specs, fs_raw, fp_raw, packed, omega, shifted=False, has_solids=True):
    """Per-voxel physics given already-gathered populations (float32).

    ``fs_raw[l]`` is the raw (store-form) pulled slab of direction l;
    ``fp_raw(l)`` returns the raw centered (pre-streaming) slab. ``packed``
    is the int32 mask of ``fused_step.pack_masks``. ``omega`` is a float
    (rounded to float32, as the kernels read it) or a float32 tensor that
    broadcasts against the slabs: a 0-d tensor, or the per-voxel field
    through which the adjoint takes omega's cotangent. Returns the list of
    post-collision slabs (unshifted, uncast)."""
    q, d = vs.q, vs.d
    c, opp = vs._c, vs._opp_indices
    w = f32_weights(vs)
    if not isinstance(omega, torch.Tensor):
        omega = float(np.float32(omega))
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
        elif kind == "halfway":
            mw = spec.get("mw")
            for l in range(q):
                refl = f_pre(opp[l]) if mw is None else f_pre(opp[l]) + _f32(mw[l])
                f_s[l] = torch.where(on & missing(l), refl, f_s[l])
        elif kind in ("zouhe", "regularized"):
            f_s = _zouhe_epilogue(vs, spec, on, missing, f_s, w)
        else:
            raise NotImplementedError(f"BC kind {kind!r} is not ported to the fused step")

    rho, u = _moments(f_s, c, q, d)
    feq = _equilibrium(rho, u, c, w, opp, q, d)
    f_out = [f_s[l] - omega * (f_s[l] - feq[l]) for l in range(q)]

    for spec in bc_specs:
        if spec["step"] != "collision":
            continue
        if spec["kind"] != "fullway":
            raise NotImplementedError(f"BC kind {spec['kind']!r} is not ported to the fused step")
        on = bc == kernel_bc_id(spec["id"], q)
        f_out = [torch.where(on, f_s[opp[l]], f_out[l]) for l in range(q)]

    # solid voxels keep their previous populations
    if has_solids:
        solid = bc == kernel_solid_id(q)
        f_out = [torch.where(solid, f_pre(l), f_out[l]) for l in range(q)]
    return f_out
