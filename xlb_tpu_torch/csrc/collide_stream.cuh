// Per-voxel body shared by the fused collide-stream kernels: the 3D
// kernels of collide_stream_3d.cuh and collide_stream_blocked.cuh, the D2Q9
// kernels of collide_stream_2d.cu and, through its pieces
// (streamed_populations, moments_equilibrium, collide_physics,
// has_bc_kind, is_solid), the adjoint kernel of adjoint_step.cuh and the
// multires kernels. The epilogues and the physics are templates over the
// scalar F: float in the forward, the adjoint's Dual numbers there (the
// collision's and the epilogues' Jacobians in forward mode).
//
// It is the CUDA counterpart of the slice of
// xlb_tpu/kernels/collide_stream.py::_build_kernel_body that scenes with
// the ported BCs use (pointwise_core):
//
//   pulled populations (store form) -> shifted load (+ w_l, f32)
//   -> streaming-step epilogues: "equilibrium" (f_s := feq constant) and,
//      when the kernel is built with EXT, "halfway" (missing l reflects
//      the centred opp(l), plus a constant moving-wall term) and, with
//      EXT == kExtAll (the 2D kernels) or kExtOpen, "zouhe" and
//      "regularized" (constant velocity or density); with kExtOpen (the
//      3D open-boundary scenes) also per-voxel velocities and densities
//      from the aux field (zouhe, regularized, halfway's moving wall),
//      "do_nothing" (f_s := the centred populations), "free_slip" (missing
//      l takes the centred mirror of l across the wall) and
//      "extrapolation_outflow" (missing l takes the centred opp(l): the
//      value the previous step staged there); with kExtHybrid (the 3D
//      curved-wall scenes, and the 2D kernels' aux form) also "hybrid"
//      (hybrid_epilogue: interpolated bounce-back with the wall distances of
//      the aux field, then nothing, regularization or Grad's approximation;
//      or Tao's one-point closure, then regularization)
//   -> moments, pair-shared quadratic equilibrium, the collision
//   -> with FORCE, the exact-difference body force
//      f += feq(rho, u + F) - feq(rho, u) with the pre-collision rho, u
//   (the field modes, FIELD: kFieldAde replaces these three steps by the
//   advection-diffusion step -- phi = sum f, the advecting velocity of aux
//   channels [0, d), BGK to the pair-shared linear equilibrium -- and
//   kFieldForce takes the force F per voxel from aux channels [0, d);
//   the BCs' aux channels then start at d)
//   -> collision-step "fullway" epilogue (f_out[l] := f_s[opp[l]])
//   -> with kExtOpen, the outflow's staging: each missing m of an outflow
//      voxel x stages cs f_s[m](x - n) + (1 - cs) f_s[m](x) in the
//      outgoing slot opp(m), for the next step's epilogue to pick up; the
//      only read of the body that is not voxel-local (staged(m, t): the
//      pre-streaming m at x - t, t = n + c_m tangential, |t_a| <= 1)
//   -> solid keep-out (cell type 255 keeps its pre-streaming populations)
//   -> shifted store (- w_l, f32)
//
// The stencil is a compile-time trait (D3Q19, D3Q27, D2Q9): directions,
// opposites, main directions, the second-moment / Q_i constants and the
// packed-mask id field. The collision is a compile-time trait too (BGK,
// KBC, Smagorinsky, PowerLaw, TRT, MRT), in the form of xlb_tpu's kernel
// body: TRT per opposite pair, MRT as unrolled rows of compile-time
// projector tables without their zero entries, KBC with one IEEE
// reciprocal per opposite pair. EXT and FORCE are compile-time switches,
// so the instantiations that run no such BC or force compile without them.
// The open epilogues read the aux field through aux(channel), at the
// voxels of their BC alone, so the other voxels pay no bytes for it.
//
// The arithmetic follows the Python body term by term (same summation
// order, same pair-shared equilibrium), so the kernels agree with the plain
// torch version in xlb_tpu_torch/kernels/collide_stream.py to f32 roundoff;
// nvcc's FMA contraction is the only difference.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#include "dual.cuh"
#include "mrt_projectors.cuh"

#define XLB_MAX_Q 27
#define XLB_SOLID_ID 255  // packed solid id of D3Q19 and D2Q9 (cell type 255); D3Q27's is D3Q27::solid_id

enum : int {
  XLB_BC_EQUILIBRIUM = 0,
  XLB_BC_FULLWAY = 1,
  XLB_BC_HALFWAY = 2,
  XLB_BC_ZOUHE = 3,
  XLB_BC_REGULARIZED = 4,
  XLB_BC_DO_NOTHING = 5,
  XLB_BC_FREE_SLIP = 6,
  XLB_BC_OUTFLOW = 7,  // extrapolation outflow
  XLB_BC_HYBRID = 8,   // curved wall (HybridBC)
};

// XlbBc::flag of the kExtOpen epilogues: bit 0 a pressure (density) BC,
// bit 1 a per-voxel prescription, read from the aux field's channels from
// flag >> XLB_FLAG_AUX_SHIFT on (the velocity's first, or the density).
enum : int { XLB_FLAG_PRESSURE = 1, XLB_FLAG_AUX = 2, XLB_FLAG_AUX_SHIFT = 8 };

// XlbBc::flag of a "hybrid" BC: the method in bits 0-1 (XLB_HYB_*), the
// wall distances in bit 2, the moving wall in bits 3-4 (0 none; 1 static:
// vec holds 6 w_l (c_l . u); 2 per voxel: vec holds 6 w_l and the aux
// field the velocity), the first weight channel in bits 8-19, the first
// velocity channel in bits 20-30.
enum : int { XLB_HYB_BOUNCEBACK = 0, XLB_HYB_REGULARIZED = 1, XLB_HYB_GRADS = 2, XLB_HYB_TAO = 3 };
enum : int { XLB_HYB_DIST = 4, XLB_HYB_MW_SHIFT = 3, XLB_HYB_W_SHIFT = 8, XLB_HYB_U_SHIFT = 20 };

enum : int {
  XLB_COLL_BGK = 0,
  XLB_COLL_KBC = 1,
  XLB_COLL_SMAGORINSKY = 2,
  XLB_COLL_TRT = 3,
  XLB_COLL_MRT = 4,
  XLB_COLL_POWERLAW = 5,
};

// The packed id field's reach: a scene's BCs have distinct ids, at most
// 253 of the uint8 cell types (D3Q19, D2Q9) and 29 of D3Q27's 5-bit field.
#define XLB_MAX_BC 256

// The constant prescription of one BC. The kernels read it only at voxels
// of the BC.
struct XlbBc {
  int flag;               // halfway: 1 = moving wall, XLB_FLAG_AUX: per voxel; zouhe / regularized: XLB_FLAG_*
  float vec[XLB_MAX_Q];   // equilibrium: the prescribed feq; halfway: 6 w_l (c_l . u_wall), or 6 w_l when
                          // per voxel; zouhe / regularized: the velocity, or the density in [0]; free_slip and
                          // extrapolation_outflow: the outward normal in [0..2], the outflow's cs in [3]
};

// Launch parameters: the f32 weights, the BCs' kinds, ids and
// prescriptions, the solid flag and the collision's constants, all by
// value in the kernel's constant bank. Plain int/float members only, so the
// ctypes mirror in xlb_tpu_torch/kernels/_cuda.py has the same layout. A
// scene takes as many BCs as the stencil's packed id field carries, as
// xlb_tpu's kernel body does: 31 KB, under the 32,764-byte parameter limit
// of CUDA 12.1 and later on sm_70 and later.
struct XlbStepParams {
  float w[XLB_MAX_Q];
  float w45[XLB_MAX_Q];  // 4.5 w_l rounded once to f32 (regularized)
  int has_solids;
  int n_bc;
  // read by the kernels of the 3D collision zoo (collide_stream_3d.cuh)
  int q;            // the stencil of the launch: 9, 19 or 27
  int collision;    // XLB_COLL_*
  int walled;       // 1: the instantiation with the halfway epilogue and the force term; 2: kExtOpen
  int has_force;
  float force[3];   // the body force F (exact difference)
  float coll[3];    // TRT: [0] the magic Lambda; Smagorinsky: [0] 36 Cs^2;
                    // PowerLaw: [0] 3K, [1] n - 1, [2] eps (all f32, from the host)
  int coll_iters;   // PowerLaw: the fixed-point iterations
  int mrt_on[2];    // MRT: the bulk / ghost group relaxes at its own rate
  float mrt_rate[2];
  // last: the fields above are read at every voxel, and placed behind the
  // 28 KB of prescriptions they cost K2 2-3% (PERF.md)
  int bc_kind[XLB_MAX_BC];  // XLB_BC_*
  int bc_id[XLB_MAX_BC];    // the packed id (cell_type) the BC claims
  XlbBc bc[XLB_MAX_BC];     // read only at the voxels of each BC
};
static_assert(sizeof(XlbStepParams) + 256 <= 32764, "XlbStepParams and a kernel's other arguments exceed 32,764 B");

namespace xlb {

// D3Q19 in xlb_tpu's direction order (itertools.product([0, -1, 1], repeat=3)
// with |c|_1 <= 2); the wrapper checks the velocity set against this table.
struct D3Q19 {
  static constexpr int d = 3, q = 19;
  // packed mask: missing bits 0..q-1, the raw cell type in bits 19..26
  static constexpr int id_shift = 19, id_mask = 0xFF, solid_id = 255, sfv_id = 254;
  __host__ __device__ static constexpr int c(int a, int l) {
    constexpr int kC[3][19] = {
        {0, 0, 0, 0, 0, 0, 0, 0, 0, -1, -1, -1, -1, -1, 1, 1, 1, 1, 1},
        {0, 0, 0, -1, -1, -1, 1, 1, 1, 0, 0, 0, -1, 1, 0, 0, 0, -1, 1},
        {0, -1, 1, 0, -1, 1, 0, -1, 1, 0, -1, 1, 0, 0, 0, -1, 1, 0, 0},
    };
    return kC[a][l];
  }
  __host__ __device__ static constexpr int opp(int l) {
    constexpr int kOpp[19] = {0, 2, 1, 6, 8, 7, 3, 5, 4, 14, 16, 15, 18, 17, 9, 11, 10, 13, 12};
    return kOpp[l];
  }
  // MRT: out += coef P_g fneq for the bulk (g = 0) or ghost (g = 1) group
  template <typename F>
  __device__ __forceinline__ static void mrt_rows(int g, const F* fneq, F coef, F* out) {
    if (g == 0) mrt_d3q19_bulk(fneq, coef, out);
    else mrt_d3q19_ghost(fneq, coef, out);
  }
};

// D2Q9 in xlb_tpu's direction order (velocity_set/stencils.py).
struct D2Q9 {
  static constexpr int d = 2, q = 9;
  static constexpr int id_shift = 19, id_mask = 0xFF, solid_id = 255, sfv_id = 254;
  __host__ __device__ static constexpr int c(int a, int l) {
    constexpr int kC[2][9] = {
        {0, 0, 0, 1, -1, 1, -1, 1, -1},
        {0, 1, -1, 0, 1, -1, 0, 1, -1},
    };
    return kC[a][l];
  }
  __host__ __device__ static constexpr int opp(int l) {
    constexpr int kOpp[9] = {0, 2, 1, 6, 5, 4, 3, 8, 7};
    return kOpp[l];
  }
};

// D3Q27 in xlb_tpu's direction order (itertools.product([0, -1, 1],
// repeat=3)): l = 9 i_x + 3 i_y + i_z with digit 0, 1, 2 for 0, -1, +1.
struct D3Q27 {
  static constexpr int d = 3, q = 27;
  // packed mask: missing bits 0..26, a 5-bit id in bits 27..31 (ids 0..29,
  // 254 -> 30, 255 -> 31), as xlb_tpu packs it
  static constexpr int id_shift = 27, id_mask = 31, solid_id = 31, sfv_id = 30;
  __host__ __device__ static constexpr int digit(int a, int l) {
    return a == 0 ? l / 9 : (a == 1 ? (l / 3) % 3 : l % 3);
  }
  __host__ __device__ static constexpr int c(int a, int l) {
    return digit(a, l) == 0 ? 0 : (digit(a, l) == 1 ? -1 : 1);
  }
  __host__ __device__ static constexpr int opp(int l) {
    return 9 * ((3 - digit(0, l)) % 3) + 3 * ((3 - digit(1, l)) % 3) + (3 - digit(2, l)) % 3;
  }
  template <typename F>
  __device__ __forceinline__ static void mrt_rows(int g, const F* fneq, F coef, F* out) {
    if (g == 0) mrt_d3q27_bulk(fneq, coef, out);
    else mrt_d3q27_ghost(fneq, coef, out);
  }
};

// Derived stencil constants, as VelocitySet derives them in NumPy.
// Main directions: |c_l|_1 == 1.
template <class S>
__host__ __device__ constexpr bool is_main(int l) {
  int n = 0;
  for (int a = 0; a < S::d; ++a) n += S::c(a, l) < 0 ? -S::c(a, l) : S::c(a, l);
  return n == 1;
}

// Second-moment basis: entry t of the packed upper triangle (xx, xy, [xz,]
// yy, [yz, zz]) is the pair (ma, mb); cc_l,t = c_la c_lb.
template <class S>
__host__ __device__ constexpr int n_moments() { return S::d * (S::d + 1) / 2; }

template <class S>
__host__ __device__ constexpr int cc(int l, int t) {
  int a = 0, b = 0, i = 0;
  for (int x = 0; x < S::d; ++x)
    for (int y = x; y < S::d; ++y, ++i)
      if (i == t) a = x, b = y;
  return S::c(a, l) * S::c(b, l);
}

template <class S>
__host__ __device__ constexpr bool is_diagonal(int t) {
  int i = 0;
  for (int x = 0; x < S::d; ++x)
    for (int y = x; y < S::d; ++y, ++i)
      if (i == t) return x == y;
  return false;
}

// Q_l,t = cc_l,t - 1/3 on the diagonal and 2 cc_l,t off it, in float64
// (as NumPy derives it) rounded once to float32.
template <class S>
__host__ __device__ constexpr float qi(int l, int t) {
  return is_diagonal<S>(t) ? float(double(cc<S>(l, t)) - 1.0 / 3.0) : float(double(cc<S>(l, t)) * 2.0);
}

// The packed id field of a mask word (the raw cell type for q <= 19).
template <class S = D3Q19>
__device__ __forceinline__ int cell_type(int packed) { return (packed >> S::id_shift) & S::id_mask; }

// i + d wrapped into [0, n) for |d| <= n (periodic pull and push indices).
__device__ __forceinline__ int wrap1(int i, int n) { return i < 0 ? i + n : (i >= n ? i - n : i); }

// i wrapped into [0, n) for any i (halo tiles that may span the domain).
__device__ __forceinline__ int wrapmod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// The pair-shared quadratic equilibrium of (rho, u): feq_{l,o} = rho w
// (t +- cu3) with the shared even part t = (1 - 1.5 u^2) + cu3^2 / 2.
template <class S, typename F>
__device__ __forceinline__ void equilibrium(F rho, const F u[S::d], const XlbStepParams& p, F feq[S::q]) {
  F usqr = u[0] * u[0];
#pragma unroll
  for (int a = 1; a < S::d; ++a) usqr = usqr + u[a] * u[a];
  const F base = 1.0f - 1.5f * usqr;
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    const int o = S::opp(l);
    if (o < l) continue;  // pair handled at its lower index
    const F rw = rho * p.w[l];
    if (o == l) {
      feq[l] = rw * base;
      continue;
    }
    F cu = 0.0f;
    bool have = false;
#pragma unroll
    for (int a = 0; a < S::d; ++a) {
      const int ca = S::c(a, l);
      if (ca == 0) continue;
      const F t = ca == 1 ? u[a] : -u[a];
      cu = have ? cu + t : t;
      have = true;
    }
    const F cu3 = 3.0f * cu;
    const F even = base + 0.5f * (cu3 * cu3);
    feq[l] = rw * (even + cu3);
    feq[o] = rw * (even - cu3);
  }
}

// equilibrium in products and sums that nvcc never contracts into FMAs.
// The forced step takes both of its equilibria, feq(rho, u) and
// feq(rho, u + F), from it: their difference is the force term, and where
// nvcc contracts (and shares terms between the two) would otherwise depend
// on the kernel around the inlined body.
template <class S, typename F>
__device__ __forceinline__ void equilibrium_rn(F rho, const F u[S::d], const XlbStepParams& p, F feq[S::q]) {
  F usqr = mul_rn(u[0], u[0]);
#pragma unroll
  for (int a = 1; a < S::d; ++a) usqr = add_rn(usqr, mul_rn(u[a], u[a]));
  const F base = sub_rn(1.0f, mul_rn(1.5f, usqr));
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    const int o = S::opp(l);
    if (o < l) continue;  // pair handled at its lower index
    const F rw = mul_rn(rho, p.w[l]);
    if (o == l) {
      feq[l] = mul_rn(rw, base);
      continue;
    }
    F cu = 0.0f;
    bool have = false;
#pragma unroll
    for (int a = 0; a < S::d; ++a) {
      const int ca = S::c(a, l);
      if (ca == 0) continue;
      const F t = ca == 1 ? u[a] : -u[a];
      cu = have ? add_rn(cu, t) : t;
      have = true;
    }
    const F cu3 = mul_rn(3.0f, cu);
    const F even = add_rn(base, mul_rn(0.5f, mul_rn(cu3, cu3)));
    feq[l] = mul_rn(rw, add_rn(even, cu3));
    feq[o] = mul_rn(rw, sub_rn(even, cu3));
  }
}

// Moments and the pair-shared quadratic equilibrium of one voxel's
// post-streaming populations fs. Shared by the forward (collide_voxel) and
// the adjoint kernel (adjoint_step.cuh), so the adjoint linearises the very
// arithmetic the forward ran. RN: the equilibrium through equilibrium_rn.
template <class S, bool RN = false, typename F>
__device__ __forceinline__ void moments_equilibrium(const F fs[S::q], const XlbStepParams& p, F& rho, F& inv_rho,
                                                    F u[S::d], F feq[S::q]) {
  rho = fs[0];
#pragma unroll
  for (int l = 1; l < S::q; ++l) rho = rho + fs[l];
  inv_rho = 1.0f / rho;
#pragma unroll
  for (int a = 0; a < S::d; ++a) {
    F acc = 0.0f;
    bool have = false;
#pragma unroll
    for (int l = 0; l < S::q; ++l) {
      const int ca = S::c(a, l);
      if (ca == 0) continue;
      const F t = ca == 1 ? fs[l] : -fs[l];
      acc = have ? acc + t : t;
      have = true;
    }
    u[a] = acc * inv_rho;
  }
  if constexpr (RN) equilibrium_rn<S>(rho, u, p, feq);
  else equilibrium<S>(rho, u, p, feq);
}

__device__ __forceinline__ bool missing_bit(int packed, int l) { return (packed >> l) & 1; }

// The EXT switch: which streaming-step epilogues besides "equilibrium" an
// instantiation compiles. kExtAll (= true) is the 2D kernels' set; the 3D
// kernels of the collision zoo take halfway alone, and their kExtOpen
// instantiations (D3Q19 BGK, D3Q27 KBC) every epilogue of the open
// boundaries; kExtHybrid is kExtOpen's set and the hybrid curved wall (in
// 2D: halfway, Zou-He, regularized with the aux field's prescriptions, and
// hybrid).
enum : int { kExtNone = 0, kExtAll = 1, kExtHalfway = 2, kExtOpen = 3, kExtHybrid = 4 };

// Whether an instantiation reads the aux field (and, in 3D, stages the
// outflow).
__host__ __device__ constexpr bool ext_reads_aux(int ext) { return ext == kExtOpen || ext == kExtHybrid; }

// The field modes of the single-step kernels (K1 field_step_kernel, K3
// step_2d_field_kernel), xlb_tpu's `ade` and `extern_force`: the
// advection-diffusion step, and the NSE step with a per-voxel
// exact-difference force; both read their field from aux channels [0, d).
enum : int { kFieldNone = 0, kFieldAde = 1, kFieldForce = 2 };

// The field modes' instantiation table, by (field, stencil, collision,
// form) -- form: the 3D kernels' walled code (1 walled, 2 kExtOpen, 3
// kExtHybrid), the 2D kernels' EXT (kExtAll, kExtHybrid) -- in f32 and
// bf16 storage, unshifted, as xlb_tpu's fused ADE and forced steps. The
// advection-diffusion step: D2Q9 and D3Q19 BGK with the voxel-local BCs
// (in 3D the walled form, and kExtOpen for Zou-He, regularized and
// do-nothing); the force: D2Q9 BGK, D3Q19 BGK and D3Q27 KBC, with every
// epilogue of their open and hybrid forms. The wrappers' construction-time
// gate (FIELD_PAIRS and ADE_KINDS of kernels/collide_stream_dma.py) changes
// with it.
__host__ __device__ constexpr bool has_field(int field, int q, int collision, int form) {
  if (field == kFieldAde)
    return collision == XLB_COLL_BGK && ((q == 9 && form == kExtAll) || (q == 19 && (form == 1 || form == 2)));
  if (field == kFieldForce)
    return (q == 9 && collision == XLB_COLL_BGK && (form == kExtAll || form == kExtHybrid)) ||
           (((q == 19 && collision == XLB_COLL_BGK) || (q == 27 && collision == XLB_COLL_KBC)) && form >= 1 &&
            form <= 3);
  return false;
}

// No aux field and no staging (the kernels that read neither).
struct NoAux {
  __device__ __forceinline__ float operator()(int) const { return 0.0f; }
};
struct NoStaged {
  __device__ __forceinline__ float operator()(int, int, int, int) const { return 0.0f; }
};

// The direction of S with the components (cx, cy, cz), or -1; the mirror
// of direction l across the plane normal to axis a.
template <class S>
__host__ __device__ constexpr int find_dir(int cx, int cy, int cz) {
  for (int l = 0; l < S::q; ++l)
    if (S::c(0, l) == cx && S::c(1, l) == cy && S::c(2, l) == cz) return l;
  return -1;
}
template <class S>
__host__ __device__ constexpr int mirror_dir(int a, int l) {
  return find_dir<S>(a == 0 ? -S::c(0, l) : S::c(0, l), a == 1 ? -S::c(1, l) : S::c(1, l),
                     a == 2 ? -S::c(2, l) : S::c(2, l));
}

// The centred (pre-streaming) population l, unshifted: a float, or the
// adjoint's Dual when center returns one.
template <bool SHIFTED, typename Center>
__device__ __forceinline__ auto centred(const Center& center, const XlbStepParams& p, int l) {
  auto v = center(l);
  if constexpr (SHIFTED) v = v + p.w[l];
  return v;
}

// "halfway" bounce-back of BC b: each missing direction l takes the centred
// (pre-streaming) population opp(l), plus the constant moving-wall term.
template <class S, bool SHIFTED, typename Center, typename F>
__device__ __forceinline__ void halfway_epilogue(const Center& center, int packed, const XlbStepParams& p, int b,
                                                 F fs[S::q]) {
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    if (!missing_bit(packed, l)) continue;
    const int o = S::opp(l);
    F refl = center(o);
    if constexpr (SHIFTED) refl = refl + p.w[o];
    if (p.bc[b].flag) refl = refl + p.bc[b].vec[l];
    fs[l] = refl;
  }
}

// The kExtOpen "halfway" of BC b: as halfway_epilogue, with XLB_FLAG_AUX
// the moving-wall term 6 w_l (c_l . u_wall) of the voxel's wall velocity
// in the aux field (vec holds 6 w_l).
template <class S, bool SHIFTED, typename Center, typename F, typename Aux>
__device__ __forceinline__ void open_halfway_epilogue(const Center& center, int packed, const XlbStepParams& p, int b,
                                                      F fs[S::q], const Aux& aux) {
  const int flag = p.bc[b].flag;
  const int u_off = flag >> XLB_FLAG_AUX_SHIFT;
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    if (!missing_bit(packed, l)) continue;
    F refl = centred<SHIFTED>(center, p, S::opp(l));
    if (flag & XLB_FLAG_AUX) {
      float cu = 0.0f;
      bool have = false;
#pragma unroll
      for (int a = 0; a < S::d; ++a) {
        const int ca = S::c(a, l);
        if (ca == 0) continue;
        const float u = aux(u_off + a);
        const float t = ca == 1 ? u : -u;
        cu = have ? __fadd_rn(cu, t) : t;
        have = true;
      }
      if (have) refl = add_rn(refl, F(__fmul_rn(p.bc[b].vec[l], cu)));
    } else if (flag) {
      refl = add_rn(refl, F(p.bc[b].vec[l]));
    }
    fs[l] = refl;
  }
}

// The kExtOpen Zou-He prescription of BC b: the velocity, or the density
// (XLB_FLAG_PRESSURE), constant or with XLB_FLAG_AUX the voxel's in the aux
// field, closed by the mass balance fsum; a per-voxel velocity's every
// component adds its normal term, as xlb_tpu's body.
template <class S, typename F, typename Aux>
__device__ __forceinline__ void open_prescription(const XlbStepParams& p, int b, F fsum, const float normal[S::d],
                                                  const Aux& aux, F& rho, F u[S::d]) {
  const int flag = p.bc[b].flag;
  const int ch = flag >> XLB_FLAG_AUX_SHIFT;
  if (!(flag & XLB_FLAG_PRESSURE)) {  // velocity
    const bool spatial = flag & XLB_FLAG_AUX;
    float unormal = 0.0f;
    bool have = false;
#pragma unroll
    for (int a = 0; a < S::d; ++a) {
      const float v = spatial ? aux(ch + a) : p.bc[b].vec[a];
      u[a] = v;
      if (!spatial && v == 0.0f) continue;  // a constant's zero components add no term
      const float t = __fmul_rn(normal[a], v);
      unormal = have ? __fadd_rn(unormal, t) : t;
      have = true;
    }
    rho = fsum / (1.0f + unormal);
  } else {  // pressure
    rho = F((flag & XLB_FLAG_AUX) ? aux(ch) : p.bc[b].vec[0]);
    const F unormal = -1.0f + fsum / rho;
#pragma unroll
    for (int a = 0; a < S::d; ++a) u[a] = mul_rn(unormal, F(normal[a]));
  }
}

// "zouhe" / "regularized" closure of BC b (xlb_tpu's _zouhe_epilogue): the
// Zou-He mass balance gives rho (velocity) or the normal velocity
// (pressure) from the constant prescription -- with OPEN (the 3D kernels'
// kExtOpen) also from the voxel's velocity or density in the aux field,
// and in intrinsics nvcc never contracts (open_prescription) --; missing
// directions take the non-equilibrium bounce-back f_opp + feq_l - feq_opp;
// "regularized" then rebuilds every population as feq + 4.5 w_l Q_l :
// Pi_neq. F is float, or the adjoint's Dual.
template <class S, bool OPEN = false, typename Aux = NoAux, typename F>
__device__ __forceinline__ void zouhe_epilogue(int packed, const XlbStepParams& p, int b, F fs[S::q],
                                               const Aux& aux = Aux{}) {
  constexpr int q = S::q, d = S::d, nt = n_moments<S>();
  float miss[q];
#pragma unroll
  for (int l = 0; l < q; ++l) miss[l] = missing_bit(packed, l) ? 1.0f : 0.0f;

  F fsum = 0.0f;
#pragma unroll
  for (int l = 0; l < q; ++l) {
    const float known = miss[S::opp(l)];
    const float middle = 1.0f - fmaxf(miss[l], known);
    if constexpr (OPEN) {
      const F term = add_rn(mul_rn(fs[l], F(middle)), mul_rn(2.0f * fs[l], F(known)));
      fsum = l == 0 ? term : add_rn(fsum, term);
    } else {
      const F term = fs[l] * middle + 2.0f * fs[l] * known;
      fsum = l == 0 ? term : fsum + term;
    }
  }

  // inward normal from the missing main directions
  float normal[d];
#pragma unroll
  for (int a = 0; a < d; ++a) {
    float acc = 0.0f;
    bool have = false;
#pragma unroll
    for (int l = 0; l < q; ++l) {
      if (!is_main<S>(l) || S::c(a, l) == 0) continue;
      const float t = S::c(a, l) == 1 ? miss[l] : -miss[l];
      acc = have ? acc + t : t;
      have = true;
    }
    normal[a] = -acc;
  }

  F rho, u[d];
  if constexpr (OPEN) {
    open_prescription<S>(p, b, fsum, normal, aux, rho, u);
  } else if (p.bc[b].flag == 0) {  // velocity
    float unormal = 0.0f;
    bool have = false;
#pragma unroll
    for (int a = 0; a < d; ++a) {
      const float v = p.bc[b].vec[a];
      u[a] = v;
      if (v == 0.0f) continue;
      const float t = normal[a] * v;
      unormal = have ? unormal + t : t;
      have = true;
    }
    rho = fsum / (1.0f + unormal);
  } else {  // pressure
    rho = p.bc[b].vec[0];
    const F unormal = -1.0f + fsum / rho;
#pragma unroll
    for (int a = 0; a < d; ++a) u[a] = unormal * normal[a];
  }

  F feq[q], fbd[q];
  if constexpr (OPEN) equilibrium_rn<S>(rho, u, p, feq);
  else equilibrium<S>(rho, u, p, feq);
#pragma unroll
  for (int l = 0; l < q; ++l) {
    const int o = S::opp(l);
    fbd[l] = missing_bit(packed, l) ? fs[o] + feq[l] - feq[o] : fs[l];
  }

  if (p.bc_kind[b] == XLB_BC_REGULARIZED) {
    F pi[nt];
#pragma unroll
    for (int t = 0; t < nt; ++t) {
      F acc = 0.0f;
      bool have = false;
#pragma unroll
      for (int l = 0; l < q; ++l) {
        const int k = cc<S>(l, t);
        if (k == 0) continue;
        const F fneq = fbd[l] - feq[l];
        const F term = k == 1 ? fneq : -fneq;
        acc = have ? acc + term : term;
        have = true;
      }
      pi[t] = acc;
    }
#pragma unroll
    for (int l = 0; l < q; ++l) {
      F qipi = 0.0f;
      bool have = false;
#pragma unroll
      for (int t = 0; t < nt; ++t) {
        if (qi<S>(l, t) == 0.0f) continue;
        if constexpr (OPEN) {
          const F term = mul_rn(pi[t], F(qi<S>(l, t)));
          qipi = have ? add_rn(qipi, term) : term;
        } else {
          const F term = pi[t] * qi<S>(l, t);
          qipi = have ? qipi + term : term;
        }
        have = true;
      }
      if constexpr (OPEN) fbd[l] = add_rn(feq[l], mul_rn(F(p.w45[l]), qipi));
      else fbd[l] = feq[l] + p.w45[l] * qipi;
    }
  }
#pragma unroll
  for (int l = 0; l < q; ++l) fs[l] = fbd[l];
}

// "free_slip" of BC b (specular reflection): a missing direction l that
// crosses the wall (c_l along the normal axis == -sign(n)) takes the
// centred population of its mirror across the wall; the other missing
// directions (periodic wraps at corners) keep their pulled values.
template <class S, bool SHIFTED, typename Center, typename F>
__device__ __forceinline__ void free_slip_epilogue(const Center& center, int packed, const XlbStepParams& p, int b,
                                                   F fs[S::q]) {
  const int n0 = int(p.bc[b].vec[0]), n1 = int(p.bc[b].vec[1]), n2 = int(p.bc[b].vec[2]);
  const int axis = n0 != 0 ? 0 : (n1 != 0 ? 1 : 2);
  const int sign = n0 + n1 + n2;  // axis-aligned: the one nonzero component
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    if (!missing_bit(packed, l)) continue;
    const int cl = axis == 0 ? S::c(0, l) : (axis == 1 ? S::c(1, l) : S::c(2, l));
    if (cl != -sign) continue;
    const int m = axis == 0 ? mirror_dir<S>(0, l) : (axis == 1 ? mirror_dir<S>(1, l) : mirror_dir<S>(2, l));
    fs[l] = centred<SHIFTED>(center, p, m);
  }
}

// Packed upper-triangular second moment Pi_t = sum_l cc_l,t fneq_l, the
// +-1 coefficients as adds in direction order (xlb_tpu's second_moment).
template <class S, typename F>
__device__ __forceinline__ void second_moment(const F fneq[S::q], F pi[n_moments<S>()]) {
#pragma unroll
  for (int t = 0; t < n_moments<S>(); ++t) {
    F acc = 0.0f;
    bool have = false;
#pragma unroll
    for (int l = 0; l < S::q; ++l) {
      const int k = cc<S>(l, t);
      if (k == 0) continue;
      const F term = k == 1 ? fneq[l] : -fneq[l];
      acc = have ? acc + term : term;
      have = true;
    }
    pi[t] = acc;
  }
}

// c_l . v as a sum of +-v_a in axis order; have: c_l != 0.
template <class S, typename F>
__device__ __forceinline__ F c_dot(int l, const F v[S::d], bool& have) {
  F cu = 0.0f;
  have = false;
#pragma unroll
  for (int a = 0; a < S::d; ++a) {
    const int ca = S::c(a, l);
    if (ca == 0) continue;
    const F t = ca == 1 ? v[a] : -v[a];
    cu = have ? add_rn(cu, t) : t;
    have = true;
  }
  return cu;
}

// Q_l : Pi with every nonzero coefficient as a product, in t order.
template <class S, typename F>
__device__ __forceinline__ F qi_contract(int l, const F pi[n_moments<S>()]) {
  F acc = 0.0f;
  bool have = false;
#pragma unroll
  for (int t = 0; t < n_moments<S>(); ++t) {
    if (qi<S>(l, t) == 0.0f) continue;
    const F term = mul_rn(pi[t], F(qi<S>(l, t)));
    acc = have ? add_rn(acc, term) : term;
    have = true;
  }
  return acc;
}

// Latt-Chopard regularization of f in place: feq(rho, u of f) + 4.5 w_l
// Q_l : Pi_neq.
template <class S, typename F>
__device__ __forceinline__ void regularize_rn(F f[S::q], const XlbStepParams& p) {
  F rho, inv_rho, u[S::d], feq[S::q], pi[n_moments<S>()];
  moments_equilibrium<S, true>(f, p, rho, inv_rho, u, feq);
#pragma unroll
  for (int l = 0; l < S::q; ++l) f[l] = sub_rn(f[l], feq[l]);
  second_moment<S>(f, pi);
#pragma unroll
  for (int l = 0; l < S::q; ++l) f[l] = add_rn(feq[l], mul_rn(F(p.w45[l]), qi_contract<S>(l, pi)));
}

// The "hybrid" curved-wall closure of BC b at one of its voxels (xlb_tpu's
// _hybrid_epilogue, term by term as the plain body's): fs are the pulled
// populations, fpre(l) the centred (pre-streaming) ones, unshifted. The
// wall distances t_l ride the aux field's channels from the flag's weight
// offset (t = 1/2 without them); a moving wall adds 6 w_l (c_l . u_w),
// static (vec) or from the aux field's velocity (vec holds 6 w_l), and
// Tao's closure takes u_w itself: the aux field's, or the static wall's
// recovered from vec as u_a = (1/2) sum_l c_la vec_l (sum_l w_l c_la c_lb =
// delta_ab / 3 on D2Q9, D3Q19 and D3Q27). Voxel-local: it reads no
// neighbour. Products and sums nvcc never contracts; F is float, or the
// adjoint's Dual.
template <class S, typename F, typename Fpre, typename Aux>
__device__ __forceinline__ void hybrid_epilogue(const Fpre& fpre, int packed, const XlbStepParams& p, int b,
                                                F fs[S::q], const Aux& aux) {
  constexpr int q = S::q, d = S::d, nt = n_moments<S>();
  const int flag = p.bc[b].flag;
  const int method = flag & 3;
  const bool dist = flag & XLB_HYB_DIST;
  const int mw = (flag >> XLB_HYB_MW_SHIFT) & 3;
  const int w_off = (flag >> XLB_HYB_W_SHIFT) & 0xFFF;
  const int u_off = (flag >> XLB_HYB_U_SHIFT) & 0x7FF;
  auto t_w = [&](int l) { return dist ? F(aux(w_off + l)) : F(0.5f); };

  if (method != XLB_HYB_TAO) {
    // Yu-Mei-Shyy interpolated bounce-back; in place, since a missing l
    // reads fs[opp(l)] only where opp(l) is not missing
    F uw[d];
    if (mw == 2) {
#pragma unroll
      for (int a = 0; a < d; ++a) uw[a] = F(aux(u_off + a));
    }
#pragma unroll
    for (int l = 0; l < q; ++l) {
      if (!missing_bit(packed, l)) continue;
      const int o = S::opp(l);
      F interp;
      if (dist && !missing_bit(packed, o)) {
        const F t = t_w(l);
        interp = add_rn(mul_rn(sub_rn(F(1.0f), t), fs[o]), mul_rn(t, add_rn(fpre(l), fpre(o)))) / add_rn(F(1.0f), t);
      } else {  // no distances, or the sandwich (both l and opp(l) missing): plain bounce-back
        interp = fpre(o);
      }
      if (mw == 1) {
        interp = add_rn(interp, F(p.bc[b].vec[l]));
      } else if (mw == 2) {
        bool have;
        const F cu = c_dot<S>(l, uw, have);
        if (have) interp = add_rn(interp, mul_rn(F(p.bc[b].vec[l]), cu));
      }
      fs[l] = interp;
    }
    if (method == XLB_HYB_REGULARIZED) {
      regularize_rn<S>(fs, p);
    } else if (method == XLB_HYB_GRADS) {
      // Grad's approximation of the missing populations: rho w_l (1 + 3 c_l.u)
      // + 4.5 w_l Q_l : (Pi - rho / 3 I), Pi the second moment of fs
      F rho, inv_rho, u[d], feq[q], pi[nt];  // feq unused: the compiler drops it
      moments_equilibrium<S, true>(fs, p, rho, inv_rho, u, feq);
      second_moment<S>(fs, pi);
      const F third = rho / F(3.0f);
#pragma unroll
      for (int t = 0; t < nt; ++t)
        if (is_diagonal<S>(t)) pi[t] = sub_rn(pi[t], third);
#pragma unroll
      for (int l = 0; l < q; ++l) {
        if (!missing_bit(packed, l)) continue;
        bool have;
        const F cu = c_dot<S>(l, u, have);
        const F rw = mul_rn(rho, F(p.w[l]));
        const F g = have ? mul_rn(rw, add_rn(F(1.0f), mul_rn(F(3.0f), cu))) : mul_rn(rw, F(1.0f));
        fs[l] = add_rn(g, mul_rn(F(p.w45[l]), qi_contract<S>(l, pi)));
      }
    }
    return;
  }

  // Tao et al.'s one-point closure from the centred populations, then regularization
  F fp[q], rho_p, inv_rho_p, u_p[d], feq_p[q], feq_w[q];
#pragma unroll
  for (int l = 0; l < q; ++l) fp[l] = fpre(l);
  moments_equilibrium<S, true>(fp, p, rho_p, inv_rho_p, u_p, feq_p);
  if (mw) {
    F uw[d];
#pragma unroll
    for (int a = 0; a < d; ++a) {
      if (mw == 2) {
        uw[a] = F(aux(u_off + a));
        continue;
      }
      float acc = 0.0f;
#pragma unroll
      for (int l = 0; l < q; ++l) {
        const int ca = S::c(a, l);
        if (ca != 0) acc = ca == 1 ? __fadd_rn(acc, p.bc[b].vec[l]) : __fsub_rn(acc, p.bc[b].vec[l]);
      }
      uw[a] = F(__fmul_rn(0.5f, acc));
    }
    equilibrium_rn<S>(rho_p, uw, p, feq_w);
  } else {
#pragma unroll
    for (int l = 0; l < q; ++l) feq_w[l] = mul_rn(F(p.w[l]), rho_p);
  }
#pragma unroll
  for (int l = 0; l < q; ++l) {
    if (!missing_bit(packed, l)) continue;
    const int o = S::opp(l);
    const F t = t_w(l);
    const F f_wall = add_rn(feq_w[l], sub_rn(fp[o], feq_p[o]));
    fs[l] = add_rn(f_wall, mul_rn(t, fp[l])) / add_rn(F(1.0f), t);
  }
  regularize_rn<S>(fs, p);
}

// The kExtOpen (and kExtHybrid) streaming-step epilogues of BC b at one of
// its voxels; the free-slip and the outflow are 3D only. F is float, or
// the adjoint's Dual (center then returns Dual too).
template <class S, bool SHIFTED, int EXT, typename Center, typename F, typename Aux>
__device__ __forceinline__ void open_epilogue(const Center& center, int packed, const XlbStepParams& p, int b,
                                              F fs[S::q], const Aux& aux) {
  const int kind = p.bc_kind[b];
  if constexpr (EXT == kExtHybrid) {
    if (kind == XLB_BC_HYBRID) {
      hybrid_epilogue<S>([&](int l) { return centred<SHIFTED>(center, p, l); }, packed, p, b, fs, aux);
      return;
    }
  }
  if (kind == XLB_BC_HALFWAY) {
    open_halfway_epilogue<S, SHIFTED>(center, packed, p, b, fs, aux);
  } else if (kind == XLB_BC_ZOUHE || kind == XLB_BC_REGULARIZED) {
    zouhe_epilogue<S, true>(packed, p, b, fs, aux);
  } else if (kind == XLB_BC_DO_NOTHING) {
#pragma unroll
    for (int l = 0; l < S::q; ++l) fs[l] = centred<SHIFTED>(center, p, l);
  } else if constexpr (S::d == 3) {
    if (kind == XLB_BC_FREE_SLIP) {
      free_slip_epilogue<S, SHIFTED>(center, packed, p, b, fs);
    } else if (kind == XLB_BC_OUTFLOW) {
      // the values the previous step staged in the outgoing slots
#pragma unroll
      for (int l = 0; l < S::q; ++l)
        if (missing_bit(packed, l)) fs[l] = centred<SHIFTED>(center, p, S::opp(l));
    }
  }
}

// The post-streaming populations of one voxel: the q pulls (store form,
// as f32), the shifted load (+ w_l) and the streaming-step epilogues.
// Returns whether an "equilibrium" BC replaced them by its constants. F is
// float, or the adjoint's Dual: pull and center then return Dual, whose
// tangents the epilogues carry to fs.
template <class S, bool SHIFTED, int EXT, typename Pull, typename Center, typename F, typename Aux = NoAux>
__device__ __forceinline__ bool streamed_populations(const Pull& pull, const Center& center, int packed,
                                                     const XlbStepParams& p, F fs[S::q], const Aux& aux = Aux{}) {
  const int bc = cell_type<S>(packed);
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    fs[l] = pull(l);
    if constexpr (SHIFTED) fs[l] = fs[l] + p.w[l];
  }
  bool fixed = false;
  for (int b = 0; b < p.n_bc; ++b) {
    if (p.bc_kind[b] == XLB_BC_EQUILIBRIUM && bc == p.bc_id[b]) {
#pragma unroll
      for (int l = 0; l < S::q; ++l) fs[l] = F(p.bc[b].vec[l]);
      fixed = true;
    }
    if constexpr (EXT == kExtHalfway || EXT == kExtAll) {
      if (bc == p.bc_id[b]) {
        if (p.bc_kind[b] == XLB_BC_HALFWAY) halfway_epilogue<S, SHIFTED>(center, packed, p, b, fs);
        if constexpr (EXT == kExtAll) {
          if (p.bc_kind[b] == XLB_BC_ZOUHE || p.bc_kind[b] == XLB_BC_REGULARIZED) zouhe_epilogue<S>(packed, p, b, fs);
        }
      }
    }
    if constexpr (ext_reads_aux(EXT)) {
      if (bc == p.bc_id[b]) open_epilogue<S, SHIFTED, EXT>(center, packed, p, b, fs, aux);
    }
  }
  return fixed;
}

// The outflow's post-collision staging at an "extrapolation_outflow" voxel
// of BC b (xlb_tpu's staging epilogue): for each missing m, the outgoing
// slot l = opp(m) takes cs f_s[m](x - n) + (1 - cs) f_s[m](x). The
// neighbour term is the pre-streaming m at x - t, t = n + c_m, which is
// tangential (|t_a| <= 1) wherever m is missing at the face:
// staged(m, tx, ty, tz) reads it, in store form.
template <class S, bool SHIFTED, typename Staged>
__device__ __forceinline__ void outflow_staging(const Staged& staged, int packed, const XlbStepParams& p, int b,
                                                const float fs[S::q], float out[S::q]) {
  const int n0 = int(p.bc[b].vec[0]), n1 = int(p.bc[b].vec[1]), n2 = int(p.bc[b].vec[2]);
  const float cs = p.bc[b].vec[3], cs1 = 1.0f - cs;
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    const int m = S::opp(l);
    if (!missing_bit(packed, m)) continue;
    const int tx = n0 + S::c(0, m), ty = n1 + S::c(1, m), tz = n2 + S::c(2, m);
    if (tx < -1 || tx > 1 || ty < -1 || ty > 1 || tz < -1 || tz > 1) continue;  // never a staged slot
    float nb = staged(m, tx, ty, tz);
    if constexpr (SHIFTED) nb += p.w[m];
    out[l] = __fadd_rn(__fmul_rn(cs, nb), __fmul_rn(cs1, fs[m]));
  }
}

// Whether voxel cell type bc is a solid that keeps its populations.
template <class S = D3Q19>
__device__ __forceinline__ bool is_solid(int bc, const XlbStepParams& p) {
  return p.has_solids && bc == S::solid_id;
}

// Whether a BC of kind `kind` (XLB_BC_*) claims cell type bc.
__device__ __forceinline__ bool has_bc_kind(int bc, const XlbStepParams& p, int kind) {
  bool on = false;
  for (int b = 0; b < p.n_bc; ++b) on = on || (p.bc_kind[b] == kind && bc == p.bc_id[b]);
  return on;
}

// Whether a collision-step "fullway" BC claims cell type bc.
__device__ __forceinline__ bool is_fullway(int bc, const XlbStepParams& p) { return has_bc_kind(bc, p, XLB_BC_FULLWAY); }

// Pi : Pi with the off-diagonal entries counted twice:
// (sum of the diagonal squares) + 2 (sum of the off-diagonal squares).
template <class S, typename F>
__device__ __forceinline__ F strain_squared(const F pi[n_moments<S>()]) {
  F diag = 0.0f, offd = 0.0f;
  bool have_d = false, have_o = false;
#pragma unroll
  for (int t = 0; t < n_moments<S>(); ++t) {
    const F sq = mul_rn(pi[t], pi[t]);
    if (is_diagonal<S>(t)) {
      diag = have_d ? add_rn(diag, sq) : sq;
      have_d = true;
    } else {
      offd = have_o ? add_rn(offd, sq) : sq;
      have_o = true;
    }
  }
  return add_rn(diag, mul_rn(2.0f, offd));
}

// The collisions: out = C::collide(fs, feq, rho, omega). fs are the
// post-streaming populations, feq their equilibrium, rho their density; F
// is float, or Dual in the adjoint. Beyond BGK and KBC they spell their
// products and sums with mul_rn / add_rn / sub_rn, which nvcc never
// contracts into FMAs: where it contracts depends on the kernel around the
// inlined body, and K0, K1 and the sweeps of K2 must compute the same bits.
struct CollBGK {
  static constexpr int id = XLB_COLL_BGK;
  template <class S, typename F>
  __device__ __forceinline__ static void collide(const F fs[S::q], const F feq[S::q], F, F omega,
                                                 const XlbStepParams&, F out[S::q]) {
#pragma unroll
    for (int l = 0; l < S::q; ++l) out[l] = fs[l] - omega * (fs[l] - feq[l]);
  }
};

// TRT: the parts of fs - feq even and odd under l -> opp(l) relax at omega
// and at omega_minus = 1 / (Lambda / (1 / omega - 1/2) + 1/2), per pair.
struct CollTRT {
  static constexpr int id = XLB_COLL_TRT;
  template <class S, typename F>
  __device__ __forceinline__ static void collide(const F fs[S::q], const F feq[S::q], F, F omega,
                                                 const XlbStepParams& p, F out[S::q]) {
    const F tau_p_half = sub_rn(1.0f / omega, 0.5f);
    const F om_m = 1.0f / add_rn(p.coll[0] / tau_p_half, 0.5f);
#pragma unroll
    for (int l = 0; l < S::q; ++l) {
      const int o = S::opp(l);
      if (o < l) continue;  // pair handled at its lower index
      if (o == l) {
        out[l] = sub_rn(fs[l], mul_rn(omega, sub_rn(fs[l], feq[l])));
        continue;
      }
      const F h_even = mul_rn(omega, sub_rn(mul_rn(0.5f, add_rn(fs[l], fs[o])), mul_rn(0.5f, add_rn(feq[l], feq[o]))));
      const F h_odd = mul_rn(om_m, sub_rn(mul_rn(0.5f, sub_rn(fs[l], fs[o])), mul_rn(0.5f, sub_rn(feq[l], feq[o]))));
      out[l] = sub_rn(sub_rn(fs[l], h_even), h_odd);
      out[o] = add_rn(sub_rn(fs[o], h_even), h_odd);
    }
  }
};

// MRT: BGK plus (omega - s_g) P_g fneq for the bulk and ghost groups that
// relax at their own rate s_g, bulk first. The contractions are written
// out row by row in mrt_projectors.cuh, without the zero entries.
struct CollMRT {
  static constexpr int id = XLB_COLL_MRT;
  template <class S, typename F>
  __device__ __forceinline__ static void collide(const F fs[S::q], const F feq[S::q], F, F omega,
                                                 const XlbStepParams& p, F out[S::q]) {
    F fneq[S::q];
#pragma unroll
    for (int l = 0; l < S::q; ++l) {
      fneq[l] = fs[l] - feq[l];
      out[l] = sub_rn(fs[l], mul_rn(omega, fneq[l]));
    }
#pragma unroll
    for (int g = 0; g < 2; ++g)
      if (p.mrt_on[g]) S::mrt_rows(g, fneq, sub_rn(omega, F(p.mrt_rate[g])), out);
  }
};

// Smagorinsky LES: tau = (tau0 + sqrt(tau0^2 + 36 Cs^2 sqrt(Pi:Pi))) / 2.
struct CollSmagorinsky {
  static constexpr int id = XLB_COLL_SMAGORINSKY;
  template <class S, typename F>
  __device__ __forceinline__ static void collide(const F fs[S::q], const F feq[S::q], F, F omega,
                                                 const XlbStepParams& p, F out[S::q]) {
    F fneq[S::q], pi[n_moments<S>()];
#pragma unroll
    for (int l = 0; l < S::q; ++l) fneq[l] = fs[l] - feq[l];
    second_moment<S>(fneq, pi);
    const F tau0 = 1.0f / omega;
    const F root = sqrt_of(add_rn(mul_rn(tau0, tau0), mul_rn(F(p.coll[0]), sqrt_of(strain_squared<S>(pi)))));
    const F om = 1.0f / mul_rn(0.5f, add_rn(tau0, root));
#pragma unroll
    for (int l = 0; l < S::q; ++l) out[l] = sub_rn(fs[l], mul_rn(om, fneq[l]));
  }
};

// Power-law BGK: coll_iters Picard steps on tau = 3K (A / tau + eps)^(n-1)
// + 1/2 from tau = 1 / omega, A = 1.5 sqrt(2 Pi:Pi) / rho; the local rate
// 1 / tau clipped to [0.05, 1.99].
struct CollPowerLaw {
  static constexpr int id = XLB_COLL_POWERLAW;
  template <class S, typename F>
  __device__ __forceinline__ static void collide(const F fs[S::q], const F feq[S::q], F rho, F omega,
                                                 const XlbStepParams& p, F out[S::q]) {
    F fneq[S::q], pi[n_moments<S>()];
#pragma unroll
    for (int l = 0; l < S::q; ++l) fneq[l] = fs[l] - feq[l];
    second_moment<S>(fneq, pi);
    const F a = mul_rn(1.5f, sqrt_of(mul_rn(2.0f, strain_squared<S>(pi)))) / rho;
    F tau = 1.0f / omega;
    for (int it = 0; it < p.coll_iters; ++it)
      tau = add_rn(mul_rn(F(p.coll[0]), pow_of(add_rn(a / tau, F(p.coll[2])), p.coll[1])), 0.5f);
    const F om = clamp_of(1.0f / tau, 0.05f, 1.99f);
#pragma unroll
    for (int l = 0; l < S::q; ++l) out[l] = sub_rn(fs[l], mul_rn(om, fneq[l]));
  }
};

// The KBC shear part ds_l of fneq on D3Q27 (zero for the rest and corner
// directions), from N_xz = Pi_xx - Pi_zz, N_yz = Pi_yy - Pi_zz and Pi.
__device__ __forceinline__ bool kbc_has_shear_d3q27(int l) {
  const int n = (D3Q27::c(0, l) != 0) + (D3Q27::c(1, l) != 0) + (D3Q27::c(2, l) != 0);
  return n == 1 || n == 2;
}

template <typename F>
__device__ __forceinline__ F kbc_shear_d3q27(int l, F nxz, F nyz, const F pi[6]) {
  switch (l) {
    case 9: case 18: return (2.0f * nxz - nyz) / 6.0f;
    case 3: case 6: return (-nxz + 2.0f * nyz) / 6.0f;
    case 1: case 2: return (-nxz - nyz) / 6.0f;
    case 12: case 24: return pi[1] / 4.0f;
    case 21: case 15: return -pi[1] / 4.0f;
    case 10: case 20: return pi[2] / 4.0f;
    case 19: case 11: return -pi[2] / 4.0f;
    case 8: case 4: return pi[4] / 4.0f;
    case 7: case 5: return -pi[4] / 4.0f;
    default: return F(0.0f);
  }
}

// KBC (D3Q27): fs - beta (2 ds + gamma dh) with dh = fneq - ds, beta =
// omega / 2 and gamma from the entropic products <ds, dh> and <dh, dh>
// weighted by 1 / feq, one IEEE reciprocal per opposite pair (ds is even).
struct CollKBC {
  static constexpr int id = XLB_COLL_KBC;
  template <class S, typename F>
  __device__ __forceinline__ static void collide(const F fs[S::q], const F feq[S::q], F, F omega,
                                                 const XlbStepParams&, F out[S::q]) {
    static_assert(S::q == 27, "the 3D kernels run KBC on D3Q27");
    F fneq[S::q], pi[6], ds[S::q], dh[S::q];
#pragma unroll
    for (int l = 0; l < S::q; ++l) fneq[l] = fs[l] - feq[l];
    second_moment<S>(fneq, pi);
    const F nxz = pi[0] - pi[5], nyz = pi[3] - pi[5];
#pragma unroll
    for (int l = 0; l < S::q; ++l) {
      ds[l] = kbc_shear_d3q27(l, nxz, nyz, pi);
      dh[l] = kbc_has_shear_d3q27(l) ? fneq[l] - ds[l] : fneq[l];
    }
    const F beta = 0.5f * omega;
    const F inv_beta = 1.0f / beta;
    F sp1 = 0.0f, sp2 = 0.0f;
    bool have1 = false, have2 = false;
#pragma unroll
    for (int l = 0; l < S::q; ++l) {
      const int o = S::opp(l);
      if (o < l) continue;  // pair handled at its lower index
      F t1 = 0.0f, t2;
      if (o == l) {
        const F tmp = dh[l] * (1.0f / feq[l]);
        if (kbc_has_shear_d3q27(l)) t1 = tmp * ds[l];
        t2 = tmp * dh[l];
      } else {
        const F inv = 1.0f / (feq[l] * feq[o]);
        const F a = dh[l] * feq[o];
        const F b = dh[o] * feq[l];
        if (kbc_has_shear_d3q27(l)) t1 = ds[l] * ((a + b) * inv);
        t2 = (dh[l] * a + dh[o] * b) * inv;
      }
      if (kbc_has_shear_d3q27(l)) {
        sp1 = have1 ? sp1 + t1 : t1;
        have1 = true;
      }
      sp2 = have2 ? sp2 + t2 : t2;
      have2 = true;
    }
    const F gamma = inv_beta - (2.0f - inv_beta) * sp1 * (1.0f / (1e-32f + sp2));
#pragma unroll
    for (int l = 0; l < S::q; ++l)
      out[l] = kbc_has_shear_d3q27(l) ? fs[l] - beta * (2.0f * ds[l] + gamma * dh[l]) : fs[l] - beta * (gamma * dh[l]);
  }
};

// The advection-diffusion step of one voxel (FIELD == kFieldAde): phi =
// sum fs, the advecting velocity u of aux channels [0, d), BGK relaxation
// with omega (omega_phi) to the linear equilibrium, pair-shared as
// xlb_tpu's kernel body: geq_{l,o} = phi w (1 +- 3 c_l . u). In products
// and sums nvcc never contracts, so it computes the plain version's bits.
template <class S, typename Aux>
__device__ __forceinline__ void ade_physics(const float fs[S::q], float omega, const XlbStepParams& p,
                                            float out[S::q], const Aux& aux) {
  float phi = fs[0];
#pragma unroll
  for (int l = 1; l < S::q; ++l) phi = __fadd_rn(phi, fs[l]);
  float u[S::d];
#pragma unroll
  for (int a = 0; a < S::d; ++a) u[a] = aux(a);
  auto relax = [&](int l, float geq) { out[l] = __fsub_rn(fs[l], __fmul_rn(omega, __fsub_rn(fs[l], geq))); };
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    const int o = S::opp(l);
    if (o < l) continue;  // pair handled at its lower index
    const float rw = __fmul_rn(phi, p.w[l]);
    if (o == l) {
      relax(l, rw);
      continue;
    }
    bool have;
    const float cu3 = __fmul_rn(3.0f, c_dot<S>(l, u, have));
    relax(l, __fmul_rn(rw, __fadd_rn(1.0f, cu3)));
    relax(o, __fmul_rn(rw, __fsub_rn(1.0f, cu3)));
  }
}

// The physics of one voxel between the streaming-step and the
// collision-step epilogues: moments, the pair-shared equilibrium, the
// collision C and, with FORCE (applied when p.has_force), the
// exact-difference body force f += feq(rho, u + F) - feq(rho, u) with the
// pre-collision rho and u. F is float in the forward, Dual in the adjoint.
// FIELD (the forward's field modes) reads aux: kFieldAde runs ade_physics
// in place of all this, kFieldForce adds the force of aux channels [0, d).
template <class S, class C, bool FORCE, int FIELD = kFieldNone, typename F, typename Aux = NoAux>
__device__ __forceinline__ void collide_physics(const F fs[S::q], F omega, const XlbStepParams& p, F out[S::q],
                                                const Aux& aux = Aux{}) {
  if constexpr (FIELD == kFieldAde) {
    ade_physics<S>(fs, omega, p, out, aux);
  } else {
    F rho, inv_rho, u[S::d], feq[S::q];
    moments_equilibrium<S, FORCE || FIELD == kFieldForce>(fs, p, rho, inv_rho, u, feq);

    C::template collide<S>(fs, feq, rho, omega, p, out);

    if constexpr (FORCE) {
      if (p.has_force) {
        F uf[S::d], feqf[S::q];
#pragma unroll
        for (int a = 0; a < S::d; ++a) uf[a] = u[a] + p.force[a];
        equilibrium_rn<S>(rho, uf, p, feqf);
#pragma unroll
        for (int l = 0; l < S::q; ++l) out[l] = out[l] + (feqf[l] - feq[l]);
      }
    }
    if constexpr (FIELD == kFieldForce) {
      F uf[S::d], feqf[S::q];
#pragma unroll
      for (int a = 0; a < S::d; ++a) uf[a] = add_rn(u[a], F(aux(a)));
      equilibrium_rn<S>(rho, uf, p, feqf);
#pragma unroll
      for (int l = 0; l < S::q; ++l) out[l] = add_rn(out[l], sub_rn(feqf[l], feq[l]));
    }
  }
}

// One voxel of one step. pull(l) returns the raw (store-form, as f32)
// population l pulled from x - c_l; center(l) the raw population l at x;
// with kExtOpen and kExtHybrid, aux(channel) the voxel's aux field entry
// and (3D) staged(m, tx, ty, tz) the raw population m at x - t (the
// outflow's staging). Writes the post-collision populations in store form (shifted
// back when SHIFTED), still in f32, to out. C is the collision; FORCE
// compiles the exact-difference body force (applied when p.has_force);
// FIELD a field mode (collide_physics), whose field aux(0..d-1) reads.
template <class S, bool SHIFTED, int EXT, class C = CollBGK, bool FORCE = false, int FIELD = kFieldNone,
          typename Pull, typename Center, typename Aux = NoAux, typename Staged = NoStaged>
__device__ __forceinline__ void collide_voxel(const Pull& pull, const Center& center, int packed, float omega,
                                              const XlbStepParams& p, float out[S::q], const Aux& aux = Aux{},
                                              const Staged& staged = Staged{}) {
  const int bc = cell_type<S>(packed);

  float fs[S::q];
  streamed_populations<S, SHIFTED, EXT>(pull, center, packed, p, fs, aux);

  collide_physics<S, C, FORCE, FIELD>(fs, omega, p, out, aux);

  // collision-step epilogues
  if (is_fullway(bc, p)) {
#pragma unroll
    for (int l = 0; l < S::q; ++l) out[l] = fs[S::opp(l)];
  }

  if constexpr (ext_reads_aux(EXT) && S::d == 3) {
    for (int b = 0; b < p.n_bc; ++b)
      if (p.bc_kind[b] == XLB_BC_OUTFLOW && bc == p.bc_id[b]) outflow_staging<S, SHIFTED>(staged, packed, p, b, fs, out);
  }

  // solid keep-out
  if (is_solid<S>(bc, p)) {
#pragma unroll
    for (int l = 0; l < S::q; ++l) {
      float v = center(l);
      if constexpr (SHIFTED) v += p.w[l];
      out[l] = v;
    }
  }

  if constexpr (SHIFTED) {
#pragma unroll
    for (int l = 0; l < S::q; ++l) out[l] = out[l] - p.w[l];
  }
}

}  // namespace xlb
