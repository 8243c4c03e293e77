// Per-voxel body shared by the fused collide-stream kernels: the 3D
// kernels of collide_stream_3d.cuh and collide_stream_blocked.cuh, the D2Q9
// kernels of collide_stream_2d.cu and, through its pieces
// (streamed_populations, moments_equilibrium, collide_physics,
// has_bc_kind, is_solid), the adjoint kernel of adjoint_step.cuh and the
// multires kernels.
//
// It is the CUDA counterpart of the slice of
// xlb_tpu/kernels/collide_stream.py::_build_kernel_body that scenes with
// the ported BCs use (pointwise_core):
//
//   pulled populations (store form) -> shifted load (+ w_l, f32)
//   -> streaming-step epilogues: "equilibrium" (f_s := feq constant) and,
//      when the kernel is built with EXT, "halfway" (missing l reflects
//      the centred opp(l), plus a constant moving-wall term) and, with
//      EXT == kExtAll only, "zouhe" and "regularized" (constant velocity
//      or density)
//   -> moments, pair-shared quadratic equilibrium, the collision
//   -> with FORCE, the exact-difference body force
//      f += feq(rho, u + F) - feq(rho, u) with the pre-collision rho, u
//   -> collision-step "fullway" epilogue (f_out[l] := f_s[opp[l]])
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
};

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
  int flag;               // halfway: 1 = moving wall; zouhe / regularized: 1 = pressure
  float vec[XLB_MAX_Q];   // equilibrium: the prescribed feq; halfway: 6 w_l (c_l . u_wall);
                          // zouhe / regularized: the velocity, or the density in [0]
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
  int walled;       // 1: the instantiation with the halfway epilogue and the force term
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

// "halfway" bounce-back of BC b: each missing direction l takes the centred
// (pre-streaming) population opp(l), plus the constant moving-wall term.
template <class S, bool SHIFTED, typename Center>
__device__ __forceinline__ void halfway_epilogue(const Center& center, int packed, const XlbStepParams& p, int b,
                                                 float fs[S::q]) {
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    if (!missing_bit(packed, l)) continue;
    const int o = S::opp(l);
    float refl = center(o);
    if constexpr (SHIFTED) refl += p.w[o];
    if (p.bc[b].flag) refl = refl + p.bc[b].vec[l];
    fs[l] = refl;
  }
}

// "zouhe" / "regularized" closure of BC b with a constant velocity or
// density (xlb_tpu's _zouhe_epilogue): the Zou-He mass balance gives rho
// (velocity) or the normal velocity (pressure); missing directions take
// the non-equilibrium bounce-back f_opp + feq_l - feq_opp; "regularized"
// then rebuilds every population as feq + 4.5 w_l Q_l : Pi_neq.
template <class S>
__device__ __forceinline__ void zouhe_epilogue(int packed, const XlbStepParams& p, int b, float fs[S::q]) {
  constexpr int q = S::q, d = S::d, nt = n_moments<S>();
  float miss[q];
#pragma unroll
  for (int l = 0; l < q; ++l) miss[l] = missing_bit(packed, l) ? 1.0f : 0.0f;

  float fsum = 0.0f;
#pragma unroll
  for (int l = 0; l < q; ++l) {
    const float known = miss[S::opp(l)];
    const float middle = 1.0f - fmaxf(miss[l], known);
    const float term = fs[l] * middle + 2.0f * fs[l] * known;
    fsum = l == 0 ? term : fsum + term;
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

  float rho, u[d];
  if (p.bc[b].flag == 0) {  // velocity
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
    const float unormal = -1.0f + fsum / rho;
#pragma unroll
    for (int a = 0; a < d; ++a) u[a] = unormal * normal[a];
  }

  float feq[q], fbd[q];
  equilibrium<S>(rho, u, p, feq);
#pragma unroll
  for (int l = 0; l < q; ++l) {
    const int o = S::opp(l);
    fbd[l] = missing_bit(packed, l) ? fs[o] + feq[l] - feq[o] : fs[l];
  }

  if (p.bc_kind[b] == XLB_BC_REGULARIZED) {
    float pi[nt];
#pragma unroll
    for (int t = 0; t < nt; ++t) {
      float acc = 0.0f;
      bool have = false;
#pragma unroll
      for (int l = 0; l < q; ++l) {
        const int k = cc<S>(l, t);
        if (k == 0) continue;
        const float fneq = fbd[l] - feq[l];
        const float term = k == 1 ? fneq : -fneq;
        acc = have ? acc + term : term;
        have = true;
      }
      pi[t] = acc;
    }
#pragma unroll
    for (int l = 0; l < q; ++l) {
      float qipi = 0.0f;
      bool have = false;
#pragma unroll
      for (int t = 0; t < nt; ++t) {
        if (qi<S>(l, t) == 0.0f) continue;
        const float term = pi[t] * qi<S>(l, t);
        qipi = have ? qipi + term : term;
        have = true;
      }
      fbd[l] = feq[l] + p.w45[l] * qipi;
    }
  }
#pragma unroll
  for (int l = 0; l < q; ++l) fs[l] = fbd[l];
}

// The EXT switch: which streaming-step epilogues besides "equilibrium" an
// instantiation compiles. kExtAll (= true) is the 2D kernels' set; the 3D
// kernels of the collision zoo take halfway alone.
enum : int { kExtNone = 0, kExtAll = 1, kExtHalfway = 2 };

// The post-streaming populations of one voxel: the q pulls (store form,
// as f32), the shifted load (+ w_l) and the streaming-step epilogues.
// Returns whether an "equilibrium" BC replaced them by its constants.
template <class S, bool SHIFTED, int EXT, typename Pull, typename Center>
__device__ __forceinline__ bool streamed_populations(const Pull& pull, const Center& center, int packed,
                                                     const XlbStepParams& p, float fs[S::q]) {
  const int bc = cell_type<S>(packed);
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    fs[l] = pull(l);
    if constexpr (SHIFTED) fs[l] += p.w[l];
  }
  bool fixed = false;
  for (int b = 0; b < p.n_bc; ++b) {
    if (p.bc_kind[b] == XLB_BC_EQUILIBRIUM && bc == p.bc_id[b]) {
#pragma unroll
      for (int l = 0; l < S::q; ++l) fs[l] = p.bc[b].vec[l];
      fixed = true;
    }
    if constexpr (EXT != kExtNone) {
      if (bc == p.bc_id[b]) {
        if (p.bc_kind[b] == XLB_BC_HALFWAY) halfway_epilogue<S, SHIFTED>(center, packed, p, b, fs);
        if constexpr (EXT == kExtAll) {
          if (p.bc_kind[b] == XLB_BC_ZOUHE || p.bc_kind[b] == XLB_BC_REGULARIZED) zouhe_epilogue<S>(packed, p, b, fs);
        }
      }
    }
  }
  return fixed;
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

// The physics of one voxel between the streaming-step and the
// collision-step epilogues: moments, the pair-shared equilibrium, the
// collision C and, with FORCE (applied when p.has_force), the
// exact-difference body force f += feq(rho, u + F) - feq(rho, u) with the
// pre-collision rho and u. F is float in the forward, Dual in the adjoint.
template <class S, class C, bool FORCE, typename F>
__device__ __forceinline__ void collide_physics(const F fs[S::q], F omega, const XlbStepParams& p, F out[S::q]) {
  F rho, inv_rho, u[S::d], feq[S::q];
  moments_equilibrium<S, FORCE>(fs, p, rho, inv_rho, u, feq);

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
}

// One voxel of one step. pull(l) returns the raw (store-form, as f32)
// population l pulled from x - c_l; center(l) the raw population l at x.
// Writes the post-collision populations in store form (shifted back when
// SHIFTED), still in f32, to out. C is the collision; FORCE compiles the
// exact-difference body force (applied when p.has_force).
template <class S, bool SHIFTED, int EXT, class C = CollBGK, bool FORCE = false, typename Pull, typename Center>
__device__ __forceinline__ void collide_voxel(const Pull& pull, const Center& center, int packed, float omega,
                                              const XlbStepParams& p, float out[S::q]) {
  const int bc = cell_type<S>(packed);

  float fs[S::q];
  streamed_populations<S, SHIFTED, EXT>(pull, center, packed, p, fs);

  collide_physics<S, C, FORCE>(fs, omega, p, out);

  // collision-step epilogues
  if (is_fullway(bc, p)) {
#pragma unroll
    for (int l = 0; l < S::q; ++l) out[l] = fs[S::opp(l)];
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
