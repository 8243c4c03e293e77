// Per-voxel body shared by the fused collide-stream kernels: the D3Q19
// kernels of collide_stream.cu, the D2Q9 kernels of collide_stream_2d.cu
// and, through its pieces (streamed_populations, moments_equilibrium,
// is_fullway, is_solid), the adjoint kernel of adjoint_step.cu.
//
// It is the CUDA counterpart of the slice of
// xlb_tpu/kernels/collide_stream.py::_build_kernel_body that BGK scenes
// with the ported BCs use (pointwise_core):
//
//   pulled populations (store form) -> shifted load (+ w_l, f32)
//   -> streaming-step epilogues: "equilibrium" (f_s := feq constant) and,
//      when the kernel is built with EXT, "halfway" (missing l reflects
//      the centred opp(l), plus a constant moving-wall term), "zouhe" and
//      "regularized" (constant velocity or density)
//   -> moments, pair-shared quadratic equilibrium, BGK
//   -> collision-step "fullway" epilogue (f_out[l] := f_s[opp[l]])
//   -> solid keep-out (cell type 255 keeps its pre-streaming populations)
//   -> shifted store (- w_l, f32)
//
// The stencil is a compile-time trait (D3Q19, D2Q9): directions,
// opposites, main directions and the second-moment / Q_i constants. EXT is
// a compile-time switch, so the instantiations that run no such BC (the
// 3D kernels and the 2D lid cavity) compile without the extra epilogues.
//
// The arithmetic follows the Python body term by term (same summation
// order, same pair-shared equilibrium), so the kernels agree with the plain
// torch version in xlb_tpu_torch/kernels/collide_stream.py to f32 roundoff;
// nvcc's FMA contraction is the only difference.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#define XLB_MAX_Q 19
#define XLB_MAX_BC 8
#define XLB_BC_ID_SHIFT 19  // packed mask: missing bits 0..q-1 (q <= 19), cell type in bits 19..26
#define XLB_SOLID_ID 255

enum : int {
  XLB_BC_EQUILIBRIUM = 0,
  XLB_BC_FULLWAY = 1,
  XLB_BC_HALFWAY = 2,
  XLB_BC_ZOUHE = 3,
  XLB_BC_REGULARIZED = 4,
};

// Launch parameters: the f32 weights, the BC table and the solid flag.
// Plain int/float members only, so the ctypes mirror in
// xlb_tpu_torch/kernels/_cuda.py has the same layout.
struct XlbStepParams {
  float w[XLB_MAX_Q];
  float w45[XLB_MAX_Q];  // 4.5 w_l rounded once to f32 (regularized)
  int has_solids;
  int n_bc;
  int bc_kind[XLB_MAX_BC];
  int bc_id[XLB_MAX_BC];
  int bc_flag[XLB_MAX_BC];                // halfway: 1 = moving wall; zouhe / regularized: 1 = pressure
  float bc_feq[XLB_MAX_BC][XLB_MAX_Q];    // equilibrium: the prescribed feq
  float bc_mw[XLB_MAX_BC][XLB_MAX_Q];     // halfway: 6 w_l (c_l . u_wall)
  float bc_value[XLB_MAX_BC][3];          // zouhe / regularized: the velocity, or the density in [0]
};

namespace xlb {

// D3Q19 in xlb_tpu's direction order (itertools.product([0, -1, 1], repeat=3)
// with |c|_1 <= 2); the wrapper checks the velocity set against this table.
struct D3Q19 {
  static constexpr int d = 3, q = 19;
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
};

// D2Q9 in xlb_tpu's direction order (velocity_set/stencils.py).
struct D2Q9 {
  static constexpr int d = 2, q = 9;
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

__device__ __forceinline__ int cell_type(int packed) { return (packed >> XLB_BC_ID_SHIFT) & 0xFF; }

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
template <class S>
__device__ __forceinline__ void equilibrium(float rho, const float u[S::d], const XlbStepParams& p,
                                            float feq[S::q]) {
  float usqr = u[0] * u[0];
#pragma unroll
  for (int a = 1; a < S::d; ++a) usqr = usqr + u[a] * u[a];
  const float base = 1.0f - 1.5f * usqr;
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    const int o = S::opp(l);
    if (o < l) continue;  // pair handled at its lower index
    const float rw = rho * p.w[l];
    if (o == l) {
      feq[l] = rw * base;
      continue;
    }
    float cu = 0.0f;
    bool have = false;
#pragma unroll
    for (int a = 0; a < S::d; ++a) {
      const int ca = S::c(a, l);
      if (ca == 0) continue;
      const float t = ca == 1 ? u[a] : -u[a];
      cu = have ? cu + t : t;
      have = true;
    }
    const float cu3 = 3.0f * cu;
    const float even = base + 0.5f * (cu3 * cu3);
    feq[l] = rw * (even + cu3);
    feq[o] = rw * (even - cu3);
  }
}

// Moments and the pair-shared quadratic equilibrium of one voxel's
// post-streaming populations fs. Shared by the forward (collide_voxel) and
// the adjoint kernel (adjoint_step.cu), so the adjoint linearises the very
// arithmetic the forward ran.
template <class S>
__device__ __forceinline__ void moments_equilibrium(const float fs[S::q], const XlbStepParams& p, float& rho,
                                                    float& inv_rho, float u[S::d], float feq[S::q]) {
  rho = fs[0];
#pragma unroll
  for (int l = 1; l < S::q; ++l) rho = rho + fs[l];
  inv_rho = 1.0f / rho;
#pragma unroll
  for (int a = 0; a < S::d; ++a) {
    float acc = 0.0f;
    bool have = false;
#pragma unroll
    for (int l = 0; l < S::q; ++l) {
      const int ca = S::c(a, l);
      if (ca == 0) continue;
      const float t = ca == 1 ? fs[l] : -fs[l];
      acc = have ? acc + t : t;
      have = true;
    }
    u[a] = acc * inv_rho;
  }
  equilibrium<S>(rho, u, p, feq);
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
    if (p.bc_flag[b]) refl = refl + p.bc_mw[b][l];
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
  if (p.bc_flag[b] == 0) {  // velocity
    float unormal = 0.0f;
    bool have = false;
#pragma unroll
    for (int a = 0; a < d; ++a) {
      const float v = p.bc_value[b][a];
      u[a] = v;
      if (v == 0.0f) continue;
      const float t = normal[a] * v;
      unormal = have ? unormal + t : t;
      have = true;
    }
    rho = fsum / (1.0f + unormal);
  } else {  // pressure
    rho = p.bc_value[b][0];
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

// The post-streaming populations of one voxel: the q pulls (store form,
// as f32), the shifted load (+ w_l) and the streaming-step epilogues.
// Returns whether an "equilibrium" BC replaced them by its constants.
template <class S, bool SHIFTED, bool EXT, typename Pull, typename Center>
__device__ __forceinline__ bool streamed_populations(const Pull& pull, const Center& center, int packed,
                                                     const XlbStepParams& p, float fs[S::q]) {
  const int bc = cell_type(packed);
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    fs[l] = pull(l);
    if constexpr (SHIFTED) fs[l] += p.w[l];
  }
  bool fixed = false;
  for (int b = 0; b < p.n_bc; ++b) {
    if (p.bc_kind[b] == XLB_BC_EQUILIBRIUM && bc == p.bc_id[b]) {
#pragma unroll
      for (int l = 0; l < S::q; ++l) fs[l] = p.bc_feq[b][l];
      fixed = true;
    }
    if constexpr (EXT) {
      if (bc == p.bc_id[b]) {
        if (p.bc_kind[b] == XLB_BC_HALFWAY) halfway_epilogue<S, SHIFTED>(center, packed, p, b, fs);
        if (p.bc_kind[b] == XLB_BC_ZOUHE || p.bc_kind[b] == XLB_BC_REGULARIZED) zouhe_epilogue<S>(packed, p, b, fs);
      }
    }
  }
  return fixed;
}

// Whether voxel cell type bc is a solid that keeps its populations.
__device__ __forceinline__ bool is_solid(int bc, const XlbStepParams& p) { return p.has_solids && bc == XLB_SOLID_ID; }

// Whether a collision-step "fullway" BC claims cell type bc.
__device__ __forceinline__ bool is_fullway(int bc, const XlbStepParams& p) {
  bool on = false;
  for (int b = 0; b < p.n_bc; ++b) on = on || (p.bc_kind[b] == XLB_BC_FULLWAY && bc == p.bc_id[b]);
  return on;
}

// One voxel of one step. pull(l) returns the raw (store-form, as f32)
// population l pulled from x - c_l; center(l) the raw population l at x.
// Writes the post-collision populations in store form (shifted back when
// SHIFTED), still in f32, to out.
template <class S, bool SHIFTED, bool EXT, typename Pull, typename Center>
__device__ __forceinline__ void collide_voxel(const Pull& pull, const Center& center, int packed, float omega,
                                              const XlbStepParams& p, float out[S::q]) {
  const int bc = cell_type(packed);

  float fs[S::q];
  streamed_populations<S, SHIFTED, EXT>(pull, center, packed, p, fs);

  float rho, inv_rho, u[S::d], feq[S::q];
  moments_equilibrium<S>(fs, p, rho, inv_rho, u, feq);

  // BGK
#pragma unroll
  for (int l = 0; l < S::q; ++l) out[l] = fs[l] - omega * (fs[l] - feq[l]);

  // collision-step epilogues
  if (is_fullway(bc, p)) {
#pragma unroll
    for (int l = 0; l < S::q; ++l) out[l] = fs[S::opp(l)];
  }

  // solid keep-out
  if (is_solid(bc, p)) {
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
