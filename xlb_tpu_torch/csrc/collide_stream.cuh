// Per-voxel body shared by the fused D3Q19 collide-stream kernels of
// collide_stream.cu and, through its pieces (streamed_populations,
// moments_equilibrium, is_fullway, is_solid), by the adjoint kernel of
// adjoint_step.cu.
//
// It is the CUDA counterpart of the slice of
// xlb_tpu/kernels/collide_stream.py::_build_kernel_body that the BGK
// lid-driven cavity uses (pointwise_core):
//
//   pulled populations (store form) -> shifted load (+ w_l, f32)
//   -> streaming-step "equilibrium" epilogue (f_s := feq constant)
//   -> moments, pair-shared quadratic equilibrium, BGK
//   -> collision-step "fullway" epilogue (f_out[l] := f_s[opp[l]])
//   -> solid keep-out (cell type 255 keeps its pre-streaming populations)
//   -> shifted store (- w_l, f32)
//
// The arithmetic follows the Python body term by term (same summation
// order, same pair-shared equilibrium), so the kernels agree with the plain
// torch version in xlb_tpu_torch/kernels/collide_stream.py to f32 roundoff;
// nvcc's FMA contraction is the only difference.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#define XLB_Q 19
#define XLB_MAX_BC 8
#define XLB_BC_ID_SHIFT 19  // packed mask: missing bits 0..18, cell type in bits 19..26
#define XLB_SOLID_ID 255

enum : int { XLB_BC_EQUILIBRIUM = 0, XLB_BC_FULLWAY = 1 };

// Launch parameters: the f32 weights, the BC table and the solid flag.
// Plain int/float members only, so the ctypes mirror in
// xlb_tpu_torch/kernels/_cuda.py has the same layout.
struct XlbStepParams {
  float w[XLB_Q];
  int has_solids;
  int n_bc;
  int bc_kind[XLB_MAX_BC];
  int bc_id[XLB_MAX_BC];
  float bc_feq[XLB_MAX_BC][XLB_Q];
};

namespace xlb {

// D3Q19 directions in xlb_tpu's order (itertools.product([0, -1, 1], repeat=3)
// with |c|_1 <= 2); the wrapper checks the velocity set against this table.
__host__ __device__ constexpr int c_dir(int a, int l) {
  constexpr int kC[3][XLB_Q] = {
      {0, 0, 0, 0, 0, 0, 0, 0, 0, -1, -1, -1, -1, -1, 1, 1, 1, 1, 1},
      {0, 0, 0, -1, -1, -1, 1, 1, 1, 0, 0, 0, -1, 1, 0, 0, 0, -1, 1},
      {0, -1, 1, 0, -1, 1, 0, -1, 1, 0, -1, 1, 0, 0, 0, -1, 1, 0, 0},
  };
  return kC[a][l];
}

__host__ __device__ constexpr int c_opp(int l) {
  constexpr int kOpp[XLB_Q] = {0, 2, 1, 6, 8, 7, 3, 5, 4, 14, 16, 15, 18, 17, 9, 11, 10, 13, 12};
  return kOpp[l];
}

__device__ __forceinline__ int cell_type(int packed) { return (packed >> XLB_BC_ID_SHIFT) & 0xFF; }

// i + d wrapped into [0, n) for |d| <= n (periodic pull and push indices).
__device__ __forceinline__ int wrap1(int i, int n) { return i < 0 ? i + n : (i >= n ? i - n : i); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// Moments and the pair-shared quadratic equilibrium of one voxel's
// post-streaming populations fs. Shared by the forward (collide_voxel) and
// the adjoint kernel (adjoint_step.cu), so the adjoint linearises the very
// arithmetic the forward ran.
__device__ __forceinline__ void moments_equilibrium(const float fs[XLB_Q], const XlbStepParams& p, float& rho,
                                                    float& inv_rho, float u[3], float feq[XLB_Q]) {
  // moments
  rho = fs[0];
#pragma unroll
  for (int l = 1; l < XLB_Q; ++l) rho = rho + fs[l];
  inv_rho = 1.0f / rho;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float acc = 0.0f;
    bool have = false;
#pragma unroll
    for (int l = 0; l < XLB_Q; ++l) {
      const int ca = c_dir(a, l);
      if (ca == 0) continue;
      const float t = ca == 1 ? fs[l] : -fs[l];
      acc = have ? acc + t : t;
      have = true;
    }
    u[a] = acc * inv_rho;
  }

  // pair-shared quadratic equilibrium: feq_{l,o} = rho w (t +- cu3) with the
  // shared even part t = (1 - 1.5 u^2) + cu3^2 / 2
  float usqr = u[0] * u[0];
  usqr = usqr + u[1] * u[1];
  usqr = usqr + u[2] * u[2];
  const float base = 1.0f - 1.5f * usqr;
#pragma unroll
  for (int l = 0; l < XLB_Q; ++l) {
    const int o = c_opp(l);
    if (o < l) continue;  // pair handled at its lower index
    const float rw = rho * p.w[l];
    if (o == l) {
      feq[l] = rw * base;
      continue;
    }
    float cu = 0.0f;
    bool have = false;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int ca = c_dir(a, l);
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

// The post-streaming populations of one voxel: the 19 pulls (store form,
// as f32), the shifted load (+ w_l) and the streaming-step epilogues.
// Returns whether an "equilibrium" BC replaced them by its constants.
template <bool SHIFTED, typename Pull>
__device__ __forceinline__ bool streamed_populations(const Pull& pull, int bc, const XlbStepParams& p,
                                                     float fs[XLB_Q]) {
#pragma unroll
  for (int l = 0; l < XLB_Q; ++l) {
    fs[l] = pull(l);
    if constexpr (SHIFTED) fs[l] += p.w[l];
  }
  bool fixed = false;
  for (int b = 0; b < p.n_bc; ++b) {
    if (p.bc_kind[b] == XLB_BC_EQUILIBRIUM && bc == p.bc_id[b]) {
#pragma unroll
      for (int l = 0; l < XLB_Q; ++l) fs[l] = p.bc_feq[b][l];
      fixed = true;
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
template <bool SHIFTED, typename Pull, typename Center>
__device__ __forceinline__ void collide_voxel(const Pull& pull, const Center& center, int packed, float omega,
                                              const XlbStepParams& p, float out[XLB_Q]) {
  const int bc = cell_type(packed);

  float fs[XLB_Q];
  streamed_populations<SHIFTED>(pull, bc, p, fs);

  float rho, inv_rho, u[3], feq[XLB_Q];
  moments_equilibrium(fs, p, rho, inv_rho, u, feq);

  // BGK
#pragma unroll
  for (int l = 0; l < XLB_Q; ++l) out[l] = fs[l] - omega * (fs[l] - feq[l]);

  // collision-step epilogues
  if (is_fullway(bc, p)) {
#pragma unroll
    for (int l = 0; l < XLB_Q; ++l) out[l] = fs[c_opp(l)];
  }

  // solid keep-out
  if (is_solid(bc, p)) {
#pragma unroll
    for (int l = 0; l < XLB_Q; ++l) {
      float v = center(l);
      if constexpr (SHIFTED) v += p.w[l];
      out[l] = v;
    }
  }

  if constexpr (SHIFTED) {
#pragma unroll
    for (int l = 0; l < XLB_Q; ++l) out[l] = out[l] - p.w[l];
  }
}

}  // namespace xlb
