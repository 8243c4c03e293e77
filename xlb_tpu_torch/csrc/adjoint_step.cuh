// Fused adjoint (backward) of the single 3D collide-stream step for Hopper
// (sm_90a): a member of the kernel family of collide_stream_3d.cuh, as a
// template over the stencil S (D3Q19, D3Q27), the collision C, the store
// dtype T of the primal, shifted storage, the EXT switch (kExtHalfway: the
// halfway epilogue) and FORCE (the exact-difference body force).
// Instantiated per (stencil, collision) pair with the forward kernels and
// launched through collide_stream.cu's xlb_collide_stream_adjoint.
//
// adjoint_kernel replaces the TPU kernel
// xlb_tpu/kernels/adjoint_step.py::build_fused_adjoint_3d for every
// configuration the forward K1 takes: every collision, D3Q27, the body
// force, the streaming-step "equilibrium" and "halfway" BCs, the
// collision-step "fullway" BC, the solid keep-out, plain or shifted storage.
//
// With the forward written per voxel y as out_l(y) = Phi_l(fs(y), fp(y), w)
// for the pulled populations fs_m(y) = f_m[y - c_m] and the centred ones
// fp_m(y) = f_m[y], the cotangent g of out gives
//
//   df_m[x] = h_fs_m(x + c_m) + h_fp_m(x),   dom(y) = dPhi/domega(y)^T g(y)
//
// The TPU kernel takes h = J^T g from jax.vjp at trace time. Here, per
// voxel y with cotangent g = g(y):
//
// - shifted load (+ w_l) and store (- w_l): constant shifts, the gradient
//   passes through unchanged;
// - solid voxel (has_solids, the stencil's solid id; out := fp): h_fp = g,
//   h_fs = 0, dom = 0;
// - "fullway" voxel (out_l := fs_opp(l)): h_fs_m = g_opp(m), dom = 0;
// - every other voxel runs collide_physics (moments, equilibrium, the
//   collision, the force) on its post-epilogue populations fs, and
//   h = (d out / d fs)^T g, dom = g . d out / d omega:
//   - unforced BGK, out_l = (1 - w) fs_l + w feq_l(rho, u) with
//     rho = sum fs and u = sum c fs / rho, by hand (bgk_vjp):
//       h_m = (1 - w) g_m + w (A + sum_a c_ma B_a),
//       B_a = (dG/du_a) / rho = sum_l g_l w_l c_la (3 + 9 cu_l) - 3 u_a sum_l g_l w_l,
//       A = G / rho - sum_a B_a u_a,   G = sum_l g_l feq_l,   cu_l = c_l . u,
//       dom = sum_l g_l (feq_l - fs_l);
//   - every other collision and the force in forward mode (physics_vjp):
//     collide_physics on Dual numbers, once per input direction j with the
//     tangent e_j (h_j = g . d out / d fs_j) and once with omega's tangent,
//     so the transpose is the forward's own arithmetic differentiated, as
//     jax.vjp differentiates the TPU kernel's body, with no derivation per
//     collision. It costs q + 1 passes of the physics per voxel;
// - "equilibrium" voxel (fs := feq constants): h_fs = 0 after the above,
//   while the physics still runs on the constants, so dom is kept;
// - "halfway" voxel: a missing direction l took fs_l := fp_opp(l) (+ the
//   constant wall term), so its h_l belongs to h_fp_opp(l), not h_fs_l.
//
// Push side: df_m[x] gathers h_fs_m from y = x + c_m, so the thread of
// voxel y writes h_fs_m(y) to df_m[y - c_m] (periodic wrap). Each (m, x)
// has exactly one writer and no atomics are needed. The solid term
// h_fp_m[x] = g_m[x] is folded into that write: when has_solids, the
// writing thread reads the mask of x (a cache hit mostly) and adds g_m[x]
// where x is solid. The halfway term h_fp_opp(l)[x] += h_l(x) has another
// owner, so a second launch (adjoint_halfway_kernel, only for scenes with a
// halfway BC) recomputes h at the halfway voxels with missing directions
// and adds it in place; its threads touch only their own voxel's entries.
//
// One thread per voxel, threads along z, so for each m a warp's q pulls of
// the primal, its q cotangent loads and its q pushed stores are coalesced.
// Unforced BGK is bound by device-memory bytes: q primal loads, q f32
// cotangent loads, the 4-byte mask, q f32 stores of df and one of dom --
// 236 B per voxel on D3Q19 with an f32 primal, 198 B with bf16 -- against
// ~500 flops. The forward-mode route is bound by its q + 1 physics passes.
// Like step_kernel, this first version leaves the reuse of the neighbours'
// primal loads to L1 and L2.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "collide_stream.cuh"

namespace xlb {

constexpr int kAdjointThreads = 256;

// h = (d out / d fs)^T g and dom = g . d out / d omega of unforced BGK, by hand.
template <class S>
__device__ __forceinline__ void bgk_vjp(const float fs[S::q], const float g[S::q], float omega,
                                        const XlbStepParams& p, float h[S::q], float& dom) {
  float rho, inv_rho, u[S::d], feq[S::q];
  moments_equilibrium<S>(fs, p, rho, inv_rho, u, feq);
  float G = 0.0f, gw = 0.0f, P[S::d];
  dom = 0.0f;
#pragma unroll
  for (int a = 0; a < S::d; ++a) P[a] = 0.0f;
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    G += g[l] * feq[l];
    dom += g[l] * (feq[l] - fs[l]);
    const float gwl = g[l] * p.w[l];
    gw += gwl;
    float cu = 0.0f;
#pragma unroll
    for (int a = 0; a < S::d; ++a) {
      if (S::c(a, l) == 1) cu += u[a];
      if (S::c(a, l) == -1) cu -= u[a];
    }
    const float t = gwl * (3.0f + 9.0f * cu);
#pragma unroll
    for (int a = 0; a < S::d; ++a) {
      if (S::c(a, l) == 1) P[a] += t;
      if (S::c(a, l) == -1) P[a] -= t;
    }
  }
  float B[S::d], bu = 0.0f;
#pragma unroll
  for (int a = 0; a < S::d; ++a) {
    B[a] = P[a] - 3.0f * u[a] * gw;
    bu += B[a] * u[a];
  }
  const float A = G * inv_rho - bu;
#pragma unroll
  for (int m = 0; m < S::q; ++m) {
    float jt = A;
#pragma unroll
    for (int a = 0; a < S::d; ++a) {
      if (S::c(a, m) == 1) jt += B[a];
      if (S::c(a, m) == -1) jt -= B[a];
    }
    h[m] = (1.0f - omega) * g[m] + omega * jt;
  }
}

// h and dom of collide_physics<S, C, FORCE> in forward mode: pass j < q
// seeds fs_j's tangent, pass q omega's. Not inlined, so the q + 1 passes
// share one copy of the physics and the store forms share one function.
template <class S, class C, bool FORCE>
__device__ __noinline__ void physics_vjp(const float* fs, const float* g, float omega, const XlbStepParams& p,
                                         float* h, float* dom) {
#pragma unroll 1
  for (int j = 0; j <= S::q; ++j) {
    Dual x[S::q], y[S::q];
#pragma unroll
    for (int l = 0; l < S::q; ++l) x[l] = Dual(fs[l], l == j ? 1.0f : 0.0f);
    collide_physics<S, C, FORCE>(x, Dual(omega, j == S::q ? 1.0f : 0.0f), p, y);
    float acc = 0.0f;
#pragma unroll
    for (int l = 0; l < S::q; ++l) acc += g[l] * y[l].d;
    if (j < S::q) h[j] = acc;
    else *dom = acc;
  }
}

template <class S, class C, bool FORCE>
__device__ __forceinline__ void voxel_vjp(const float fs[S::q], const float g[S::q], float omega,
                                          const XlbStepParams& p, float h[S::q], float& dom) {
  if constexpr (std::is_same<C, CollBGK>::value && !FORCE) {
    bgk_vjp<S>(fs, g, omega, p, h, dom);
  } else {
    physics_vjp<S, C, FORCE>(fs, g, omega, p, h, &dom);
  }
}

template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE>
__global__ void __launch_bounds__(kAdjointThreads)
    adjoint_kernel(const T* __restrict__ f, const float* __restrict__ g, const int* __restrict__ mask,
                   float* __restrict__ df, float* __restrict__ dom, int X, int Y, int Z, float omega,
                   const __grid_constant__ XlbStepParams p) {
  const unsigned n = unsigned(X) * unsigned(Y) * unsigned(Z);
  const unsigned v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int z = int(v % unsigned(Z));
  const unsigned xy = v / unsigned(Z);
  const int y = int(xy % unsigned(Y));
  const int x = int(xy / unsigned(Y));
  const size_t plane = n;

  // pull source of direction l = push target of direction l
  auto neighbour = [&](int l) {
    const int xs = wrap1(x - S::c(0, l), X);
    const int ys = wrap1(y - S::c(1, l), Y);
    const int zs = wrap1(z - S::c(2, l), Z);
    return (size_t(xs) * Y + ys) * Z + zs;
  };
  auto pull = [&](int l) { return to_f32(f[l * plane + neighbour(l)]); };
  auto center = [&](int l) { return to_f32(f[l * plane + v]); };

  const int packed = mask[v];
  const int bc = cell_type<S>(packed);
  float fs[S::q];
  const bool fixed = streamed_populations<S, SHIFTED, EXT>(pull, center, packed, p, fs);

  float gv[S::q];
#pragma unroll
  for (int l = 0; l < S::q; ++l) gv[l] = g[l * plane + v];

  float h[S::q];
  float d_omega = 0.0f;
  if (is_solid<S>(bc, p)) {
#pragma unroll
    for (int m = 0; m < S::q; ++m) h[m] = 0.0f;
  } else if (is_fullway(bc, p)) {
#pragma unroll
    for (int m = 0; m < S::q; ++m) h[m] = gv[S::opp(m)];
  } else {
    voxel_vjp<S, C, FORCE>(fs, gv, omega, p, h, d_omega);
    if constexpr (EXT != kExtNone) {
      if (has_bc_kind(bc, p, XLB_BC_HALFWAY)) {
#pragma unroll
        for (int m = 0; m < S::q; ++m)
          if (missing_bit(packed, m)) h[m] = 0.0f;  // a centred population's: adjoint_halfway_kernel
      }
    }
  }
  if (fixed) {
#pragma unroll
    for (int m = 0; m < S::q; ++m) h[m] = 0.0f;
  }

#pragma unroll
  for (int m = 0; m < S::q; ++m) {
    const size_t t = neighbour(m);
    float d = h[m];
    if (p.has_solids && cell_type<S>(mask[t]) == S::solid_id) d += g[m * plane + t];
    df[m * plane + t] = d;
  }
  dom[v] = d_omega;
}

// The halfway term, after adjoint_kernel: at each halfway voxel x with
// missing directions, df_opp(l)[x] += h_l(x) for every missing l.
template <class S, class C, typename T, bool SHIFTED, bool FORCE>
__global__ void __launch_bounds__(kAdjointThreads)
    adjoint_halfway_kernel(const T* __restrict__ f, const float* __restrict__ g, const int* __restrict__ mask,
                           float* __restrict__ df, int X, int Y, int Z, float omega,
                           const __grid_constant__ XlbStepParams p) {
  const unsigned n = unsigned(X) * unsigned(Y) * unsigned(Z);
  const unsigned v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int packed = mask[v];
  const int bc = cell_type<S>(packed);
  if ((packed & ((1 << S::q) - 1)) == 0 || !has_bc_kind(bc, p, XLB_BC_HALFWAY)) return;
  const int z = int(v % unsigned(Z));
  const unsigned xy = v / unsigned(Z);
  const int y = int(xy % unsigned(Y));
  const int x = int(xy / unsigned(Y));
  const size_t plane = n;

  auto pull = [&](int l) {
    const int xs = wrap1(x - S::c(0, l), X);
    const int ys = wrap1(y - S::c(1, l), Y);
    const int zs = wrap1(z - S::c(2, l), Z);
    return to_f32(f[l * plane + (size_t(xs) * Y + ys) * Z + zs]);
  };
  auto center = [&](int l) { return to_f32(f[l * plane + v]); };
  float fs[S::q], gv[S::q], h[S::q], d_omega;
  streamed_populations<S, SHIFTED, kExtHalfway>(pull, center, packed, p, fs);
#pragma unroll
  for (int l = 0; l < S::q; ++l) gv[l] = g[l * plane + v];
  voxel_vjp<S, C, FORCE>(fs, gv, omega, p, h, d_omega);
#pragma unroll
  for (int l = 0; l < S::q; ++l)
    if (missing_bit(packed, l)) df[S::opp(l) * plane + v] += h[l];
}

}  // namespace xlb
