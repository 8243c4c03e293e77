// Fused adjoint (backward) of the single D3Q19 collide-stream step for
// Hopper (sm_90a), bound to Python through the plain C launcher at the end
// of this file (ctypes, xlb_tpu_torch/kernels/_cuda.py).
//
// adjoint_kernel replaces the TPU kernel
// xlb_tpu/kernels/adjoint_step.py::build_fused_adjoint_3d for the epilogue
// kinds of collide_voxel (collide_stream.cuh): BGK, the streaming-step
// "equilibrium" BC, the collision-step "fullway" BC, the solid keep-out,
// plain or shifted storage.
//
// With the forward written per voxel y as out_l(y) = Phi_l(fs(y), fp(y), w)
// for the pulled populations fs_m(y) = f_m[y - c_m] and the centred ones
// fp_m(y) = f_m[y], the cotangent g of out gives
//
//   df_m[x] = h_fs_m(x + c_m) + h_fp_m(x),   dom(y) = dPhi/domega(y)^T g(y)
//
// The TPU kernel takes h = J^T g from jax.vjp at trace time. Here the
// transpose is derived by hand, per voxel y with cotangent g = g(y):
//
// - shifted load (+ w_l) and store (- w_l): constant shifts, the gradient
//   passes through unchanged;
// - solid voxel (has_solids, cell type 255; out := fp): h_fp = g, h_fs = 0,
//   dom = 0;
// - "fullway" voxel (out_l := fs_opp(l)): h_fs_m = g_opp(m), dom = 0;
// - BGK, out_l = (1 - w) fs_l + w feq_l(rho, u) with rho = sum fs and
//   u = sum c fs / rho:
//     h_fs_m = (1 - w) g_m + w (A + sum_a c_ma B_a),
//     B_a = (dG/du_a) / rho = sum_l g_l w_l c_la (3 + 9 cu_l) - 3 u_a sum_l g_l w_l,
//     A = G / rho - sum_a B_a u_a,   G = sum_l g_l feq_l,   cu_l = c_l . u,
//     dom = sum_l g_l (feq_l - fs_l);
// - "equilibrium" voxel (fs := feq constants): h_fs = 0 after the above,
//   while its BGK still runs on the constants, so dom is kept.
//
// The forward recomputed here is the forward K1 ran: the pulls, the
// epilogues and moments_equilibrium are the same device functions.
//
// Push side: df_m[x] gathers h_fs_m from y = x + c_m, so the thread of
// voxel y writes h_fs_m(y) to df_m[y - c_m] (periodic wrap). Each (m, x)
// has exactly one writer and no atomics are needed. The solid term
// h_fp_m[x] = g_m[x] is folded into that write: when has_solids, the
// writing thread reads the mask of x (a cache hit mostly) and adds g_m[x]
// where x is solid. Without solids this costs nothing.
//
// One thread per voxel, threads along z, so for each m a warp's 19 pulls
// of the primal, its 19 cotangent loads and its 19 pushed stores are
// coalesced. The kernel is bound by device-memory bytes: 19 primal loads,
// 19 f32 cotangent loads, the 4-byte mask, 19 f32 stores of df and one of
// dom -- 236 B per voxel with an f32 primal, 198 B with bf16 -- against
// ~550 flops. Like step_kernel, this first version leaves the reuse of the
// neighbours' primal loads to L1 and L2; TMA staging is left to later work.

#include <cuda_runtime.h>

#include "collide_stream.cuh"

namespace xlb {

constexpr int kAdjointThreads = 256;

template <typename T, bool SHIFTED>
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
    const int xs = wrap1(x - D3Q19::c(0, l), X);
    const int ys = wrap1(y - D3Q19::c(1, l), Y);
    const int zs = wrap1(z - D3Q19::c(2, l), Z);
    return (size_t(xs) * Y + ys) * Z + zs;
  };
  auto pull = [&](int l) { return to_f32(f[l * plane + neighbour(l)]); };

  const int packed = mask[v];
  const int bc = cell_type(packed);
  float fs[D3Q19::q];
  const bool fixed = streamed_populations<D3Q19, SHIFTED, false>(pull, pull, packed, p, fs);

  float gv[D3Q19::q];
#pragma unroll
  for (int l = 0; l < D3Q19::q; ++l) gv[l] = g[l * plane + v];

  float h[D3Q19::q];
  float d_omega = 0.0f;
  if (is_solid(bc, p)) {
#pragma unroll
    for (int m = 0; m < D3Q19::q; ++m) h[m] = 0.0f;
  } else if (is_fullway(bc, p)) {
#pragma unroll
    for (int m = 0; m < D3Q19::q; ++m) h[m] = gv[D3Q19::opp(m)];
  } else {
    float rho, inv_rho, u[3], feq[D3Q19::q];
    moments_equilibrium<D3Q19>(fs, p, rho, inv_rho, u, feq);
    float G = 0.0f, gw = 0.0f, P[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int l = 0; l < D3Q19::q; ++l) {
      G += gv[l] * feq[l];
      d_omega += gv[l] * (feq[l] - fs[l]);
      const float gwl = gv[l] * p.w[l];
      gw += gwl;
      float cu = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (D3Q19::c(a, l) == 1) cu += u[a];
        if (D3Q19::c(a, l) == -1) cu -= u[a];
      }
      const float t = gwl * (3.0f + 9.0f * cu);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (D3Q19::c(a, l) == 1) P[a] += t;
        if (D3Q19::c(a, l) == -1) P[a] -= t;
      }
    }
    float B[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) B[a] = P[a] - 3.0f * u[a] * gw;
    const float A = G * inv_rho - (B[0] * u[0] + B[1] * u[1] + B[2] * u[2]);
#pragma unroll
    for (int m = 0; m < D3Q19::q; ++m) {
      float jt = A;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (D3Q19::c(a, m) == 1) jt += B[a];
        if (D3Q19::c(a, m) == -1) jt -= B[a];
      }
      h[m] = (1.0f - omega) * gv[m] + omega * jt;
    }
  }
  if (fixed) {
#pragma unroll
    for (int m = 0; m < D3Q19::q; ++m) h[m] = 0.0f;
  }

#pragma unroll
  for (int m = 0; m < D3Q19::q; ++m) {
    const size_t t = neighbour(m);
    float d = h[m];
    if (p.has_solids && cell_type(mask[t]) == XLB_SOLID_ID) d += g[m * plane + t];
    df[m * plane + t] = d;
  }
  dom[v] = d_omega;
}

template <typename T, bool SHIFTED>
cudaError_t launch_adjoint(const void* f, const void* g, const void* mask, void* df, void* dom, int X, int Y, int Z,
                           float omega, const XlbStepParams& p, cudaStream_t stream) {
  const unsigned n = unsigned(X) * unsigned(Y) * unsigned(Z);
  const unsigned blocks = (n + kAdjointThreads - 1) / kAdjointThreads;
  adjoint_kernel<T, SHIFTED><<<blocks, kAdjointThreads, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const float*>(g), static_cast<const int*>(mask), static_cast<float*>(df),
      static_cast<float*>(dom), X, Y, Z, omega, p);
  return cudaGetLastError();
}

}  // namespace xlb

extern "C" {

// store_kind of the primal: 0 = float32, 1 = bfloat16; the cotangent g and
// the outputs df (q, X, Y, Z) and dom (X, Y, Z) are float32. Returns the
// cudaError_t of the launch.
int xlb_collide_stream_adjoint(int store_kind, int shifted, const void* f, const void* g, const void* mask, void* df,
                               void* dom, int X, int Y, int Z, float omega, const XlbStepParams* params,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const XlbStepParams& p = *params;
  if (store_kind == 0)
    return shifted ? xlb::launch_adjoint<float, true>(f, g, mask, df, dom, X, Y, Z, omega, p, s)
                   : xlb::launch_adjoint<float, false>(f, g, mask, df, dom, X, Y, Z, omega, p, s);
  if (store_kind == 1)
    return shifted ? xlb::launch_adjoint<__nv_bfloat16, true>(f, g, mask, df, dom, X, Y, Z, omega, p, s)
                   : xlb::launch_adjoint<__nv_bfloat16, false>(f, g, mask, df, dom, X, Y, Z, omega, p, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
