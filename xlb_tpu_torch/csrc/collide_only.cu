// The multires per-level collide (K5) for Hopper (sm_90a), bound through
// the plain C launcher at the end of this file (ctypes,
// xlb_tpu_torch/kernels/_cuda.py).
//
// collide_kernel replaces the TPU kernel
// xlb_tpu/kernels/collide_only.py::build_fused_collide: per voxel of a
// float32 (q, N) level (N = the level's voxels, flattened), moments, the
// pair-shared quadratic equilibrium, BGK, the collision-step fullway
// epilogue and the solid keep-out, with the device functions of
// collide_stream.cuh. One thread per voxel, consecutive threads on
// consecutive voxels, so each of the 19 loads and 19 stores of a warp is
// coalesced; the ragged last block is masked, where the TPU padded N to a
// tile multiple with rest-state cells. Bound by device-memory bytes: 19 f32
// loads, 19 f32 stores and the 4-byte mask, 156 B per voxel, against ~200
// flops.

#include <cuda_runtime.h>

#include "collide_stream.cuh"

namespace xlb {

constexpr int kCollideThreads = 256;

__global__ void __launch_bounds__(kCollideThreads)
    collide_kernel(const float* __restrict__ f, const int* __restrict__ mask, float* __restrict__ out, unsigned n,
                   float omega, const __grid_constant__ XlbStepParams p) {
  const unsigned v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const size_t plane = n;
  float fs[D3Q19::q];
#pragma unroll
  for (int l = 0; l < D3Q19::q; ++l) fs[l] = f[l * plane + v];
  const int bc = cell_type(mask[v]);

  float rho, inv_rho, u[D3Q19::d], feq[D3Q19::q], o[D3Q19::q];
  moments_equilibrium<D3Q19>(fs, p, rho, inv_rho, u, feq);
#pragma unroll
  for (int l = 0; l < D3Q19::q; ++l) o[l] = fs[l] - omega * (fs[l] - feq[l]);
  if (is_fullway(bc, p)) {
#pragma unroll
    for (int l = 0; l < D3Q19::q; ++l) o[l] = fs[D3Q19::opp(l)];
  }
  if (is_solid(bc, p)) {
#pragma unroll
    for (int l = 0; l < D3Q19::q; ++l) o[l] = fs[l];
  }
#pragma unroll
  for (int l = 0; l < D3Q19::q; ++l) out[l * plane + v] = o[l];
}

}  // namespace xlb

extern "C" {

// Returns the cudaError_t of the launch.
int xlb_collide_only(const void* f, const void* mask, void* out, int n, float omega, const XlbStepParams* params,
                     void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned(n) + xlb::kCollideThreads - 1) / xlb::kCollideThreads;
  xlb::collide_kernel<<<blocks, xlb::kCollideThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const int*>(mask), static_cast<float*>(out), unsigned(n), omega,
      *params);
  return cudaGetLastError();
}

}  // extern "C"
