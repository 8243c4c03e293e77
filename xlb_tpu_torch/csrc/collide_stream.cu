// Fused D3Q19 BGK collide-stream kernels for Hopper (sm_90a), bound to
// Python through the plain C launchers at the end of this file (ctypes,
// xlb_tpu_torch/kernels/_cuda.py).
//
// Layout: populations (q, X, Y, Z) in the store dtype (f32 or bf16), z
// contiguous; the packed int32 mask (X, Y, Z) of
// xlb_tpu_torch/kernels/fused_step.py::pack_masks.
//
// step_kernel replaces the TPU kernel
// xlb_tpu/kernels/collide_stream_dma.py::build_fused_collide_stream_3d_dma
// (plain mode, with and without shifted storage). One thread per voxel,
// threads along z, so each of the 19 pull loads of a warp is coalesced;
// pull sources wrap periodically. The kernel is bound by device-memory
// bytes: per voxel per step it moves 19 loads, 19 stores and the 4-byte
// mask, 156 B in f32 and 80 B in bf16, against ~250 flops. This first
// version leaves the reuse of the neighbours' loads to L1 and L2.
//
// kstep_kernel replaces
// xlb_tpu/kernels/collide_stream_2step.py::build_fused_collide_stream_3d_kstep
// (plain mode, k >= 2). A block owns a (TX, TY, TZ) output tile and runs k
// sweeps on regions that shrink by one voxel per side. The first sweep
// computes the depth-(k-1) region around the tile, pulling straight from
// device memory like step_kernel (L1/L2 serve the overlap between blocks);
// every later sweep pulls from the previous one in shared memory, where
// each intermediate is rounded to the store dtype -- so k-step equals k
// single steps to store-dtype roundoff while device memory sees one read
// and one write of the populations per k steps. A first version also
// staged the depth-k input halo in shared memory, as the TPU kernel does in
// VMEM: with one 217 KB block per SM its load loop was latency and
// index-arithmetic bound, 15-30x slower than two single steps on an H100,
// so the input now goes through the caches. Only the sweep buffers live in
// shared memory; the wrapper sizes the tile so that two 256-thread blocks
// fit on an SM (bf16 4x8x32 at k=2: 78 KB; f32 4x4x32: 93 KB). TMA,
// clusters and tile tuning are left to later work.

#include <cuda_runtime.h>

#include "collide_stream.cuh"

namespace xlb {

constexpr int kStepThreads = 256;
constexpr int kKstepThreads = 256;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB opt-in limit per block on sm_90

__host__ __device__ inline size_t halo_volume(int h, int tx, int ty, int tz) {
  return size_t(tx + 2 * h) * size_t(ty + 2 * h) * size_t(tz + 2 * h);
}

// Shared-memory layout of kstep_kernel: sweep buffer A (depth K-1) | sweep
// buffer B (depth K-2, only for K > 2). Mirrored by kstep_smem_bytes in
// collide_stream_2step.py.
__host__ __device__ inline size_t kstep_smem_bytes(int k, int tx, int ty, int tz, size_t tsize) {
  size_t b = align16(D3Q19::q * halo_volume(k - 1, tx, ty, tz) * tsize);
  if (k > 2) b += align16(D3Q19::q * halo_volume(k - 2, tx, ty, tz) * tsize);
  return b;
}

template <typename T, bool SHIFTED>
__global__ void __launch_bounds__(kStepThreads)
    step_kernel(const T* __restrict__ f, const int* __restrict__ mask, T* __restrict__ out, int X, int Y, int Z,
                float omega, const __grid_constant__ XlbStepParams p) {
  const unsigned n = unsigned(X) * unsigned(Y) * unsigned(Z);
  const unsigned v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int z = int(v % unsigned(Z));
  const unsigned xy = v / unsigned(Z);
  const int y = int(xy % unsigned(Y));
  const int x = int(xy / unsigned(Y));
  const size_t plane = n;

  auto pull = [&](int l) {
    const int xs = wrap1(x - D3Q19::c(0, l), X);
    const int ys = wrap1(y - D3Q19::c(1, l), Y);
    const int zs = wrap1(z - D3Q19::c(2, l), Z);
    return to_f32(f[l * plane + (size_t(xs) * Y + ys) * Z + zs]);
  };
  auto center = [&](int l) { return to_f32(f[l * plane + v]); };

  float o[D3Q19::q];
  collide_voxel<D3Q19, SHIFTED, false>(pull, center, mask[v], omega, p, o);
#pragma unroll
  for (int l = 0; l < D3Q19::q; ++l) out[l * plane + v] = from_f32<T>(o[l]);
}

template <typename T, bool SHIFTED>
__global__ void __launch_bounds__(kKstepThreads)
    kstep_kernel(const T* __restrict__ f, const int* __restrict__ mask, T* __restrict__ out, int X, int Y, int Z,
                 int TX, int TY, int TZ, int K, float omega, const __grid_constant__ XlbStepParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t plane = size_t(X) * Y * Z;
  const int x0 = blockIdx.z * TX, y0 = blockIdx.y * TY, z0 = blockIdx.x * TZ;
  T* s_a = reinterpret_cast<T*>(smem);
  T* s_b = reinterpret_cast<T*>(smem + align16(D3Q19::q * halo_volume(K - 1, TX, TY, TZ) * sizeof(T)));

  for (int s = 1; s <= K; ++s) {
    const int h = K - s;  // sweep s writes the depth-h region around the tile
    const int ex = TX + 2 * h, ey = TY + 2 * h, ez = TZ + 2 * h, vol = ex * ey * ez;
    const int sy = ey + 2, sz = ez + 2, svol = (ex + 2) * sy * sz;  // its source has depth h + 1
    const T* src = s % 2 == 0 ? s_a : s_b;                        // sweeps 2..K read shared memory
    T* dst = s % 2 == 1 ? s_a : s_b;                              // unused by the last sweep
    for (int i = threadIdx.x; i < vol; i += blockDim.x) {
      int r = i;
      const int iz = r % ez;
      r /= ez;
      const int iy = r % ey;
      const int ix = r / ey;
      const int gx = wrapmod(x0 - h + ix, X), gy = wrapmod(y0 - h + iy, Y), gz = wrapmod(z0 - h + iz, Z);
      const size_t g = (size_t(gx) * Y + gy) * Z + gz;
      const int packed = mask[g];

      float o[D3Q19::q];
      if (s == 1) {
        // first sweep: pull from device memory through L1/L2
        auto pull = [&](int l) {
          const int xs = wrap1(gx - D3Q19::c(0, l), X);
          const int ys = wrap1(gy - D3Q19::c(1, l), Y);
          const int zs = wrap1(gz - D3Q19::c(2, l), Z);
          return to_f32(f[l * plane + (size_t(xs) * Y + ys) * Z + zs]);
        };
        auto center = [&](int l) { return to_f32(f[l * plane + g]); };
        collide_voxel<D3Q19, SHIFTED, false>(pull, center, packed, omega, p, o);
      } else {
        // region-local index in the source: dst index + 1 - c_l
        auto pull = [&](int l) {
          return to_f32(src[l * svol + ((ix + 1 - D3Q19::c(0, l)) * sy + (iy + 1 - D3Q19::c(1, l))) * sz +
                            (iz + 1 - D3Q19::c(2, l))]);
        };
        auto center = [&](int l) { return to_f32(src[l * svol + ((ix + 1) * sy + (iy + 1)) * sz + (iz + 1)]); };
        collide_voxel<D3Q19, SHIFTED, false>(pull, center, packed, omega, p, o);
      }
      if (s < K) {
#pragma unroll
        for (int l = 0; l < D3Q19::q; ++l) dst[l * vol + i] = from_f32<T>(o[l]);  // store-dtype rounding
      } else if (x0 + ix < X && y0 + iy < Y && z0 + iz < Z) {
#pragma unroll
        for (int l = 0; l < D3Q19::q; ++l) out[l * plane + g] = from_f32<T>(o[l]);
      }
    }
    __syncthreads();
  }
}

template <typename T, bool SHIFTED>
cudaError_t launch_step(const void* f, const void* mask, void* out, int X, int Y, int Z, float omega,
                        const XlbStepParams& p, cudaStream_t stream) {
  const unsigned n = unsigned(X) * unsigned(Y) * unsigned(Z);
  const unsigned blocks = (n + kStepThreads - 1) / kStepThreads;
  step_kernel<T, SHIFTED><<<blocks, kStepThreads, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const int*>(mask), static_cast<T*>(out), X, Y, Z, omega, p);
  return cudaGetLastError();
}

template <typename T, bool SHIFTED>
cudaError_t launch_kstep(const void* f, const void* mask, void* out, int X, int Y, int Z, int TX, int TY, int TZ,
                         int K, float omega, const XlbStepParams& p, cudaStream_t stream) {
  const size_t smem = kstep_smem_bytes(K, TX, TY, TZ, sizeof(T));
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kstep_kernel<T, SHIFTED>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Z + TZ - 1) / TZ, (Y + TY - 1) / TY, (X + TX - 1) / TX);
  kstep_kernel<T, SHIFTED><<<grid, kKstepThreads, smem, stream>>>(
      static_cast<const T*>(f), static_cast<const int*>(mask), static_cast<T*>(out), X, Y, Z, TX, TY, TZ, K, omega,
      p);
  return cudaGetLastError();
}

}  // namespace xlb

extern "C" {

// store_kind: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int xlb_collide_stream_step(int store_kind, int shifted, const void* f, const void* mask, void* out, int X, int Y,
                            int Z, float omega, const XlbStepParams* params, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const XlbStepParams& p = *params;
  if (store_kind == 0)
    return shifted ? xlb::launch_step<float, true>(f, mask, out, X, Y, Z, omega, p, s)
                   : xlb::launch_step<float, false>(f, mask, out, X, Y, Z, omega, p, s);
  if (store_kind == 1)
    return shifted ? xlb::launch_step<__nv_bfloat16, true>(f, mask, out, X, Y, Z, omega, p, s)
                   : xlb::launch_step<__nv_bfloat16, false>(f, mask, out, X, Y, Z, omega, p, s);
  return cudaErrorInvalidValue;
}

int xlb_collide_stream_kstep(int store_kind, int shifted, int steps, const void* f, const void* mask, void* out,
                             int X, int Y, int Z, int TX, int TY, int TZ, float omega, const XlbStepParams* params,
                             void* stream) {
  if (steps < 2 || TX < 1 || TY < 1 || TZ < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const XlbStepParams& p = *params;
  if (store_kind == 0)
    return shifted ? xlb::launch_kstep<float, true>(f, mask, out, X, Y, Z, TX, TY, TZ, steps, omega, p, s)
                   : xlb::launch_kstep<float, false>(f, mask, out, X, Y, Z, TX, TY, TZ, steps, omega, p, s);
  if (store_kind == 1)
    return shifted ? xlb::launch_kstep<__nv_bfloat16, true>(f, mask, out, X, Y, Z, TX, TY, TZ, steps, omega, p, s)
                   : xlb::launch_kstep<__nv_bfloat16, false>(f, mask, out, X, Y, Z, TX, TY, TZ, steps, omega, p, s);
  return cudaErrorInvalidValue;
}

const char* xlb_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int xlb_params_size(void) { return int(sizeof(XlbStepParams)); }

}  // extern "C"
