// Fused D2Q9 BGK collide-stream kernels for Hopper (sm_90a), bound to
// Python through the plain C launchers at the end of this file (ctypes,
// xlb_tpu_torch/kernels/_cuda.py).
//
// Layout: populations (9, X, Y) in the store dtype (f32 or bf16), y
// contiguous; the packed int32 mask (X, Y) of
// xlb_tpu_torch/kernels/fused_step.py::pack_masks.
//
// step_2d_kernel replaces the TPU kernel
// xlb_tpu/kernels/collide_stream_2d.py::build_fused_collide_stream_2d. On
// the TPU, Y lives in lanes (y pulls are lane rolls) and x halos arrive as
// 8-row blocks of which one row is used. Here: one thread per voxel,
// threads along y (the contiguous axis, so each of the 9 pull loads of a
// warp is coalesced), pulls wrapping periodically straight from device
// memory, L1/L2 serving the reuse -- what step_kernel does in 3D. It is
// bound by device-memory bytes: 9 loads, 9 stores and the 4-byte mask per
// voxel, 76 B in f32 and 40 B in bf16, against ~100 flops.
//
// kstep_2d_kernel replaces
// xlb_tpu/kernels/collide_stream_2d.py::build_fused_collide_stream_2d_kstep
// (2 <= K <= 8). On the TPU the k-step is nearly free: the 8-row x-halo
// blocks already cover depth <= 8 and y, lane-resident, needs no halo.
// Here nothing is resident, so a block stages its (TX, TY) output tile
// with a depth-K halo in both x and y once in shared memory, in the store
// dtype, plus the depth-(K-1) mask tile that the BC lookups of the
// intermediate sweeps read. Staging runs on cp.async with every copy of
// the block in flight, in chunks of up to 16 bytes along y where Y, TY and
// K allow (a first version with plain loads, waiting on each, was up to 2x
// slower at K = 2). Sweep s (1..K) computes the depth-(K-s) region: all of
// its reads finish before a barrier, each thread holds its results (at most
// V voxels) in registers, and only then are they written back into the
// same buffer, rounded to the store dtype -- so one buffer suffices and K4
// equals K launches of K3 to store-dtype roundoff. The last sweep writes
// the tile to device memory. Device memory sees one read and one write of
// the populations per K steps; the price is the two-dimensional halo
// recompute (~41% over the 8 sweeps of the 32x48 tile at K = 8), and the
// sweeps run at the rate of the per-voxel arithmetic and shared-memory
// traffic, not of device memory. The held results limit the block to one
// per SM: 1024 threads holding 3 voxels each (64 registers; the f32
// variants spill 56-160 bytes) measured faster on an H100 than 512 threads
// holding 5, and the 32x48 and 40x40 tiles faster than 32x32 and 24x32
// (PERF.md). TMA staging, clusters and a ping-pong layout that would let
// two blocks share an SM are left to later work.
//
// The kExtHybrid form (EXT == 4: the hybrid curved wall, and the halfway,
// Zou-He and regularized BCs with the per-voxel prescriptions of the aux
// field, D2Q9 BGK) reads the aux field (nchan, X, Y) f32 from device
// memory, at the voxels of the BCs that use it: staging it in shared
// memory beside the populations, as the TPU kernel stages it in VMEM,
// would take 125 KB more at the Schafer-Turek scene's 11 channels and no
// longer fit the block's 227 KB. The hybrid epilogue is voxel-local, so
// K4 still equals K launches of K3 bit for bit.
//
// step_2d_field_kernel is K3 in xlb_tpu's field modes (kFieldAde, the
// advection-diffusion step; kFieldForce, a per-voxel force; has_field),
// unshifted, the field in aux channels [0, 2) and the BCs' after them.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "collide_stream.cuh"

namespace xlb {

constexpr int k2dStepThreads = 256;
constexpr int k2dKstepThreads = 1024;
constexpr int k2dKstepVoxels = 3;  // V: voxels a thread holds across a sweep's barrier
constexpr size_t k2dMaxSharedBytes = 232448;  // 227 KB opt-in limit per block on sm_90

// Shared-memory layout of kstep_2d_kernel: populations (9, TX+2K, TY+2K) in
// the store dtype | mask (TX+2K-2, TY+2K-2) int32. Mirrored by
// kstep_2d_smem_bytes in xlb_tpu_torch/kernels/collide_stream_2d.py.
__host__ __device__ inline size_t kstep_2d_smem_bytes(int k, int tx, int ty, size_t tsize) {
  return align16(size_t(D2Q9::q) * (tx + 2 * k) * (ty + 2 * k) * tsize) + size_t(tx + 2 * k - 2) * (ty + 2 * k - 2) * 4;
}

// One thread's voxel of step_2d_kernel and step_2d_field_kernel (FIELD:
// the field mode, whose channels the aux field holds first).
template <typename T, bool SHIFTED, int EXT, int FIELD>
__device__ __forceinline__ void step_2d_voxel(const T* __restrict__ f, const int* __restrict__ mask,
                                              T* __restrict__ out, int X, int Y, float omega, const XlbStepParams& p,
                                              const float* __restrict__ aux) {
  const unsigned n = unsigned(X) * unsigned(Y);
  const unsigned v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int y = int(v % unsigned(Y));
  const int x = int(v / unsigned(Y));
  const size_t plane = n;

  auto pull = [&](int l) {
    const int xs = wrap1(x - D2Q9::c(0, l), X);
    const int ys = wrap1(y - D2Q9::c(1, l), Y);
    return to_f32(f[l * plane + size_t(xs) * Y + ys]);
  };
  auto center = [&](int l) { return to_f32(f[l * plane + v]); };

  float o[D2Q9::q];
  if constexpr (EXT == kExtHybrid || FIELD != kFieldNone) {
    auto aux_at = [&](int ch) { return aux[ch * plane + v]; };
    collide_voxel<D2Q9, SHIFTED, EXT, CollBGK, false, FIELD>(pull, center, mask[v], omega, p, o, aux_at);
  } else {
    collide_voxel<D2Q9, SHIFTED, EXT>(pull, center, mask[v], omega, p, o);
  }
#pragma unroll
  for (int l = 0; l < D2Q9::q; ++l) out[l * plane + v] = from_f32<T>(o[l]);
}

template <typename T, bool SHIFTED, int EXT>
__global__ void __launch_bounds__(k2dStepThreads)
    step_2d_kernel(const T* __restrict__ f, const int* __restrict__ mask, T* __restrict__ out, int X, int Y,
                   float omega, const __grid_constant__ XlbStepParams p, const float* __restrict__ aux) {
  step_2d_voxel<T, SHIFTED, EXT, kFieldNone>(f, mask, out, X, Y, omega, p, aux);
}

// K3's field modes (has_field): the advection-diffusion step (kFieldAde)
// and the step with a per-voxel force (kFieldForce), unshifted, the field
// in aux channels [0, 2) and the BCs' channels after it.
template <typename T, int EXT, int FIELD>
__global__ void __launch_bounds__(k2dStepThreads)
    step_2d_field_kernel(const T* __restrict__ f, const int* __restrict__ mask, T* __restrict__ out, int X, int Y,
                         float omega, const __grid_constant__ XlbStepParams p, const float* __restrict__ aux) {
  step_2d_voxel<T, false, EXT, FIELD>(f, mask, out, X, Y, omega, p, aux);
}

// Copies rows of W elements from device memory into shared memory with
// cp.async (every copy of the block in flight at once); W elements of T
// must be 4, 8 or 16 bytes, else plain loads (bf16 with odd W).
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* src, int W) {
  const int bytes = W * int(sizeof(T));
  if (bytes >= 4) {
    __pipeline_memcpy_async(dst, src, bytes);
  } else {
    *dst = *src;
  }
}

template <typename T, bool SHIFTED, int EXT>
__global__ void __launch_bounds__(k2dKstepThreads, 1)
    kstep_2d_kernel(const T* __restrict__ f, const int* __restrict__ mask, T* __restrict__ out, int X, int Y, int TX,
                    int TY, int K, int W, float omega, const __grid_constant__ XlbStepParams p,
                    const float* __restrict__ aux) {
  constexpr int Q = D2Q9::q, THREADS = k2dKstepThreads, V = k2dKstepVoxels;
  extern __shared__ __align__(16) unsigned char smem[];
  const int EX = TX + 2 * K, EY = TY + 2 * K;      // staged populations: depth K
  const int MX = EX - 2, MY = EY - 2;              // staged mask: depth K - 1
  const int tile = EX * EY;
  T* s_f = reinterpret_cast<T*>(smem);
  int* s_m = reinterpret_cast<int*>(smem + align16(size_t(Q) * tile * sizeof(T)));
  const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
  const size_t plane = size_t(X) * Y;

  // stage the populations in chunks of W along y (W divides Y, TY and K, so
  // no chunk straddles the periodic seam) and the mask, wrapping periodically
  const int cy = EY / W, per_l = EX * cy;
  for (int i = threadIdx.x; i < Q * per_l; i += THREADS) {
    const int l = i / per_l, r = i - l * per_l, ix = r / cy, jc = r - ix * cy;
    const int gx = wrapmod(x0 - K + ix, X), gy = wrapmod(y0 - K + jc * W, Y);
    stage_chunk(s_f + l * tile + ix * EY + jc * W, f + l * plane + size_t(gx) * Y + gy, W);
  }
  for (int i = threadIdx.x; i < MX * MY; i += THREADS) {
    const int ix = i / MY, iy = i - ix * MY;
    __pipeline_memcpy_async(s_m + i, mask + size_t(wrapmod(x0 - K + 1 + ix, X)) * Y + wrapmod(y0 - K + 1 + iy, Y), 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int s = 1; s <= K; ++s) {
    // sweep s computes the depth-h region; its voxel (ix, iy) sits at
    // (ix + s, iy + s) in the staged tile and (ix + s - 1, iy + s - 1) in the mask
    const int h = K - s, ey = TY + 2 * h, vol = (TX + 2 * h) * ey;
    T res[V][Q];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i >= vol) continue;
      const int ix = i / ey, iy = i - ix * ey;
      const int b = (ix + s) * EY + iy + s;
      auto pull = [&](int l) { return to_f32(s_f[l * tile + b - D2Q9::c(0, l) * EY - D2Q9::c(1, l)]); };
      auto center = [&](int l) { return to_f32(s_f[l * tile + b]); };
      float o[Q];
      const int packed = s_m[(ix + s - 1) * MY + iy + s - 1];
      if constexpr (EXT == kExtHybrid) {
        // the aux field from device memory (read at the voxels of the BCs that use it)
        auto aux_at = [&](int ch) {
          return aux[ch * plane + size_t(wrapmod(x0 - h + ix, X)) * Y + wrapmod(y0 - h + iy, Y)];
        };
        collide_voxel<D2Q9, SHIFTED, EXT>(pull, center, packed, omega, p, o, aux_at);
      } else {
        collide_voxel<D2Q9, SHIFTED, EXT>(pull, center, packed, omega, p, o);
      }
      if (s < K) {
#pragma unroll
        for (int l = 0; l < Q; ++l) res[j][l] = from_f32<T>(o[l]);  // store-dtype rounding
      } else if (x0 + ix < X && y0 + iy < Y) {
        const size_t g = size_t(x0 + ix) * Y + y0 + iy;
#pragma unroll
        for (int l = 0; l < Q; ++l) out[l * plane + g] = from_f32<T>(o[l]);
      }
    }
    if (s == K) break;
    __syncthreads();  // every read of sweep s is done
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i >= vol) continue;
      const int ix = i / ey, iy = i - ix * ey;
      const int b = (ix + s) * EY + iy + s;
#pragma unroll
      for (int l = 0; l < Q; ++l) s_f[l * tile + b] = res[j][l];
    }
    __syncthreads();
  }
}

template <typename T, bool SHIFTED, int EXT>
cudaError_t launch_step_2d(const void* f, const void* mask, void* out, int X, int Y, float omega,
                           const XlbStepParams& p, const float* aux, cudaStream_t stream) {
  const unsigned n = unsigned(X) * unsigned(Y);
  const unsigned blocks = (n + k2dStepThreads - 1) / k2dStepThreads;
  step_2d_kernel<T, SHIFTED, EXT><<<blocks, k2dStepThreads, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const int*>(mask), static_cast<T*>(out), X, Y, omega, p, aux);
  return cudaGetLastError();
}

template <typename T, bool SHIFTED, int EXT>
cudaError_t launch_kstep_2d(const void* f, const void* mask, void* out, int X, int Y, int TX, int TY, int K,
                            float omega, const XlbStepParams& p, const float* aux, cudaStream_t stream) {
  if ((TX + 2 * K - 2) * (TY + 2 * K - 2) > k2dKstepVoxels * k2dKstepThreads) return cudaErrorInvalidValue;
  const size_t smem = kstep_2d_smem_bytes(K, TX, TY, sizeof(T));
  if (smem > k2dMaxSharedBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kstep_2d_kernel<T, SHIFTED, EXT>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  // largest chunk of whole elements, at most 16 bytes, that divides Y, TY and K
  int W = 16 / int(sizeof(T));
  while (W > 1 && (Y % W || TY % W || K % W || reinterpret_cast<uintptr_t>(f) % (W * sizeof(T)))) W /= 2;
  const dim3 grid((Y + TY - 1) / TY, (X + TX - 1) / TX);
  kstep_2d_kernel<T, SHIFTED, EXT><<<grid, k2dKstepThreads, smem, stream>>>(
      static_cast<const T*>(f), static_cast<const int*>(mask), static_cast<T*>(out), X, Y, TX, TY, K, W, omega, p,
      aux);
  return cudaGetLastError();
}

// Calls fn(T{}, shifted tag, ext tag) with the compile-time variant the
// runtime codes select: ext kExtNone, kExtAll or kExtHybrid.
template <typename F>
cudaError_t dispatch_2d(int store_kind, int shifted, int ext, const F& fn) {
  auto by_ext = [&](auto t, auto sh) -> cudaError_t {
    if (ext == kExtHybrid) return fn(t, sh, std::integral_constant<int, kExtHybrid>{});
    if (ext == kExtAll) return fn(t, sh, std::integral_constant<int, kExtAll>{});
    if (ext == kExtNone) return fn(t, sh, std::integral_constant<int, kExtNone>{});
    return cudaErrorInvalidValue;
  };
  auto by_shift = [&](auto t) -> cudaError_t {
    return shifted ? by_ext(t, std::true_type{}) : by_ext(t, std::false_type{});
  };
  if (store_kind == 0) return by_shift(float{});
  if (store_kind == 1) return by_shift(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

template <typename T, int EXT, int FIELD>
cudaError_t launch_step_2d_field(const void* f, const void* mask, void* out, int X, int Y, float omega,
                                 const XlbStepParams& p, const float* aux, cudaStream_t stream) {
  if constexpr (has_field(FIELD, D2Q9::q, XLB_COLL_BGK, EXT)) {
    const unsigned n = unsigned(X) * unsigned(Y);
    step_2d_field_kernel<T, EXT, FIELD><<<(n + k2dStepThreads - 1) / k2dStepThreads, k2dStepThreads, 0, stream>>>(
        static_cast<const T*>(f), static_cast<const int*>(mask), static_cast<T*>(out), X, Y, omega, p, aux);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace xlb

extern "C" {

// store_kind: 0 = float32, 1 = bfloat16; ext: 0 (kExtNone), 1 (kExtAll: a
// halfway, zouhe or regularized BC with constant prescriptions) or 4
// (kExtHybrid: a hybrid BC or a per-voxel prescription); aux: the
// (nchan, X, Y) float32 aux field of kExtHybrid, or null. Returns the
// cudaError_t of the launch.
int xlb_collide_stream_2d_step(int store_kind, int shifted, int ext, const void* f, const void* mask, void* out, int X,
                               int Y, float omega, const void* aux, const XlbStepParams* params, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const XlbStepParams& p = *params;
  const float* a = static_cast<const float*>(aux);
  return xlb::dispatch_2d(store_kind, shifted, ext, [&](auto t, auto sh, auto ex) {
    return xlb::launch_step_2d<decltype(t), decltype(sh)::value, decltype(ex)::value>(f, mask, out, X, Y, omega, p, a,
                                                                                        s);
  });
}

int xlb_collide_stream_2d_kstep(int store_kind, int shifted, int ext, int steps, const void* f, const void* mask,
                                void* out, int X, int Y, int TX, int TY, float omega, const void* aux,
                                const XlbStepParams* params, void* stream) {
  if (steps < 2 || steps > 8 || TX < 1 || TY < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const XlbStepParams& p = *params;
  const float* a = static_cast<const float*>(aux);
  return xlb::dispatch_2d(store_kind, shifted, ext, [&](auto t, auto sh, auto ex) {
    return xlb::launch_kstep_2d<decltype(t), decltype(sh)::value, decltype(ex)::value>(f, mask, out, X, Y, TX, TY,
                                                                                         steps, omega, p, a, s);
  });
}

// K3's field modes: field 1 (the advection-diffusion step) or 2 (a
// per-voxel force), ext kExtAll (1) or kExtHybrid (4) as has_field allows,
// unshifted; aux holds the field's two channels, then the BCs'.
int xlb_collide_stream_2d_field_step(int field, int store_kind, int ext, const void* f, const void* mask, void* out,
                                     int X, int Y, float omega, const void* aux, const XlbStepParams* params,
                                     void* stream) {
  if (aux == nullptr || !xlb::has_field(field, 9, XLB_COLL_BGK, ext)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const XlbStepParams& p = *params;
  const float* a = static_cast<const float*>(aux);
  return xlb::dispatch_2d(store_kind, 0, ext, [&](auto t, auto, auto ex) {
    constexpr int e = decltype(ex)::value;
    using T = decltype(t);
    return field == xlb::kFieldAde ? xlb::launch_step_2d_field<T, e, xlb::kFieldAde>(f, mask, out, X, Y, omega, p, a, s)
                                   : xlb::launch_step_2d_field<T, e, xlb::kFieldForce>(f, mask, out, X, Y, omega, p, a, s);
  });
}

}  // extern "C"
