// The fused 3D collide-stream kernels for Hopper (sm_90a), as templates
// over the stencil S (D3Q19, D3Q27), the collision C, the store dtype T,
// shifted storage, the EXT switch (kExtNone, or kExtHalfway: the halfway
// epilogue) and FORCE (the exact-difference body force). Instantiated per
// (stencil, collision) pair by XLB_INSTANTIATE_PAIR in the collide_stream*.cu
// sources, one pair per source so that the build compiles them in
// parallel; the C launchers of collide_stream.cu dispatch to them.
//
// Layout: populations (q, X, Y, Z) in the store dtype (f32 or bf16), z
// contiguous; the packed int32 mask (X, Y, Z) of
// xlb_tpu_torch/kernels/fused_step.py::pack_masks.
//
// step_kernel (K1) replaces the TPU kernel
// xlb_tpu/kernels/collide_stream_dma.py::build_fused_collide_stream_3d_dma
// (plain mode, with and without shifted storage). One thread per voxel,
// threads along z, so each of the q pull loads of a warp is coalesced;
// pull sources wrap periodically. BGK and the cheap collisions are bound
// by device-memory bytes: per voxel per step 2q population accesses and
// the 4-byte mask (D3Q19: 156 B in f32, 80 B in bf16; D3Q27: 220 / 112 B);
// MRT and KBC do several hundred to a few thousand float32 operations per
// voxel and may be bound by them. This first version leaves the reuse of
// the neighbours' loads to L1 and L2.
//
// kstep_kernel (K2) replaces
// xlb_tpu/kernels/collide_stream_2step.py::build_fused_collide_stream_3d_kstep
// (plain mode, k >= 2). A block owns a (TX, TY, TZ) output tile and runs k
// sweeps on regions that shrink by one voxel per side. The first sweep
// computes the depth-(k-1) region around the tile, pulling straight from
// device memory like step_kernel (L1/L2 serve the overlap between blocks);
// every later sweep pulls from the previous one in shared memory, where
// each intermediate is rounded to the store dtype -- so k-step equals k
// single steps to store-dtype roundoff while device memory sees one read
// and one write of the populations per k steps. The sweep regions are whole
// boxes, so D3Q27's corner pulls find their sources. A first version also
// staged the depth-k input halo in shared memory, as the TPU kernel does in
// VMEM: with one 217 KB block per SM its load loop was latency and
// index-arithmetic bound, 15-30x slower than two single steps on an H100,
// so the input now goes through the caches. Only the sweep buffers live in
// shared memory; the wrapper sizes the tile so that two 256-thread blocks
// fit on an SM (D3Q19 bf16 4x8x32 at k=2: 78 KB; f32 4x4x32: 93 KB).
//
// blocked_kernel (K0, collide_stream_blocked.cuh) is the third kernel of
// the family, adjoint_kernel (K8, adjoint_step.cuh) the fourth.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "collide_stream.cuh"

namespace xlb {

constexpr int kStepThreads = 256;
constexpr int kKstepThreads = 256;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB opt-in limit per block on sm_90

enum : int { XLB_KERNEL_STEP = 1, XLB_KERNEL_KSTEP = 2, XLB_KERNEL_BLOCKED = 3, XLB_KERNEL_ADJOINT = 4 };

__host__ __device__ inline size_t halo_volume(int h, int tx, int ty, int tz) {
  return size_t(tx + 2 * h) * size_t(ty + 2 * h) * size_t(tz + 2 * h);
}

// Shared-memory layout of kstep_kernel: sweep buffer A (depth K-1) | sweep
// buffer B (depth K-2, only for K > 2). Mirrored by kstep_smem_bytes in
// collide_stream_2step.py.
template <class S>
__host__ __device__ inline size_t kstep_smem_bytes(int k, int tx, int ty, int tz, size_t tsize) {
  size_t b = align16(S::q * halo_volume(k - 1, tx, ty, tz) * tsize);
  if (k > 2) b += align16(S::q * halo_volume(k - 2, tx, ty, tz) * tsize);
  return b;
}

template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE>
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
    const int xs = wrap1(x - S::c(0, l), X);
    const int ys = wrap1(y - S::c(1, l), Y);
    const int zs = wrap1(z - S::c(2, l), Z);
    return to_f32(f[l * plane + (size_t(xs) * Y + ys) * Z + zs]);
  };
  auto center = [&](int l) { return to_f32(f[l * plane + v]); };

  float o[S::q];
  collide_voxel<S, SHIFTED, EXT, C, FORCE>(pull, center, mask[v], omega, p, o);
#pragma unroll
  for (int l = 0; l < S::q; ++l) out[l * plane + v] = from_f32<T>(o[l]);
}

template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE>
__global__ void __launch_bounds__(kKstepThreads)
    kstep_kernel(const T* __restrict__ f, const int* __restrict__ mask, T* __restrict__ out, int X, int Y, int Z,
                 int TX, int TY, int TZ, int K, float omega, const __grid_constant__ XlbStepParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t plane = size_t(X) * Y * Z;
  const int x0 = blockIdx.z * TX, y0 = blockIdx.y * TY, z0 = blockIdx.x * TZ;
  T* s_a = reinterpret_cast<T*>(smem);
  T* s_b = reinterpret_cast<T*>(smem + align16(S::q * halo_volume(K - 1, TX, TY, TZ) * sizeof(T)));

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

      float o[S::q];
      if (s == 1) {
        // first sweep: pull from device memory through L1/L2
        auto pull = [&](int l) {
          const int xs = wrap1(gx - S::c(0, l), X);
          const int ys = wrap1(gy - S::c(1, l), Y);
          const int zs = wrap1(gz - S::c(2, l), Z);
          return to_f32(f[l * plane + (size_t(xs) * Y + ys) * Z + zs]);
        };
        auto center = [&](int l) { return to_f32(f[l * plane + g]); };
        collide_voxel<S, SHIFTED, EXT, C, FORCE>(pull, center, packed, omega, p, o);
      } else {
        // region-local index in the source: dst index + 1 - c_l
        auto pull = [&](int l) {
          return to_f32(src[l * svol + ((ix + 1 - S::c(0, l)) * sy + (iy + 1 - S::c(1, l))) * sz +
                            (iz + 1 - S::c(2, l))]);
        };
        auto center = [&](int l) { return to_f32(src[l * svol + ((ix + 1) * sy + (iy + 1)) * sz + (iz + 1)]); };
        collide_voxel<S, SHIFTED, EXT, C, FORCE>(pull, center, packed, omega, p, o);
      }
      if (s < K) {
#pragma unroll
        for (int l = 0; l < S::q; ++l) dst[l * vol + i] = from_f32<T>(o[l]);  // store-dtype rounding
      } else if (x0 + ix < X && y0 + iy < Y && z0 + iz < Z) {
#pragma unroll
        for (int l = 0; l < S::q; ++l) out[l * plane + g] = from_f32<T>(o[l]);
      }
    }
    __syncthreads();
  }
}

// The arguments of one launch of the family.
struct XlbLaunch {
  int kernel;  // XLB_KERNEL_*
  int store_kind;  // 0 = float32, 1 = bfloat16
  int shifted;
  const void* f;
  const void* mask;
  void* out;
  int X, Y, Z;
  int TX, TY, TZ;  // k-step and blocked tiles
  int K;           // k-step: steps per pass
  float omega;
  const XlbStepParams* p;
  cudaStream_t stream;
  const void* g;  // adjoint: the cotangent (f32, like f); out is df
  void* dom;      // adjoint: the per-voxel omega cotangent
};

}  // namespace xlb

#include "adjoint_step.cuh"
#include "collide_stream_blocked.cuh"

namespace xlb {

// The instantiation table: which (kernel, walled, store, shifted) every
// (stencil, collision) pair is built for: f32 plain storage and bf16
// deviation form (the windows) for all four kernels, bf16 plain storage
// for the single steps and the adjoint (stepper(...) under FP32BF16), each
// unwalled and walled (halfway epilogue and body force).
constexpr bool has_form(int kernel, int walled, int store_kind, int shifted) {
  if (kernel < XLB_KERNEL_STEP || kernel > XLB_KERNEL_ADJOINT || walled < 0 || walled > 1) return false;
  if (store_kind == 0) return !shifted;
  if (store_kind == 1) return shifted || kernel != XLB_KERNEL_KSTEP;
  return false;
}

template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE>
cudaError_t launch_kernel(const XlbLaunch& a) {
  constexpr int store = std::is_same<T, float>::value ? 0 : 1;
  const T* f = static_cast<const T*>(a.f);
  const int* mask = static_cast<const int*>(a.mask);
  T* out = static_cast<T*>(a.out);
  const XlbStepParams& p = *a.p;
  if (a.kernel == XLB_KERNEL_STEP) {
    if constexpr (has_form(XLB_KERNEL_STEP, FORCE, store, SHIFTED)) {
      const unsigned n = unsigned(a.X) * unsigned(a.Y) * unsigned(a.Z);
      step_kernel<S, C, T, SHIFTED, EXT, FORCE><<<(n + kStepThreads - 1) / kStepThreads, kStepThreads, 0, a.stream>>>(
          f, mask, out, a.X, a.Y, a.Z, a.omega, p);
      return cudaGetLastError();
    }
  } else if (a.kernel == XLB_KERNEL_KSTEP) {
    if constexpr (has_form(XLB_KERNEL_KSTEP, FORCE, store, SHIFTED)) {
      if (a.K < 2 || a.TX < 1 || a.TY < 1 || a.TZ < 1) return cudaErrorInvalidValue;
      const size_t smem = kstep_smem_bytes<S>(a.K, a.TX, a.TY, a.TZ, sizeof(T));
      if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(kstep_kernel<S, C, T, SHIFTED, EXT, FORCE>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (e != cudaSuccess) return e;
      }
      const dim3 grid((a.Z + a.TZ - 1) / a.TZ, (a.Y + a.TY - 1) / a.TY, (a.X + a.TX - 1) / a.TX);
      kstep_kernel<S, C, T, SHIFTED, EXT, FORCE><<<grid, kKstepThreads, smem, a.stream>>>(
          f, mask, out, a.X, a.Y, a.Z, a.TX, a.TY, a.TZ, a.K, a.omega, p);
      return cudaGetLastError();
    }
  } else if (a.kernel == XLB_KERNEL_BLOCKED) {
    if constexpr (has_form(XLB_KERNEL_BLOCKED, FORCE, store, SHIFTED)) {
      const int threads = a.TX * a.TY * a.TZ;
      if (a.TX < 1 || a.TY < 1 || a.TZ < 1 || threads > kBlockedThreads) return cudaErrorInvalidValue;
      const dim3 grid((a.Z + a.TZ - 1) / a.TZ, (a.Y + a.TY - 1) / a.TY, (a.X + a.TX - 1) / a.TX);
      blocked_kernel<S, C, T, SHIFTED, EXT, FORCE>
          <<<grid, threads, 0, a.stream>>>(f, mask, out, a.X, a.Y, a.Z, a.TX, a.TY, a.TZ, a.omega, p);
      return cudaGetLastError();
    }
  } else if (a.kernel == XLB_KERNEL_ADJOINT) {
    if constexpr (has_form(XLB_KERNEL_ADJOINT, FORCE, store, SHIFTED)) {
      const unsigned n = unsigned(a.X) * unsigned(a.Y) * unsigned(a.Z);
      const unsigned blocks = (n + kAdjointThreads - 1) / kAdjointThreads;
      const float* g = static_cast<const float*>(a.g);
      float* df = static_cast<float*>(a.out);
      adjoint_kernel<S, C, T, SHIFTED, EXT, FORCE><<<blocks, kAdjointThreads, 0, a.stream>>>(
          f, g, mask, df, static_cast<float*>(a.dom), a.X, a.Y, a.Z, a.omega, p);
      if constexpr (EXT != kExtNone) {
        bool halfway = false;
        for (int b = 0; b < p.n_bc; ++b) halfway = halfway || p.bc_kind[b] == XLB_BC_HALFWAY;
        if (halfway) {
          const cudaError_t e = cudaGetLastError();
          if (e != cudaSuccess) return e;
          adjoint_halfway_kernel<S, C, T, SHIFTED, FORCE><<<blocks, kAdjointThreads, 0, a.stream>>>(
              f, g, mask, df, a.X, a.Y, a.Z, a.omega, p);
        }
      }
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;  // outside the table
}

template <class S, class C, typename T, bool SHIFTED>
cudaError_t launch_walled(const XlbLaunch& a) {
  if (a.p->walled) return launch_kernel<S, C, T, SHIFTED, kExtHalfway, true>(a);
  return launch_kernel<S, C, T, SHIFTED, kExtNone, false>(a);
}

// Launch a kernel of the pair (S, C), or return cudaErrorInvalidValue for
// a configuration outside the table.
template <class S, class C>
cudaError_t launch_pair_impl(const XlbLaunch& a) {
  if (!has_form(a.kernel, a.p->walled, a.store_kind, a.shifted)) return cudaErrorInvalidValue;
  if (a.store_kind == 0)
    return a.shifted ? launch_walled<S, C, float, true>(a) : launch_walled<S, C, float, false>(a);
  return a.shifted ? launch_walled<S, C, __nv_bfloat16, true>(a) : launch_walled<S, C, __nv_bfloat16, false>(a);
}

template <class S, class C>
cudaError_t launch_pair(const XlbLaunch& a);

#define XLB_INSTANTIATE_PAIR(S, C) \
  template <>                      \
  cudaError_t launch_pair<S, C>(const XlbLaunch& a) { return launch_pair_impl<S, C>(a); }

}  // namespace xlb
