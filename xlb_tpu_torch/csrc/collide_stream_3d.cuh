// The fused 3D collide-stream kernels for Hopper (sm_90a), as templates
// over the stencil S (D3Q19, D3Q27), the collision C, the store dtype T,
// shifted storage, the EXT switch (kExtNone; kExtHalfway: the halfway
// epilogue; kExtOpen: every epilogue of the open-boundary scenes, with the
// aux field and the outflow's staging) and FORCE (the exact-difference
// body force). Instantiated per
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
// (plain mode, k >= 2): k steps per pass over device memory, each
// intermediate rounded to the store dtype, so K2 equals k K1 launches bit
// for bit. Its byte bound is one K1 step's: per k steps one read and one
// write of the populations and the mask (D3Q19 156 B per voxel in f32, 80
// B in bf16); every recomputed halo voxel costs a collide and q pulls
// through L1/L2 on top. The first design gave each block a 3D box and swept
// it k times: the depth-1 halo of a 4x4x32 box made the first sweep 2.4
// times the box's voxels, so K2 cost 2.2 single steps (a copy of the input
// halo into shared memory, as the TPU kernel stages it in VMEM, was 15-30x
// slower still: its load loop was latency bound). Now a block owns a
// (TY, TZ) column of the y-z plane, z contiguous so a warp's pulls
// coalesce, and marches along x over a segment of `seg` planes. At each
// march step sweep s (1..k) computes one y-z plane of its depth-(k-s)
// region, (TY + 2(k-s)) x (TZ + 2(k-s)) voxels; sweeps 1..k-1 keep a ring
// of three planes of their results in shared memory, where sweep s + 1
// finds its x - 1, x and x + 1 sources (the outflow staging's x - t, |t_a|
// <= 1, too). Sweep 1 pulls from device memory through L1/L2, each
// population of an input plane once per block, when sweep 1 reaches the
// plane it streams into. The halo then costs (TY + 2)(TZ + 2) / (TY TZ) in
// collides and L1/L2 reads (1.42 at 6x32, 1.33 at 8x32), not the box's
// 2.0-2.4, and k - 1 recomputed planes at each end of a segment are the
// only x halo. Sweep s runs two march steps behind sweep s - 1 with a
// __syncthreads after every sweep (march_schedule in
// kernels/collide_stream_2step.py models it, and a CPU test holds every
// ring read to it; a four-plane ring with one __syncthreads per step ran
// slower). On the H100 it runs at 0.5 of its byte bound at best: what
// moved it in kstep_sweep.py was resident warps (most forms compiled for
// two blocks per SM, the column per form from the sweep's table), cheap
// index arithmetic and short segments (at most 32 planes: more blocks in
// more waves; marches of 128-256 planes ran 15-44% slower). Periodic wrap
// in x, y and z as the single step's; the stores of the last sweep alone
// are masked, at the ragged y and z edges.
//
// With kExtOpen and kExtHybrid (kExtOpen's epilogues and the hybrid
// curved wall, whose wall-distance weights ride the aux field too) a
// kernel also takes the aux field (nchan, X, Y, Z) f32 of the BCs'
// per-voxel prescriptions, read only at the voxels of those BCs,
// and the outflow's staging reads one more population per staged slot at
// x - t (|t_a| <= 1): step_kernel from device memory, kstep_kernel's first
// sweep too and its later sweeps from the previous sweep's ring in shared
// memory (planes x - 1 .. x + 1, region-local y and z index + 1 - t; the
// source region's depth h + 1 covers it),
// blocked_kernel from device memory (its staged boxes hold only the pull
// sources). The hybrid epilogue is voxel-local (its pre-streaming
// populations are the centre reads, in K2's later sweeps the previous
// sweep's ring centre, rounded to the store dtype). So K2 still equals k
// K1 launches, and K0 K1, bit for bit.
//
// field_step_kernel is K1 in xlb_tpu's field modes (FIELD: kFieldAde, the
// advection-diffusion step; kFieldForce, a per-voxel force), unshifted, the
// field in the aux field's first d channels; step_kernel and it share
// step_voxel. Their instantiations (has_field) live in
// collide_stream_*_field.cu.
//
// blocked_kernel (K0, collide_stream_blocked.cuh) is the third kernel of
// the family, the adjoint K8 (adjoint_step.cuh: adjoint_kernel, with
// adjoint_centred_kernel's boundary and centred phases and
// adjoint_staging_kernel where the scene needs them) the fourth.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <type_traits>

#include "collide_stream.cuh"

namespace xlb {

constexpr int kStepThreads = 256;
constexpr int kKstepThreads = 256;
constexpr int kKstepRing = 3;  // planes of each sweep's ring in shared memory
// Resident k-step blocks per SM each form is compiled for (kstep_sweep.py).
// Two, at most 128 registers: the D3Q19 open and curved-wall forms would
// take 166-235 and one block per SM, the D3Q27 KBC one 145; capped, with
// spills of 0-136 B, they ran faster. One for D3Q27's walled, open and
// curved-wall forms: at 128 registers they spill 256-1324 B, and at
// 197-255 registers and one block per SM they ran 21-31% faster.
__host__ __device__ constexpr int kstep_min_blocks(int q, int ext) { return q == 27 && ext != kExtNone ? 1 : 2; }
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB opt-in limit per block on sm_90

enum : int { XLB_KERNEL_STEP = 1, XLB_KERNEL_KSTEP = 2, XLB_KERNEL_BLOCKED = 3, XLB_KERNEL_ADJOINT = 4 };

// Shared-memory layout of kstep_kernel: for each sweep s = 1 .. k-1 a ring
// of kKstepRing planes of its depth-(k-s) region, each plane q populations
// of (TY + 2(k-s)) x (TZ + 2(k-s)) voxels in the store dtype
// ([slot][l][y][z]). Mirrored by kstep_smem_bytes in collide_stream_2step.py.
template <class S>
__host__ __device__ inline size_t kstep_ring_bytes(int h, int ty, int tz, size_t tsize) {
  return align16(size_t(kKstepRing) * S::q * size_t(ty + 2 * h) * size_t(tz + 2 * h) * tsize);
}

template <class S>
__host__ __device__ inline size_t kstep_smem_bytes(int k, int ty, int tz, size_t tsize) {
  size_t b = 0;
  for (int s = 1; s < k; ++s) b += kstep_ring_bytes<S>(k - s, ty, tz, tsize);
  return b;
}

// i wrapped into [0, n): wrap1's two compares while i stays within a period
// of the domain, as it does unless a column and its halo span the domain.
__device__ __forceinline__ int wrap_near(int i, int n) { return i >= -n && i < 2 * n ? wrap1(i, n) : wrapmod(i, n); }

// One thread's voxel of step_kernel and field_step_kernel (FIELD: the
// field mode, whose channels the aux field holds first).
template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE, int FIELD>
__device__ __forceinline__ void step_voxel(const T* __restrict__ f, const int* __restrict__ mask, T* __restrict__ out,
                                           int X, int Y, int Z, float omega, const XlbStepParams& p,
                                           const float* __restrict__ aux) {
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
  if constexpr (ext_reads_aux(EXT) || FIELD != kFieldNone) {
    auto aux_at = [&](int ch) { return aux[ch * plane + v]; };
    auto staged = [&](int m, int tx, int ty, int tz) {
      return to_f32(f[m * plane + (size_t(wrap1(x - tx, X)) * Y + wrap1(y - ty, Y)) * Z + wrap1(z - tz, Z)]);
    };
    collide_voxel<S, SHIFTED, EXT, C, FORCE, FIELD>(pull, center, mask[v], omega, p, o, aux_at, staged);
  } else {
    collide_voxel<S, SHIFTED, EXT, C, FORCE>(pull, center, mask[v], omega, p, o);
  }
#pragma unroll
  for (int l = 0; l < S::q; ++l) out[l * plane + v] = from_f32<T>(o[l]);
}

template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE>
__global__ void __launch_bounds__(kStepThreads)
    step_kernel(const T* __restrict__ f, const int* __restrict__ mask, T* __restrict__ out, int X, int Y, int Z,
                float omega, const __grid_constant__ XlbStepParams p, const float* __restrict__ aux) {
  step_voxel<S, C, T, SHIFTED, EXT, FORCE, kFieldNone>(f, mask, out, X, Y, Z, omega, p, aux);
}

// K1's field modes (has_field): the advection-diffusion step (kFieldAde)
// and the step with a per-voxel force (kFieldForce), unshifted, the field
// in aux channels [0, d) and the BCs' channels after it.
template <class S, class C, typename T, int EXT, int FIELD>
__global__ void __launch_bounds__(kStepThreads)
    field_step_kernel(const T* __restrict__ f, const int* __restrict__ mask, T* __restrict__ out, int X, int Y, int Z,
                      float omega, const __grid_constant__ XlbStepParams p, const float* __restrict__ aux) {
  step_voxel<S, C, T, false, EXT, false, FIELD>(f, mask, out, X, Y, Z, omega, p, aux);
}

template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE>
__global__ void __launch_bounds__(kKstepThreads, kstep_min_blocks(S::q, EXT))
    kstep_kernel(const T* __restrict__ f, const int* __restrict__ mask, T* __restrict__ out, int X, int Y, int Z,
                 int seg, int TY, int TZ, int K, float omega, const __grid_constant__ XlbStepParams p,
                 const float* __restrict__ aux) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t plane = size_t(X) * Y * Z;
  const int y0 = blockIdx.y * TY, z0 = blockIdx.x * TZ;
  const int xa = blockIdx.z * seg, len = min(seg, X - xa);

  // The block's threads over one plane of a depth-h region: visit(iy, iz,
  // v, gy, gz) per voxel, (iy, iz) region-local, v its index in the ring
  // plane, (gy, gz) in the domain.
  auto region = [&](int h, auto&& visit) {
    const int ez = TZ + 2 * h, vol = (TY + 2 * h) * ez;
    const int step_y = kKstepThreads / ez, step_z = kKstepThreads % ez;
    int iy = int(threadIdx.x) / ez, iz = int(threadIdx.x) % ez;
    for (int v = threadIdx.x; v < vol; v += kKstepThreads) {
      visit(iy, iz, v, wrap_near(y0 - h + iy, Y), wrap_near(z0 - h + iz, Z));
      iy += step_y;
      iz += step_z;
      if (iz >= ez) iz -= ez, ++iy;
    }
  };

  // Sweep s runs two march steps behind sweep s - 1: at step t it computes
  // its plane index i = t - 2(s - 1), plane x_a - (k - s) + i, into slot
  // i % 3 of its ring; a __syncthreads follows every sweep, so sweep s + 1
  // finds this step's plane and the next step overwrites only the plane
  // sweep s + 1 has read.
  for (int t = 0; t < len + 2 * (K - 1); ++t) {
    {  // sweep 1 pulls from device memory through L1/L2
      const int h = K - 1, vol = (TY + 2 * h) * (TZ + 2 * h);
      const int gx = wrap_near(xa - h + t, X);
      T* d = reinterpret_cast<T*>(smem) + size_t(t % kKstepRing) * S::q * vol;
      region(h, [&](int, int, int v, int gy, int gz) {
        const size_t g = (size_t(gx) * Y + gy) * Z + gz;
        auto pull = [&](int l) {
          const int xs = wrap1(gx - S::c(0, l), X);
          const int ys = wrap1(gy - S::c(1, l), Y);
          const int zs = wrap1(gz - S::c(2, l), Z);
          return to_f32(f[l * plane + (size_t(xs) * Y + ys) * Z + zs]);
        };
        auto center = [&](int l) { return to_f32(f[l * plane + g]); };
        float o[S::q];
        if constexpr (ext_reads_aux(EXT)) {
          auto aux_at = [&](int ch) { return aux[ch * plane + g]; };  // at the voxels of the BCs that read it
          auto staged = [&](int m, int tx, int ty, int tz) {
            const size_t gs = (size_t(wrap1(gx - tx, X)) * Y + wrap1(gy - ty, Y)) * Z + wrap1(gz - tz, Z);
            return to_f32(f[m * plane + gs]);
          };
          collide_voxel<S, SHIFTED, EXT, C, FORCE>(pull, center, mask[g], omega, p, o, aux_at, staged);
        } else {
          collide_voxel<S, SHIFTED, EXT, C, FORCE>(pull, center, mask[g], omega, p, o);
        }
#pragma unroll
        for (int l = 0; l < S::q; ++l) d[l * vol + v] = from_f32<T>(o[l]);  // store-dtype rounding
      });
    }
    __syncthreads();

    // sweeps 2 .. k pull from the previous sweep's ring: planes x - 1, x,
    // x + 1 are its indices i, i + 1, i + 2, region-local y and z + 1 - c_l
    const T* src = reinterpret_cast<const T*>(smem);
    for (int s = 2; s <= K && t >= 2 * (s - 1); ++s) {
      const int h = K - s, i = t - 2 * (s - 1);
      const int vol = (TY + 2 * h) * (TZ + 2 * h), sz = TZ + 2 * h + 2, svol = (TY + 2 * h + 2) * sz;
      const int gx = wrap_near(xa - h + i, X);
      const T* sm = src + size_t(i % kKstepRing) * S::q * svol;
      const T* s0 = src + size_t((i + 1) % kKstepRing) * S::q * svol;
      const T* sp = src + size_t((i + 2) % kKstepRing) * S::q * svol;
      T* dst = const_cast<T*>(src) + kstep_ring_bytes<S>(h + 1, TY, TZ, sizeof(T)) / sizeof(T);
      T* d = dst + size_t(i % kKstepRing) * S::q * vol;
      region(h, [&](int iy, int iz, int v, int gy, int gz) {
        const size_t g = (size_t(gx) * Y + gy) * Z + gz;
        auto at = [&](const T* pl, int l, int dy, int dz) {
          return to_f32(pl[l * svol + (iy + 1 - dy) * sz + (iz + 1 - dz)]);
        };
        auto pull = [&](int l) {
          const int cx = S::c(0, l);
          return at(cx == 1 ? sm : (cx == 0 ? s0 : sp), l, S::c(1, l), S::c(2, l));
        };
        auto center = [&](int l) { return at(s0, l, 0, 0); };
        float o[S::q];
        if constexpr (ext_reads_aux(EXT)) {
          auto aux_at = [&](int ch) { return aux[ch * plane + g]; };
          auto staged = [&](int m, int tx, int ty, int tz) {
            return at(tx == 1 ? sm : (tx == 0 ? s0 : sp), m, ty, tz);
          };
          collide_voxel<S, SHIFTED, EXT, C, FORCE>(pull, center, mask[g], omega, p, o, aux_at, staged);
        } else {
          collide_voxel<S, SHIFTED, EXT, C, FORCE>(pull, center, mask[g], omega, p, o);
        }
        if (s < K) {
#pragma unroll
          for (int l = 0; l < S::q; ++l) d[l * vol + v] = from_f32<T>(o[l]);
        } else if (y0 + iy < Y && z0 + iz < Z) {
#pragma unroll
          for (int l = 0; l < S::q; ++l) out[l * plane + g] = from_f32<T>(o[l]);  // the stores of the last sweep
        }
      });
      __syncthreads();
      src = dst;
    }
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
  int TX, TY, TZ;  // blocked: its box; k-step: TY, TZ its column (TX unused)
  int K;           // k-step: steps per pass
  float omega;
  const XlbStepParams* p;
  cudaStream_t stream;
  const void* g;  // adjoint: the cotangent (f32, like f); out is df
  void* dom;      // adjoint: the per-voxel omega cotangent
  const float* aux;  // kExtOpen, kExtHybrid: the BCs' per-voxel prescriptions (nchan, X, Y, Z), or null;
                     // a field mode: its field's channels first
  int field;         // the field mode (kFieldAde, kFieldForce) of field_step_kernel, or kFieldNone
  int seg;           // k-step: planes of x per segment
  int* shape;        // when set, no launch: k-step: shape[0..2] := resident blocks per SM, registers, local bytes;
                     // adjoint: those of each of its kAdjointLaunches kernels (adjoint_launch_shape)
};

// shape[0..2] := kernel's resident blocks per SM at `threads` threads and
// `smem` dynamic shared bytes, its registers and local bytes per thread.
template <typename Kernel>
cudaError_t kernel_shape(Kernel kernel, int threads, size_t smem, int* shape) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  shape[1] = attr.numRegs;
  shape[2] = int(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&shape[0], kernel, threads, smem);
}

}  // namespace xlb

#include "adjoint_step.cuh"
#include "collide_stream_blocked.cuh"

namespace xlb {

// The instantiation table: which (kernel, walled, store, shifted) every
// (stencil, collision) pair is built for: f32 plain storage and bf16
// deviation form (the windows) for all four kernels, bf16 plain storage
// for the single steps and the adjoint (stepper(...) under FP32BF16), each
// unwalled and walled (halfway epilogue and body force); and for the pairs
// of has_open, all four kernels with kExtOpen (walled == 2: every
// open-boundary epilogue, the halfway walls and the body force) and with
// kExtHybrid (walled == 3: those and the hybrid curved wall).
constexpr bool has_form(int kernel, int walled, int store_kind, int shifted) {
  if (kernel < XLB_KERNEL_STEP || kernel > XLB_KERNEL_ADJOINT || walled < 0 || walled > 3) return false;
  if (store_kind == 0) return !shifted;
  if (store_kind == 1) return shifted || kernel != XLB_KERNEL_KSTEP;
  return false;
}

// The (stencil, collision) pairs with kExtOpen and kExtHybrid
// instantiations: the open-boundary and curved-wall scenes' D3Q19 BGK
// (flows past a sphere, the sphere drag) and D3Q27 KBC (wind tunnel,
// rotating sphere).
constexpr bool has_open(int q, int collision) {
  return (q == 19 && collision == XLB_COLL_BGK) || (q == 27 && collision == XLB_COLL_KBC);
}

// K8's kExtOpen and kExtHybrid forms, instantiated by
// XLB_INSTANTIATE_OPEN_ADJOINT / XLB_INSTANTIATE_HYBRID_ADJOINT in sources
// of their own (collide_stream_*_{open,hybrid}_adjoint.cu): their forward
// mode over the epilogues makes them the family's longest compiles, so
// the build runs them beside the forward forms.
template <class S, class C, int EXT>
cudaError_t launch_ext_adjoint(const XlbLaunch& a);

// The kernels of K8's launches, in launch order, as adjoint_launch_shape
// reports them: adjoint_kernel, the boundary phase and the centred phase of
// adjoint_centred_kernel, adjoint_staging_kernel.
constexpr int kAdjointLaunches = 4;

// The FORCE of K8's epilogue launches: the kExtOpen and kExtHybrid forms
// compile the force there (applied when p.has_force), as the forward does,
// whatever the bulk's (launch_ext_adjoint_impl).
__host__ __device__ constexpr bool epilogue_force(int ext, bool force) { return force || ext_reads_aux(ext); }

// a.shape[3 i .. 3 i + 2] := kernel_shape of K8's launch i of this form
// (kAdjointLaunches of them), zeros where the form has no such kernel.
template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE>
cudaError_t adjoint_launch_shape(const XlbLaunch& a) {
  constexpr bool EF = epilogue_force(EXT, FORCE);
  for (int i = 0; i < 3 * kAdjointLaunches; ++i) a.shape[i] = 0;
  cudaError_t e = kernel_shape(adjoint_kernel<S, C, T, SHIFTED, EXT, FORCE>, kAdjointThreads, 0, a.shape);
  if constexpr (ext_reads_aux(EXT)) {
    if (e == cudaSuccess)
      e = kernel_shape(adjoint_centred_kernel<S, C, T, SHIFTED, EXT, EF, true>, kAdjointThreads, 0, a.shape + 3);
  }
  if constexpr (EXT != kExtNone) {
    if (e == cudaSuccess)
      e = kernel_shape(adjoint_centred_kernel<S, C, T, SHIFTED, EXT, EF, false>, kAdjointThreads, 0, a.shape + 6);
  }
  if constexpr (ext_reads_aux(EXT)) {
    if (e == cudaSuccess) e = kernel_shape(adjoint_staging_kernel<S>, kAdjointThreads, 0, a.shape + 9);
  }
  return e;
}

// The stream and events per device on which K8's boundary phase runs beside
// the bulk (launch_adjoint), made at first use; lock orders the enqueues
// of concurrent callers.
struct AdjointSide {
  cudaStream_t stream;
  cudaEvent_t fork, join;
  std::mutex lock;
};

inline cudaError_t adjoint_side(AdjointSide*& side) {
  constexpr int kMaxDevices = 64;
  static AdjointSide table[kMaxDevices];
  static bool made[kMaxDevices];
  static std::mutex lock;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  if (!made[dev]) {
    int least, greatest;  // the boundary phase's few long blocks first, so that the bulk fills in around them
    e = cudaDeviceGetStreamPriorityRange(&least, &greatest);
    if (e == cudaSuccess) e = cudaStreamCreateWithPriority(&table[dev].stream, cudaStreamNonBlocking, greatest);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&table[dev].fork, cudaEventDisableTiming);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&table[dev].join, cudaEventDisableTiming);
    if (e != cudaSuccess) return e;
    made[dev] = true;
  }
  side = &table[dev];
  return cudaSuccess;
}

// K8's launches: adjoint_kernel (in the kExtOpen and kExtHybrid forms the
// bulk); in those forms the boundary phase of adjoint_centred_kernel at the
// voxels of an epilogue BC, on a side stream beside the bulk (the two write
// disjoint entries of df and dom, and the boundary phase's transposes are
// long chains that the bulk's blocks fill in around); then, on the
// caller's stream after both, the centred phase when a BC's epilogue reads
// centred populations, and adjoint_staging_kernel when the scene has an
// outflow.
template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE>
cudaError_t launch_adjoint(const XlbLaunch& a) {
  if (a.shape) return adjoint_launch_shape<S, C, T, SHIFTED, EXT, FORCE>(a);
  constexpr bool EF = epilogue_force(EXT, FORCE);
  const XlbStepParams& p = *a.p;
  const T* f = static_cast<const T*>(a.f);
  const int* mask = static_cast<const int*>(a.mask);
  const float* g = static_cast<const float*>(a.g);
  float* df = static_cast<float*>(a.out);
  float* dom = static_cast<float*>(a.dom);
  const unsigned n = unsigned(a.X) * unsigned(a.Y) * unsigned(a.Z);
  const unsigned blocks = (n + kAdjointThreads - 1) / kAdjointThreads;
  bool boundary = false, centred = false, staged = false;
  for (int b = 0; b < p.n_bc; ++b) {
    boundary = boundary || (ext_reads_aux(EXT) && p.bc_kind[b] >= XLB_BC_HALFWAY);
    centred = centred || (EXT != kExtNone && reads_centred(p, b));
    staged = staged || (ext_reads_aux(EXT) && p.bc_kind[b] == XLB_BC_OUTFLOW);
  }
  auto bulk = [&]() {
    adjoint_kernel<S, C, T, SHIFTED, EXT, FORCE><<<blocks, kAdjointThreads, 0, a.stream>>>(
        f, g, mask, a.aux, df, dom, a.X, a.Y, a.Z, a.omega, p);
    return cudaGetLastError();
  };
  cudaError_t e = cudaSuccess;
  if constexpr (ext_reads_aux(EXT)) {
    // the epilogue launches take kEpilogueScan chunks of voxels per block (epilogue_voxels)
    const unsigned epilogue_blocks = (n + kEpilogueTile - 1) / kEpilogueTile;
    if (boundary) {
      AdjointSide* side;
      e = adjoint_side(side);
      if (e != cudaSuccess) return e;
      std::lock_guard<std::mutex> hold(side->lock);
      e = cudaEventRecord(side->fork, a.stream);
      if (e == cudaSuccess) e = cudaStreamWaitEvent(side->stream, side->fork, 0);
      if (e != cudaSuccess) return e;
      adjoint_centred_kernel<S, C, T, SHIFTED, EXT, EF, true><<<epilogue_blocks, kAdjointThreads, 0, side->stream>>>(
          f, g, mask, a.aux, df, dom, a.X, a.Y, a.Z, a.omega, p);
      e = cudaGetLastError();
      if (e == cudaSuccess) e = cudaEventRecord(side->join, side->stream);
      if (e == cudaSuccess) e = bulk();
      if (e == cudaSuccess) e = cudaStreamWaitEvent(a.stream, side->join, 0);
    } else {
      e = bulk();
    }
    if (e == cudaSuccess && centred) {
      adjoint_centred_kernel<S, C, T, SHIFTED, EXT, EF, false><<<epilogue_blocks, kAdjointThreads, 0, a.stream>>>(
          f, g, mask, a.aux, df, nullptr, a.X, a.Y, a.Z, a.omega, p);
      e = cudaGetLastError();
    }
    if (e == cudaSuccess && staged) {
      adjoint_staging_kernel<S><<<blocks, kAdjointThreads, 0, a.stream>>>(g, mask, df, a.X, a.Y, a.Z, p);
      e = cudaGetLastError();
    }
  } else {
    e = bulk();
    if constexpr (EXT != kExtNone) {
      if (e == cudaSuccess && centred) {
        adjoint_centred_kernel<S, C, T, SHIFTED, EXT, EF, false><<<blocks, kAdjointThreads, 0, a.stream>>>(
            f, g, mask, a.aux, df, nullptr, a.X, a.Y, a.Z, a.omega, p);
        e = cudaGetLastError();
      }
    }
  }
  return e;
}

template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE>
cudaError_t launch_kernel(const XlbLaunch& a) {
  constexpr int store = std::is_same<T, float>::value ? 0 : 1;
  constexpr int W = EXT == kExtHybrid ? 3 : (EXT == kExtOpen ? 2 : int(FORCE));  // this instantiation's walled form
  const T* f = static_cast<const T*>(a.f);
  const int* mask = static_cast<const int*>(a.mask);
  T* out = static_cast<T*>(a.out);
  const XlbStepParams& p = *a.p;
  if (a.kernel == XLB_KERNEL_STEP) {
    if constexpr (has_form(XLB_KERNEL_STEP, W, store, SHIFTED)) {
      const unsigned n = unsigned(a.X) * unsigned(a.Y) * unsigned(a.Z);
      step_kernel<S, C, T, SHIFTED, EXT, FORCE><<<(n + kStepThreads - 1) / kStepThreads, kStepThreads, 0, a.stream>>>(
          f, mask, out, a.X, a.Y, a.Z, a.omega, p, a.aux);
      return cudaGetLastError();
    }
  } else if (a.kernel == XLB_KERNEL_KSTEP) {
    if constexpr (has_form(XLB_KERNEL_KSTEP, W, store, SHIFTED)) {
      if (a.K < 2 || a.TY < 1 || a.TZ < 1 || a.seg < 1) return cudaErrorInvalidValue;
      const size_t smem = kstep_smem_bytes<S>(a.K, a.TY, a.TZ, sizeof(T));
      if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
      auto kernel = kstep_kernel<S, C, T, SHIFTED, EXT, FORCE>;
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (e != cudaSuccess) return e;
      }
      if (a.shape) return kernel_shape(kernel, kKstepThreads, smem, a.shape);
      const dim3 grid((a.Z + a.TZ - 1) / a.TZ, (a.Y + a.TY - 1) / a.TY, (a.X + a.seg - 1) / a.seg);
      kstep_kernel<S, C, T, SHIFTED, EXT, FORCE><<<grid, kKstepThreads, smem, a.stream>>>(
          f, mask, out, a.X, a.Y, a.Z, a.seg, a.TY, a.TZ, a.K, a.omega, p, a.aux);
      return cudaGetLastError();
    }
  } else if (a.kernel == XLB_KERNEL_BLOCKED) {
    if constexpr (has_form(XLB_KERNEL_BLOCKED, W, store, SHIFTED)) {
      const int threads = a.TX * a.TY * a.TZ;
      if (a.TX < 1 || a.TY < 1 || a.TZ < 1 || threads > kBlockedThreads) return cudaErrorInvalidValue;
      const dim3 grid((a.Z + a.TZ - 1) / a.TZ, (a.Y + a.TY - 1) / a.TY, (a.X + a.TX - 1) / a.TX);
      blocked_kernel<S, C, T, SHIFTED, EXT, FORCE>
          <<<grid, threads, 0, a.stream>>>(f, mask, out, a.X, a.Y, a.Z, a.TX, a.TY, a.TZ, a.omega, p, a.aux);
      return cudaGetLastError();
    }
  } else if (a.kernel == XLB_KERNEL_ADJOINT) {
    if constexpr (ext_reads_aux(EXT)) {
      return launch_ext_adjoint<S, C, EXT>(a);
    } else if constexpr (has_form(XLB_KERNEL_ADJOINT, W, store, SHIFTED)) {
      return launch_adjoint<S, C, T, SHIFTED, EXT, FORCE>(a);
    }
  }
  return cudaErrorInvalidValue;  // outside the table
}

// The kExtOpen and kExtHybrid kernels of a pair of has_open, instantiated
// by XLB_INSTANTIATE_OPEN and XLB_INSTANTIATE_HYBRID in sources of their
// own (collide_stream_*_open.cu, collide_stream_*_hybrid.cu), so that the
// build compiles them beside the pair's other kernels.
template <class S, class C>
cudaError_t launch_open(const XlbLaunch& a);
template <class S, class C>
cudaError_t launch_hybrid(const XlbLaunch& a);

template <class S, class C, int EXT, bool FORCE>
cudaError_t launch_ext_adjoint_store(const XlbLaunch& a) {
  // f32 is never shifted (has_form, checked by dispatch)
  if (a.store_kind == 0) return launch_adjoint<S, C, float, false, EXT, FORCE>(a);
  return a.shifted ? launch_adjoint<S, C, __nv_bfloat16, true, EXT, FORCE>(a)
                   : launch_adjoint<S, C, __nv_bfloat16, false, EXT, FORCE>(a);
}

// The bulk adjoint_kernel compiled without the force where the scene has
// none (p.has_force), so that its registers and frame are the walled
// form's; the epilogue launches compile it either way (epilogue_force).
template <class S, class C, int EXT>
cudaError_t launch_ext_adjoint_impl(const XlbLaunch& a) {
  return a.p->has_force ? launch_ext_adjoint_store<S, C, EXT, true>(a) : launch_ext_adjoint_store<S, C, EXT, false>(a);
}

template <class S, class C, int EXT>
cudaError_t launch_open_impl(const XlbLaunch& a) {
  if (a.store_kind == 0)
    return a.shifted ? launch_kernel<S, C, float, true, EXT, true>(a) : launch_kernel<S, C, float, false, EXT, true>(a);
  return a.shifted ? launch_kernel<S, C, __nv_bfloat16, true, EXT, true>(a)
                   : launch_kernel<S, C, __nv_bfloat16, false, EXT, true>(a);
}

template <class S, class C, typename T, bool SHIFTED>
cudaError_t launch_walled(const XlbLaunch& a) {
  if (a.p->walled == 3) {
    if constexpr (has_open(S::q, C::id)) return launch_hybrid<S, C>(a);
    return cudaErrorInvalidValue;
  }
  if (a.p->walled == 2) {
    if constexpr (has_open(S::q, C::id)) return launch_open<S, C>(a);
    return cudaErrorInvalidValue;
  }
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

// K1's field modes of the pair (S, C), for the forms of has_field:
// walled (kExtHalfway), kExtOpen, kExtHybrid; f32 or bf16, unshifted.
// Instantiated by XLB_INSTANTIATE_FIELD in sources of their own
// (collide_stream_*_field.cu).
template <class S, class C, int FIELD, int EXT>
cudaError_t launch_field_form(const XlbLaunch& a) {
  constexpr int form = EXT == kExtHybrid ? 3 : (EXT == kExtOpen ? 2 : 1);
  if constexpr (has_field(FIELD, S::q, C::id, form)) {
    const unsigned n = unsigned(a.X) * unsigned(a.Y) * unsigned(a.Z);
    const unsigned blocks = (n + kStepThreads - 1) / kStepThreads;
    const int* mask = static_cast<const int*>(a.mask);
    if (a.store_kind == 0)
      field_step_kernel<S, C, float, EXT, FIELD><<<blocks, kStepThreads, 0, a.stream>>>(
          static_cast<const float*>(a.f), mask, static_cast<float*>(a.out), a.X, a.Y, a.Z, a.omega, *a.p, a.aux);
    else
      field_step_kernel<S, C, __nv_bfloat16, EXT, FIELD><<<blocks, kStepThreads, 0, a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.f), mask, static_cast<__nv_bfloat16*>(a.out), a.X, a.Y, a.Z, a.omega,
          *a.p, a.aux);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

template <class S, class C, int FIELD>
cudaError_t launch_field_walled(const XlbLaunch& a) {
  switch (a.p->walled) {
    case 1: return launch_field_form<S, C, FIELD, kExtHalfway>(a);
    case 2: return launch_field_form<S, C, FIELD, kExtOpen>(a);
    case 3: return launch_field_form<S, C, FIELD, kExtHybrid>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <class S, class C>
cudaError_t launch_field_impl(const XlbLaunch& a) {
  if (a.field == kFieldAde) return launch_field_walled<S, C, kFieldAde>(a);
  if (a.field == kFieldForce) return launch_field_walled<S, C, kFieldForce>(a);
  return cudaErrorInvalidValue;
}

template <class S, class C>
cudaError_t launch_field(const XlbLaunch& a);

#define XLB_INSTANTIATE_FIELD(S, C) \
  template <>                       \
  cudaError_t launch_field<S, C>(const XlbLaunch& a) { return launch_field_impl<S, C>(a); }

#define XLB_INSTANTIATE_PAIR(S, C) \
  template <>                      \
  cudaError_t launch_pair<S, C>(const XlbLaunch& a) { return launch_pair_impl<S, C>(a); }

#define XLB_INSTANTIATE_OPEN(S, C) \
  template <>                      \
  cudaError_t launch_open<S, C>(const XlbLaunch& a) { return launch_open_impl<S, C, kExtOpen>(a); }

#define XLB_INSTANTIATE_HYBRID(S, C) \
  template <>                        \
  cudaError_t launch_hybrid<S, C>(const XlbLaunch& a) { return launch_open_impl<S, C, kExtHybrid>(a); }

#define XLB_INSTANTIATE_OPEN_ADJOINT(S, C)                     \
  template <>                                                  \
  cudaError_t launch_ext_adjoint<S, C, kExtOpen>(const XlbLaunch& a) { \
    return launch_ext_adjoint_impl<S, C, kExtOpen>(a);         \
  }

#define XLB_INSTANTIATE_HYBRID_ADJOINT(S, C)                     \
  template <>                                                    \
  cudaError_t launch_ext_adjoint<S, C, kExtHybrid>(const XlbLaunch& a) { \
    return launch_ext_adjoint_impl<S, C, kExtHybrid>(a);         \
  }

}  // namespace xlb
