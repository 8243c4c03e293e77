// The multires collide-then-stream kernel family (K6, K7) for Hopper
// (sm_90a), bound through the plain C launcher at the end of this file
// (ctypes, xlb_tpu_torch/kernels/_cuda.py).
//
// Replaces the TPU kernels xlb_tpu/kernels/collide_then_stream.py::
// build_fused_cts_pair_thin (K7) and ::build_fused_collide_then_stream
// (K6, the same function over one common ring without the side output).
// Layout: populations (q, X, Y, Z) of a level's (ring-extended) box in the
// store dtype, z contiguous; the packed int32 mask (X, Y, Z) of
// kernels/fused_step.py::pack_masks. The box wraps periodically.
//
// Collide-then-stream differs from the collide-stream kernels in one way:
// output (x, l) is the POST-collision population l of x - c_l, so a
// voxel's collision feeds up to 18 neighbours. Recomputing it in each of
// them (a pull) costs 19 collisions per voxel; keeping collided values of
// a halo in shared memory costs 76 B per voxel in f32. These kernels push
// instead: each thread collides its own voxel once and stores population
// l at x + c_l, unless the destination's own thread writes that slot --
// an equilibrium BC, a halfway reflection of a missing direction, a solid
// (or, between the pair's sub-steps, any cell of type >= 254) re-emitting
// its input, a frozen ring cell. The destination's mask decides, so every
// slot has exactly one writer and no atomics are needed.
//
// cts_single_kernel: one sub-step, one thread per voxel (the coarsest and
// middle levels). cts_pair_kernel: both finest sub-steps in one pass. A
// block owns a (TX, TY, TZ) tile: sub-step A collides the tile's depth-1
// region (through L1/L2, wrapped) and pushes into the tile's slots in
// shared memory, rounded to the store dtype (19 x 4 x 8 x 32 x 2 B = 39 KB
// bf16, 78 KB f32); after a barrier sub-step B collides the tile from
// shared memory and pushes to device memory. Each voxel is collided
// (TX+2)(TY+2)(TZ+2)/(TX TY TZ) + 1 ~ 3 times per pair instead of 2, and
// the populations cross device memory once per pair. Both sub-steps run
// the same device functions as the single kernel and round at the same
// places, so the pair equals two single launches with the ring frozen bit
// for bit.
//
// coalesce_kernel: the fine->coarse average of the core (the reference's
// coalesce_out side output finished on the card): per parent cell and
// direction the 8 children, summed in x pairs, then y pairs, then z pairs,
// times 1/8, in the stored form. It runs right after the sub-step on the
// same stream and re-reads the core (76 B per fine voxel in f32), where
// the TPU kernel summed at write time; folding it into the push is work
// for a later change.
//
// Bound by device-memory bytes: per voxel the populations and the mask are
// read once and the populations written once (156 B f32, 80 B bf16), plus
// the average (9.5 B per fine voxel).

#include <cuda_runtime.h>

#include "collide_stream.cuh"

namespace xlb {

using S = D3Q19;
constexpr int kCtsThreads = 256;
constexpr int kSfvId = 254;
constexpr size_t kCtsMaxShared = 232448;  // 227 KB opt-in limit per block on sm_90

// Dynamic shared memory of the pair kernel: sub-step A's outputs for one tile.
__host__ __device__ inline size_t pair_smem_bytes(int tx, int ty, int tz, size_t tsize) {
  return size_t(S::q) * tx * ty * tz * tsize;
}

// Who writes slot (x, l) of a sub-step's output.
enum : int { kPushed = 0, kReemit = 1, kEquilibrium = 2, kHalfway = 3 };

// KEEP_ALL: between the pair's sub-steps every cell of type >= 254 ends
// with its input; otherwise only solids (255) do.
template <bool KEEP_ALL>
__device__ __forceinline__ int slot_owner(int packed, int l, bool frozen, const XlbStepParams& p, int& b_out) {
  const int bc = cell_type(packed);
  if (frozen) return kReemit;
  if (KEEP_ALL ? bc >= kSfvId : bc == XLB_SOLID_ID) return kReemit;
  for (int b = 0; b < p.n_bc; ++b) {
    if (bc != p.bc_id[b]) continue;
    if (p.bc_kind[b] == XLB_BC_EQUILIBRIUM) {
      b_out = b;
      return kEquilibrium;
    }
    if (p.bc_kind[b] == XLB_BC_HALFWAY && missing_bit(packed, l)) {
      b_out = b;
      return kHalfway;
    }
  }
  return kPushed;
}

// The f32 value a slot's owner writes (before the shifted store).
__device__ __forceinline__ float owner_value(int kind, int b, int l, const float fp[S::q], const float pc[S::q],
                                             const XlbStepParams& p) {
  if (kind == kEquilibrium) return p.bc[b].vec[l];
  if (kind == kHalfway) {
    const float refl = pc[S::opp(l)];
    return p.bc[b].flag ? refl + p.bc[b].vec[l] : refl;
  }
  return fp[l];  // kReemit
}

// The collide of one voxel: BGK, the collision-step fullway epilogue
// (f[opp l]) and the keep of cell types >= 254 (ring, refined region and
// solid cells keep their input).
__device__ __forceinline__ void cts_collide(const float fp[S::q], int bc, float omega, const XlbStepParams& p,
                                            float pc[S::q]) {
  float rho, inv_rho, u[S::d], feq[S::q];
  moments_equilibrium<S>(fp, p, rho, inv_rho, u, feq);
#pragma unroll
  for (int l = 0; l < S::q; ++l) pc[l] = fp[l] - omega * (fp[l] - feq[l]);
  if (is_fullway(bc, p)) {
#pragma unroll
    for (int l = 0; l < S::q; ++l) pc[l] = fp[S::opp(l)];
  }
  if (bc >= kSfvId) {
#pragma unroll
    for (int l = 0; l < S::q; ++l) pc[l] = fp[l];
  }
}

template <typename T>
__device__ __forceinline__ T store_value(float v, int l, bool shifted, const XlbStepParams& p) {
  return from_f32<T>(shifted ? v - p.w[l] : v);
}

struct Box {
  int X, Y, Z, gx, gy, gz;
  __device__ __forceinline__ size_t at(int x, int y, int z) const { return (size_t(x) * Y + y) * Z + z; }
  // whether (x, y, z) lies in the outer ring (z only when gz > 0)
  __device__ __forceinline__ bool in_ring(int x, int y, int z) const {
    return x < gx || x >= X - gx || y < gy || y >= Y - gy || (gz > 0 && (z < gz || z >= Z - gz));
  }
};

// Sub-step output of the voxel (x, y, z) with input fp and collided pc:
// the pushes to its neighbours and its own slots, to device memory.
template <typename T>
__device__ __forceinline__ void push_to_global(const Box& b, int x, int y, int z, int packed, const float fp[S::q],
                                               const float pc[S::q], bool shifted, bool freeze, T* __restrict__ out,
                                               const int* __restrict__ mask, const XlbStepParams& p) {
  const size_t plane = size_t(b.X) * b.Y * b.Z;
  const size_t v = b.at(x, y, z);
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    const int xd = wrap1(x + S::c(0, l), b.X), yd = wrap1(y + S::c(1, l), b.Y), zd = wrap1(z + S::c(2, l), b.Z);
    const size_t d = b.at(xd, yd, zd);
    int bi = 0;
    if (slot_owner<false>(mask[d], l, freeze && b.in_ring(xd, yd, zd), p, bi) == kPushed)
      out[l * plane + d] = store_value<T>(pc[l], l, shifted, p);
  }
  const bool frozen = freeze && b.in_ring(x, y, z);
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    int bi = 0;
    const int kind = slot_owner<false>(packed, l, frozen, p, bi);
    if (kind != kPushed) out[l * plane + v] = store_value<T>(owner_value(kind, bi, l, fp, pc, p), l, shifted, p);
  }
}

template <typename T>
__global__ void __launch_bounds__(kCtsThreads)
    cts_single_kernel(const T* __restrict__ f, const int* __restrict__ mask, T* __restrict__ out, Box b, float omega,
                      int shifted, int freeze, const __grid_constant__ XlbStepParams p) {
  const unsigned n = unsigned(b.X) * unsigned(b.Y) * unsigned(b.Z);
  const unsigned v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int z = int(v % unsigned(b.Z));
  const unsigned xy = v / unsigned(b.Z);
  const int y = int(xy % unsigned(b.Y));
  const int x = int(xy / unsigned(b.Y));
  const size_t plane = n;
  const int packed = mask[v];
  float fp[S::q], pc[S::q];
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    fp[l] = to_f32(f[l * plane + v]);
    if (shifted) fp[l] += p.w[l];
  }
  cts_collide(fp, cell_type(packed), omega, p, pc);
  push_to_global<T>(b, x, y, z, packed, fp, pc, shifted, freeze, out, mask, p);
}

template <typename T>
__global__ void __launch_bounds__(kCtsThreads, 2)
    cts_pair_kernel(const T* __restrict__ f, const int* __restrict__ mask, T* __restrict__ out, Box b, int TX, int TY,
                    int TZ, float omega, int shifted, int freeze, const __grid_constant__ XlbStepParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_mid = reinterpret_cast<T*>(smem);  // sub-step A's outputs on the tile, (q, TX, TY, TZ), store form
  const size_t plane = size_t(b.X) * b.Y * b.Z;
  const int x0 = blockIdx.z * TX, y0 = blockIdx.y * TY, z0 = blockIdx.x * TZ;
  const int tvol = TX * TY * TZ;

  // sub-step A on the depth-1 region around the tile, pushed into the tile
  const int ey = TY + 2, ez = TZ + 2, evol = (TX + 2) * ey * ez;
  for (int i = threadIdx.x; i < evol; i += blockDim.x) {
    int r = i;
    const int lz = r % ez - 1;
    r /= ez;
    const int ly = r % ey - 1;
    const int lx = r / ey - 1;
    const int gx = wrapmod(x0 + lx, b.X), gy = wrapmod(y0 + ly, b.Y), gz = wrapmod(z0 + lz, b.Z);
    const size_t g = b.at(gx, gy, gz);
    const int packed = mask[g];
    float fp[S::q], pc[S::q];
#pragma unroll
    for (int l = 0; l < S::q; ++l) {
      fp[l] = to_f32(f[l * plane + g]);
      if (shifted) fp[l] += p.w[l];
    }
    cts_collide(fp, cell_type(packed), omega, p, pc);
#pragma unroll
    for (int l = 0; l < S::q; ++l) {
      const int dx = lx + S::c(0, l), dy = ly + S::c(1, l), dz = lz + S::c(2, l);
      if (dx < 0 || dx >= TX || dy < 0 || dy >= TY || dz < 0 || dz >= TZ) continue;
      const size_t d = b.at(wrap1(gx + S::c(0, l), b.X), wrap1(gy + S::c(1, l), b.Y), wrap1(gz + S::c(2, l), b.Z));
      int bi = 0;
      if (slot_owner<true>(mask[d], l, false, p, bi) == kPushed)
        s_mid[l * tvol + (dx * TY + dy) * TZ + dz] = store_value<T>(pc[l], l, shifted, p);
    }
    if (lx >= 0 && lx < TX && ly >= 0 && ly < TY && lz >= 0 && lz < TZ) {
#pragma unroll
      for (int l = 0; l < S::q; ++l) {
        int bi = 0;
        const int kind = slot_owner<true>(packed, l, false, p, bi);
        if (kind != kPushed)
          s_mid[l * tvol + (lx * TY + ly) * TZ + lz] = store_value<T>(owner_value(kind, bi, l, fp, pc, p), l, shifted, p);
      }
    }
  }
  __syncthreads();

  // sub-step B on the tile, from shared memory to device memory
  for (int i = threadIdx.x; i < tvol; i += blockDim.x) {
    int r = i;
    const int lz = r % TZ;
    r /= TZ;
    const int ly = r % TY;
    const int lx = r / TY;
    const int x = x0 + lx, y = y0 + ly, z = z0 + lz;
    if (x >= b.X || y >= b.Y || z >= b.Z) continue;
    const int packed = mask[b.at(x, y, z)];
    float fp[S::q], pc[S::q];
#pragma unroll
    for (int l = 0; l < S::q; ++l) {
      fp[l] = to_f32(s_mid[l * tvol + i]);
      if (shifted) fp[l] += p.w[l];
    }
    cts_collide(fp, cell_type(packed), omega, p, pc);
    push_to_global<T>(b, x, y, z, packed, fp, pc, shifted, freeze, out, mask, p);
  }
}

template <typename T>
__global__ void __launch_bounds__(kCtsThreads)
    coalesce_kernel(const T* __restrict__ out, float* __restrict__ avg, Box b) {
  const int hx = (b.X - 2 * b.gx) / 2, hy = (b.Y - 2 * b.gy) / 2, hz = (b.Z - 2 * b.gz) / 2;
  const unsigned n = unsigned(hx) * unsigned(hy) * unsigned(hz);
  const unsigned v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int pz = int(v % unsigned(hz));
  const unsigned xy = v / unsigned(hz);
  const int py = int(xy % unsigned(hy));
  const int px = int(xy / unsigned(hy));
  const size_t plane = size_t(b.X) * b.Y * b.Z;
  const size_t c0 = b.at(b.gx + 2 * px, b.gy + 2 * py, b.gz + 2 * pz);
  const size_t sx = size_t(b.Y) * b.Z, sy = size_t(b.Z);
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    const T* o = out + l * plane + c0;
    const float a00 = to_f32(o[0]) + to_f32(o[sx]);
    const float a10 = to_f32(o[sy]) + to_f32(o[sx + sy]);
    const float a01 = to_f32(o[1]) + to_f32(o[sx + 1]);
    const float a11 = to_f32(o[sy + 1]) + to_f32(o[sx + sy + 1]);
    avg[l * size_t(n) + v] = ((a00 + a10) + (a01 + a11)) * 0.125f;
  }
}

template <typename T>
cudaError_t launch_cts(int pair, int freeze, int coalesce, int shifted, const void* f, const void* mask, void* out,
                       void* avg, const Box& b, int TX, int TY, int TZ, float omega, const XlbStepParams& p,
                       cudaStream_t stream) {
  const T* fin = static_cast<const T*>(f);
  const int* m = static_cast<const int*>(mask);
  T* o = static_cast<T*>(out);
  if (pair) {
    const size_t smem = pair_smem_bytes(TX, TY, TZ, sizeof(T));
    if (smem > kCtsMaxShared) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(cts_pair_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (e != cudaSuccess) return e;
    }
    const dim3 grid((b.Z + TZ - 1) / TZ, (b.Y + TY - 1) / TY, (b.X + TX - 1) / TX);
    cts_pair_kernel<T><<<grid, kCtsThreads, smem, stream>>>(fin, m, o, b, TX, TY, TZ, omega, shifted, freeze, p);
  } else {
    const unsigned n = unsigned(b.X) * unsigned(b.Y) * unsigned(b.Z);
    cts_single_kernel<T><<<(n + kCtsThreads - 1) / kCtsThreads, kCtsThreads, 0, stream>>>(fin, m, o, b, omega, shifted,
                                                                                          freeze, p);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !coalesce) return e;
  const unsigned n2 = unsigned((b.X - 2 * b.gx) / 2) * unsigned((b.Y - 2 * b.gy) / 2) * unsigned((b.Z - 2 * b.gz) / 2);
  coalesce_kernel<T><<<(n2 + kCtsThreads - 1) / kCtsThreads, kCtsThreads, 0, stream>>>(o, static_cast<float*>(avg), b);
  return cudaGetLastError();
}

}  // namespace xlb

extern "C" {

// store_kind: 0 = float32, 1 = bfloat16. pair: both finest sub-steps;
// freeze: ring cells end with their input; coalesce: also write the
// core's 2^3-child average to avg (float32). Returns the cudaError_t of
// the launches.
int xlb_collide_then_stream(int store_kind, int shifted, int pair, int freeze, int coalesce, const void* f,
                            const void* mask, void* out, void* avg, int X, int Y, int Z, int gx, int gy, int gz,
                            int TX, int TY, int TZ, float omega, const XlbStepParams* params, void* stream) {
  if (X < 1 || Y < 1 || Z < 1 || gx < 0 || gy < 0 || gz < 0 || 2 * gx >= X || 2 * gy >= Y || 2 * gz >= Z)
    return cudaErrorInvalidValue;
  if (pair && (TX < 1 || TY < 1 || TZ < 1)) return cudaErrorInvalidValue;
  if (coalesce && (avg == nullptr || (X - 2 * gx) % 2 || (Y - 2 * gy) % 2 || (Z - 2 * gz) % 2))
    return cudaErrorInvalidValue;
  const xlb::Box b{X, Y, Z, gx, gy, gz};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_kind == 0)
    return xlb::launch_cts<float>(pair, freeze, coalesce, shifted, f, mask, out, avg, b, TX, TY, TZ, omega, *params, s);
  if (store_kind == 1)
    return xlb::launch_cts<__nv_bfloat16>(pair, freeze, coalesce, shifted, f, mask, out, avg, b, TX, TY, TZ, omega,
                                          *params, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
