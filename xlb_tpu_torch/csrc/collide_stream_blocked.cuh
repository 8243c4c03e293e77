// blocked_kernel (K0): the block-tiled fused 3D step for Hopper (sm_90a),
// included by collide_stream_3d.cuh and instantiated with the rest of the
// family per (stencil, collision) pair.
//
// It replaces the TPU kernel
// xlb_tpu/kernels/collide_stream.py::build_fused_collide_stream_3d, the
// block-mapped step behind build_fused_step(kernel="blocked"): a (TX, TY)
// column tile over the whole z extent whose (q, TX+2, TY+2, Z) halo tile
// nine BlockSpecs assemble in VMEM, feeding the per-voxel body. Here a
// block owns a (TX, TY, TZ) box, one voxel per thread (TX TY TZ <= 256;
// threads along z), and stages in shared memory the box's pull sources:
// for each direction l, the box shifted by -c_l, which is all that
// direction needs of the halo'd neighbourhood. Each thread issues q 4-byte
// cp.async copies, one per direction, into its own q slots (all q in
// flight before it waits once), then pulls from its slots into registers
// and runs the same collide_voxel as step_kernel (K1): K0 computes K1's
// function, and with the same compiled arithmetic gives the same bits. A
// thread reads only the slots it filled itself, so cp.async.wait_group
// alone orders the copy before the read and the kernel has no barrier;
// ragged edge boxes return early, and the periodic wrap is index
// arithmetic, so any (X, Y, Z) runs. A halo box of every population would
// not fit at q = 27 (10 x 10 x 34 voxels x 27 x 4 B ~ 367 KB for an 8x8x32
// box); the per-direction boxes take q x 4 B per thread (27.0 KB per
// 256-thread block at q = 27, 19.0 KB at q = 19).
//
// bf16 populations are 2 bytes and cp.async copies at least 4: a thread
// copies the aligned 32-bit word that holds its element and takes the half
// its index selects. The word may reach 2 bytes past the tensor's last
// element, inside the caching allocator's 512-byte granule; the wrapper
// checks that the tensor starts on a 4-byte boundary.
//
// With kExtOpen and kExtHybrid the aux field and the outflow's staged neighbours
// (x - t, |t_a| <= 1, at outflow voxels only) are read from device memory,
// as step_kernel reads them.
//
// Bound: the same bytes and operations per voxel as step_kernel.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "collide_stream.cuh"

namespace xlb {

constexpr int kBlockedThreads = 256;

__device__ __forceinline__ void cp_async4(uint32_t* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The 32-bit word at or below element i of f (the element itself for f32).
template <typename T>
__device__ __forceinline__ const void* word_of(const T* f, size_t i) {
  if constexpr (std::is_same<T, float>::value) return f + i;
  else return f + (i & ~size_t(1));
}

// The element from the word that word_of copied; odd: the element's index
// is odd (bf16: the upper half of the word).
template <typename T>
__device__ __forceinline__ float from_word(uint32_t word, bool odd) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(word);
  } else {
    const unsigned short half = odd ? static_cast<unsigned short>(word >> 16) : static_cast<unsigned short>(word);
    return __bfloat162float(__ushort_as_bfloat16(half));
  }
}

template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE>
__global__ void __launch_bounds__(kBlockedThreads)
    blocked_kernel(const T* __restrict__ f, const int* __restrict__ mask, T* __restrict__ out, int X, int Y, int Z,
                   int TX, int TY, int TZ, float omega, const __grid_constant__ XlbStepParams p,
                   const float* __restrict__ aux) {
  __shared__ __align__(16) uint32_t stage[S::q * kBlockedThreads];  // [l][thread]
  const int t = threadIdx.x, nt = blockDim.x;
  const int iz = t % TZ, iy = (t / TZ) % TY, ix = t / (TZ * TY);
  const int x = blockIdx.z * TX + ix, y = blockIdx.y * TY + iy, z = blockIdx.x * TZ + iz;
  if (x >= X || y >= Y || z >= Z) return;  // ragged edge box; no barrier follows
  const size_t plane = size_t(X) * Y * Z;
  const size_t v = (size_t(x) * Y + y) * Z + z;

  uint32_t odd = 0;  // bit l: the pull source of direction l has an odd index
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    const int xs = wrap1(x - S::c(0, l), X);
    const int ys = wrap1(y - S::c(1, l), Y);
    const int zs = wrap1(z - S::c(2, l), Z);
    const size_t src = l * plane + (size_t(xs) * Y + ys) * Z + zs;
    odd |= uint32_t(src & 1) << l;
    cp_async4(&stage[l * nt + t], word_of(f, src));
  }
  cp_async_wait_all();

  auto pull = [&](int l) { return from_word<T>(stage[l * nt + t], (odd >> l) & 1); };
  auto center = [&](int l) { return to_f32(f[l * plane + v]); };

  float o[S::q];
  if constexpr (ext_reads_aux(EXT)) {
    auto aux_at = [&](int ch) { return aux[ch * plane + v]; };
    auto staged = [&](int m, int tx, int ty, int tz) {
      return to_f32(f[m * plane + (size_t(wrap1(x - tx, X)) * Y + wrap1(y - ty, Y)) * Z + wrap1(z - tz, Z)]);
    };
    collide_voxel<S, SHIFTED, EXT, C, FORCE>(pull, center, mask[v], omega, p, o, aux_at, staged);
  } else {
    collide_voxel<S, SHIFTED, EXT, C, FORCE>(pull, center, mask[v], omega, p, o);
  }
#pragma unroll
  for (int l = 0; l < S::q; ++l) out[l * plane + v] = from_f32<T>(o[l]);
}

}  // namespace xlb
