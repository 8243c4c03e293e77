// The copy-bandwidth probes of examples/performance/ (K9-K12) for Hopper
// (sm_90a), bound through the plain C launchers at the end of this file
// (ctypes, xlb_tpu_torch/kernels/_cuda.py; wrappers in
// xlb_tpu_torch/kernels/copy_bandwidth.py).
//
// They replace the TPU kernels
//   K9  examples/performance/memory_bandwidth.py::copy_kernel (out = f, a
//       pipelined block copy): vector_copy_kernel, a plain copy of 16-byte
//       words, V words per thread, consecutive threads on consecutive words;
//   K10 examples/performance/dma_experiments.py::hbm2hbm_kernel (one
//       whole-array device-to-device DMA) and
//   K11 dma_experiments.py::hbm2hbm_q_kernel (q concurrent per-channel
//       DMAs): bulk_copy_kernel over one range or q. Hopper has no
//       global-to-global bulk copy, so each chunk goes global -> shared with
//       cp.async.bulk on an mbarrier, then shared -> global with
//       cp.async.bulk in a bulk group. The q ranges' chunks form one chunk
//       space (a chunk never crosses a range, so each range stays its own
//       chain of bulk copies) that a persistent grid deals out round robin:
//       no resident slot idles at any q and the tails balance. One thread
//       per block drives a ring of kBulkStages stages, kBulkAhead of them
//       loading while the others' stores read theirs;
//   K12 dma_experiments.py::make_manual (a manually pipelined scale-copy
//       out = x * 1.0000001f): manual_scale_kernel, a ring of DEPTH
//       shared-memory stages, each filled by SPLIT bulk loads on one
//       mbarrier; the scale runs in registers with __fmul_rn (never
//       contracted); with MANUAL_OUT the result goes back to shared memory
//       (two stages) and leaves through cp.async.bulk stores, a stage
//       reused only once its store group has read it; without, plain
//       global stores.
//
// The TPU's VMEM tiles do not carry over (K12's (1, 8, 256, 256) f32 stage
// is 2 MB, far beyond 227 KB of shared memory): a stage here is 8-16 KB.
// Every kernel takes any contiguous float32 range whose input and output
// share their address modulo 16 bytes (the wrappers allocate the output so):
// a scalar head up to the first 16-byte boundary, a body of whole 16-byte
// words (the bulk copies' unit of size and address), a scalar tail. All
// four are bound by device-memory bytes: each reads its input once and
// writes its output once, 8 bytes per float. The persistent grids' shapes
// are queried on a kernel's first launch on each device and kept.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace xlb {

constexpr float kScale = 1.0000001f;  // dma_experiments.py's jnp.float32(1.0000001)

// A float32 range split at 16-byte boundaries, in floats; body % 4 == 0.
struct Split16 {
  size_t head, body, tail;
};

__device__ __forceinline__ Split16 split16(const float* p, size_t n) {
  size_t head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4;
  head = head < n ? head : n;
  const size_t body = (n - head) & ~size_t(3);
  return {head, body, n - head - body};
}

template <bool SCALE>
__device__ __forceinline__ float apply(float v) {
  return SCALE ? __fmul_rn(v, kScale) : v;
}

template <bool SCALE>
__device__ __forceinline__ float4 apply4(float4 v) {
  return make_float4(apply<SCALE>(v.x), apply<SCALE>(v.y), apply<SCALE>(v.z), apply<SCALE>(v.w));
}

// The scalar head (threads 0..3) and tail (threads 4..7) of a range
// (blockDim.x >= 8).
template <bool SCALE>
__device__ __forceinline__ void copy_edges(const float* in, float* out, const Split16& s) {
  const unsigned t = threadIdx.x;
  if (t < s.head) {
    out[t] = apply<SCALE>(in[t]);
  } else if (t >= 4 && t - 4 < s.tail) {
    const size_t i = s.head + s.body + (t - 4);
    out[i] = apply<SCALE>(in[i]);
  }
}

// ---------------------------------------------------------------- K9

// Block b copies the 16-byte words [b, b + 1) x blockDim.x x V of the body,
// word k x blockDim.x + threadIdx.x of them per unrolled step k.
template <int V>
__global__ void vector_copy_kernel(const float* __restrict__ in, float* __restrict__ out, size_t n) {
  const Split16 s = split16(in, n);
  if (blockIdx.x == 0) copy_edges<false>(in, out, s);
  const float4* src = reinterpret_cast<const float4*>(in + s.head);
  float4* dst = reinterpret_cast<float4*>(out + s.head);
  const size_t words = s.body / 4;
  const size_t base = size_t(blockIdx.x) * blockDim.x * V + threadIdx.x;
  float4 r[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const size_t i = base + size_t(k) * blockDim.x;
    if (i < words) r[k] = src[i];
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const size_t i = base + size_t(k) * blockDim.x;
    if (i < words) dst[i] = r[k];
  }
}

// ------------------------------------------------- bulk copies, mbarriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

// The one arrival of a stage's phase, expecting ``bytes`` from its bulk loads.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Wait for the phase of parity ``parity`` to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* stage, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(stage)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* stage, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_addr(stage)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Wait until at most N committed store groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Generic-proxy writes to shared memory become visible to the bulk copies.
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// The chunks of a block: chunk j of the block is chunk first + j x stride of
// a body of ``bytes`` bytes cut into CHUNK-byte pieces (the last shorter,
// still a multiple of 16).
template <int CHUNK>
struct Chunks {
  size_t bytes;
  unsigned first, stride;
  __device__ __forceinline__ size_t count() const {
    const size_t total = (bytes + CHUNK - 1) / CHUNK;
    return first < total ? (total - first + stride - 1) / stride : 0;
  }
  __device__ __forceinline__ size_t offset(size_t j) const { return (first + j * stride) * size_t(CHUNK); }
  __device__ __forceinline__ uint32_t size(size_t j) const {
    const size_t left = bytes - offset(j);
    return uint32_t(left < size_t(CHUNK) ? left : size_t(CHUNK));
  }
};

// ---------------------------------------------------------- K10, K11

// The ring of bulk_copy_kernel: kBulkStages stages of kBulkChunk bytes,
// kBulkAhead chunks loading ahead of the one being stored, which leaves
// kBulkStages - kBulkAhead store groups free to read their stages; the grid
// keeps kBulkPerSm blocks per SM (0: as many as fit). Chosen by
// examples/performance/bulk_copy_sweep.py (PERF.md): on an H100 the copy
// runs fastest with ~32 KB of loads in flight per SM (2 blocks x 2 x 8 KB);
// more in flight runs slower.
constexpr int kBulkThreads = 32;
constexpr int kBulkChunk = 8192;
constexpr int kBulkStages = 4;
constexpr int kBulkAhead = 2;
constexpr int kBulkPerSm = 2;

// One chunk of a bulk copy: source, destination, bytes (0: past its
// range's body, nothing to copy).
struct BulkChunk {
  const unsigned char* src;
  unsigned char* dst;
  uint32_t bytes;
};

// Chunk g of the chunk space of ranges of n floats, per_range chunks of
// CHUNK bytes each: chunk g % per_range of range g / per_range's body.
template <int CHUNK>
__device__ __forceinline__ BulkChunk bulk_chunk(const float* in, float* out, size_t n, size_t per_range, size_t g) {
  const size_t r = g / per_range, off = (g - r * per_range) * CHUNK;
  const float* src = in + r * n;
  const Split16 s = split16(src, n);
  const size_t body = s.body * 4, left = off < body ? body - off : 0;
  return {reinterpret_cast<const unsigned char*>(src + s.head) + off,
          reinterpret_cast<unsigned char*>(out + r * n + s.head) + off, uint32_t(left < CHUNK ? left : CHUNK)};
}

// ``ranges`` consecutive ranges of n floats (K10: one; K11: the q channel
// slices), per_range = ceil(4 n / CHUNK) chunks each. Block b copies the
// scalar edges of ranges b, b + gridDim.x, ...; its thread 0 copies chunks
// b, b + gridDim.x, ... of the chunk space: chunk j of the block lands in
// stage j % STAGES and is stored as soon as it has landed; then the load of
// chunk j + AHEAD refills the stage of chunk j + AHEAD - STAGES once that
// chunk's store group has read it (at most STAGES - AHEAD groups still
// reading).
template <int CHUNK, int STAGES, int AHEAD>
__global__ void __launch_bounds__(kBulkThreads) bulk_copy_kernel(const float* __restrict__ in,
                                                                  float* __restrict__ out, size_t n, unsigned ranges,
                                                                  size_t per_range) {
  static_assert(CHUNK % 16 == 0 && 0 < AHEAD && AHEAD < STAGES, "a ring of whole 16-byte words, loads and stores");
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t bar[STAGES];
  for (size_t r = blockIdx.x; r < ranges; r += gridDim.x)
    copy_edges<false>(in + r * n, out + r * n, split16(in + r * n, n));
  if (threadIdx.x != 0) return;
  const size_t total = ranges * per_range;
  const size_t count = blockIdx.x < total ? (total - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (count == 0) return;
  for (int i = 0; i < STAGES; ++i) mbar_init(&bar[i]);
  mbar_init_fence();
  auto chunk = [&](size_t j) { return bulk_chunk<CHUNK>(in, out, n, per_range, blockIdx.x + j * gridDim.x); };
  auto load = [&](size_t j) {
    const int st = int(j % STAGES);
    const BulkChunk c = chunk(j);
    mbar_expect(&bar[st], c.bytes);  // 0 bytes: the phase completes on the arrival alone
    if (c.bytes != 0) bulk_load(ring + st * CHUNK, c.src, c.bytes, &bar[st]);
  };
  for (size_t j = 0; j < count && j < size_t(AHEAD); ++j) load(j);
  for (size_t j = 0; j < count; ++j) {
    const int st = int(j % STAGES);
    mbar_wait(&bar[st], uint32_t(j / STAGES) & 1u);
    const BulkChunk c = chunk(j);
    if (c.bytes != 0) bulk_store(c.dst, ring + st * CHUNK, c.bytes);
    bulk_commit();  // an empty group for an empty chunk keeps the count of groups
    if (j + AHEAD < count) {
      bulk_wait_read<STAGES - AHEAD>();
      load(j + AHEAD);
    }
  }
  bulk_wait_all();
}

// -------------------------------------------------------------- K12

constexpr int kManualThreads = 256;
constexpr int kManualChunk = 16384;

__host__ __device__ constexpr int manual_smem(int depth, bool manual_out) {
  return (depth + (manual_out ? 2 : 0)) * kManualChunk;
}

// Chunk j of the block waits in stage j % DEPTH; thread 0 issues the loads
// of chunk j + DEPTH - 1 into the stage chunk j - 1 left (every thread is
// past it: the barrier closing step j - 1), as make_manual starts the DMA
// of step it + depth - 1 before it waits on step it.
template <int DEPTH, int SPLIT, bool MANUAL_OUT>
__global__ void __launch_bounds__(kManualThreads) manual_scale_kernel(const float* __restrict__ in,
                                                                       float* __restrict__ out, size_t n) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar[DEPTH];
  unsigned char* ring = smem;
  float4* obuf = reinterpret_cast<float4*>(smem + DEPTH * kManualChunk);  // 2 stages with MANUAL_OUT
  const Split16 s = split16(in, n);
  if (blockIdx.x == 0) copy_edges<true>(in, out, s);
  const Chunks<kManualChunk> ch{s.body * 4, blockIdx.x, gridDim.x};
  const size_t count = ch.count();
  const unsigned char* g_in = reinterpret_cast<const unsigned char*>(in + s.head);
  unsigned char* g_out = reinterpret_cast<unsigned char*>(out + s.head);
  if (threadIdx.x == 0) {
    for (int i = 0; i < DEPTH; ++i) mbar_init(&bar[i]);
    mbar_init_fence();
  }
  __syncthreads();
  auto load = [&](size_t j) {  // SPLIT bulk loads of whole 16-byte words on one mbarrier
    const int st = int(j % DEPTH);
    const uint32_t bytes = ch.size(j), part = bytes / 16 / SPLIT * 16;
    mbar_expect(&bar[st], bytes);
    uint32_t done = 0;
#pragma unroll
    for (int k = 0; k < SPLIT; ++k) {
      const uint32_t piece = k + 1 == SPLIT ? bytes - done : part;
      if (piece) bulk_load(ring + st * kManualChunk + done, g_in + ch.offset(j) + done, piece, &bar[st]);
      done += piece;
    }
  };
  if (threadIdx.x == 0)
    for (size_t j = 0; j + 1 < size_t(DEPTH) && j < count; ++j) load(j);
  for (size_t j = 0; j < count; ++j) {
    const int st = int(j % DEPTH);
    if (threadIdx.x == 0 && j + DEPTH - 1 < count) load(j + DEPTH - 1);
    mbar_wait(&bar[st], uint32_t(j / DEPTH) & 1u);
    const unsigned words = ch.size(j) / 16;
    const float4* x4 = reinterpret_cast<const float4*>(ring + st * kManualChunk);
    if constexpr (MANUAL_OUT) {
      float4* o4 = obuf + (j & 1) * (kManualChunk / 16);
      if (threadIdx.x == 0) bulk_wait_read<1>();  // chunk j - 2's store has read this output stage
      __syncthreads();
      for (unsigned t = threadIdx.x; t < words; t += blockDim.x) o4[t] = apply4<true>(x4[t]);
      fence_async_shared();
      __syncthreads();
      if (threadIdx.x == 0) {
        bulk_store(g_out + ch.offset(j), o4, ch.size(j));
        bulk_commit();
      }
    } else {
      float4* y4 = reinterpret_cast<float4*>(g_out + ch.offset(j));
      for (unsigned t = threadIdx.x; t < words; t += blockDim.x) y4[t] = apply4<true>(x4[t]);
    }
    __syncthreads();  // stage st is free for the load of chunk j + DEPTH
  }
  if (MANUAL_OUT && threadIdx.x == 0) bulk_wait_all();
}

// ---------------------------------------------------------- launchers

bool shares_alignment(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) ^ reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// Blocks of ``kernel`` resident on one SM at once, at most ``max_per_sm``
// (0: as many as fit).
template <typename K>
cudaError_t blocks_per_sm(K kernel, int threads, int smem, int max_per_sm, int& per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (max_per_sm > 0 && per_sm > max_per_sm) per_sm = max_per_sm;
  return err;
}

constexpr int kCachedDevices = 16;

// Blocks of ``kernel`` resident on the whole card at once (a persistent
// grid), at most ``max_per_sm`` per SM (0: as many as fit), queried on its
// first launch on each device and kept in ``cache`` (the launcher's own,
// one per kernel; 0: not queried yet).
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int smem, int max_per_sm, std::atomic<int>* cache, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  blocks = dev < kCachedDevices ? cache[dev].load(std::memory_order_relaxed) : 0;
  if (blocks > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm(kernel, threads, smem, max_per_sm, per_sm);
  blocks = per_sm * sms;
  if (err == cudaSuccess && blocks < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess && dev < kCachedDevices) cache[dev].store(blocks, std::memory_order_relaxed);
  return err;
}

template <int V>
cudaError_t launch_vector(const float* in, float* out, size_t n, int threads, cudaStream_t s) {
  const size_t per_block = size_t(threads) * V * 4;
  const size_t blocks = (n + per_block - 1) / per_block;
  vector_copy_kernel<V><<<unsigned(blocks > 0 ? blocks : 1), threads, 0, s>>>(in, out, n);
  return cudaGetLastError();
}

template <int DEPTH, int SPLIT, bool MANUAL_OUT>
cudaError_t launch_manual(const float* in, float* out, size_t n, cudaStream_t s) {
  auto kernel = manual_scale_kernel<DEPTH, SPLIT, MANUAL_OUT>;
  constexpr int smem = manual_smem(DEPTH, MANUAL_OUT);
  static std::atomic<int> cache[kCachedDevices];
  int blocks = 0;
  const cudaError_t err = resident_blocks(kernel, kManualThreads, smem, 0, &cache[0], blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kManualThreads, smem, s>>>(in, out, n);
  return cudaGetLastError();
}

// K10 / K11 over ``ranges`` ranges of n floats on a persistent grid of at
// most PER_SM blocks per SM (0: as many as fit).
template <int CHUNK, int STAGES, int AHEAD, int PER_SM>
cudaError_t launch_bulk(const float* in, float* out, size_t n, unsigned ranges, cudaStream_t s) {
  auto kernel = bulk_copy_kernel<CHUNK, STAGES, AHEAD>;
  constexpr int smem = STAGES * CHUNK;
  static std::atomic<int> cache[kCachedDevices];
  int blocks = 0;
  const cudaError_t err = resident_blocks(kernel, kBulkThreads, smem, PER_SM, &cache[0], blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kBulkThreads, smem, s>>>(in, out, n, ranges, (4 * n + CHUNK - 1) / CHUNK);
  return cudaGetLastError();
}

// The instantiations: K9's words per thread; K12's (depth, split, manual
// out) as a key 100 depth + 10 split + manual_out, dma_experiments.py's five.
constexpr bool has_vector(int per_thread) { return per_thread == 1 || per_thread == 4 || per_thread == 8; }
constexpr bool has_manual(int key) { return key == 211 || key == 310 || key == 210 || key == 240 || key == 311; }

}  // namespace xlb

extern "C" {

// K9: threads per block (a multiple of 32, 32..1024) and 16-byte words per
// thread (1, 4 or 8). Each returns the cudaError_t of the launch.
int xlb_copy_vector(const void* in, void* out, long long n, int threads, int per_thread, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(in);
  auto* y = static_cast<float*>(out);
  if (n < 1 || threads < 32 || threads > 1024 || threads % 32 || !xlb::shares_alignment(in, out))
    return cudaErrorInvalidValue;
  switch (per_thread) {
    case 1: return xlb::launch_vector<1>(x, y, size_t(n), threads, s);
    case 4: return xlb::launch_vector<4>(x, y, size_t(n), threads, s);
    case 8: return xlb::launch_vector<8>(x, y, size_t(n), threads, s);
    default: return cudaErrorInvalidValue;
  }
}

// K10 (ranges = 1) and K11 (ranges = q): ``ranges`` consecutive ranges of n
// floats each, every range its own chain of bulk copies.
int xlb_copy_bulk(const void* in, void* out, long long n, int ranges, void* stream) {
  if (n < 1 || ranges < 1 || ranges > 65535 || !xlb::shares_alignment(in, out)) return cudaErrorInvalidValue;
  return xlb::launch_bulk<xlb::kBulkChunk, xlb::kBulkStages, xlb::kBulkAhead, xlb::kBulkPerSm>(
      static_cast<const float*>(in), static_cast<float*>(out), size_t(n), unsigned(ranges),
      static_cast<cudaStream_t>(stream));
}

// The bulk copy's launch shape on the current device: resident blocks per
// SM and dynamic shared memory per block (the ring), in bytes.
int xlb_copy_bulk_shape(int* per_sm, int* smem) {
  *smem = xlb::kBulkStages * xlb::kBulkChunk;
  return xlb::blocks_per_sm(xlb::bulk_copy_kernel<xlb::kBulkChunk, xlb::kBulkStages, xlb::kBulkAhead>,
                            xlb::kBulkThreads, *smem, xlb::kBulkPerSm, *per_sm);
}

// K12: out = in * 1.0000001f through a ring of ``depth`` stages, each filled
// by ``n_split`` bulk loads; ``manual_out``: bulk stores from shared memory.
int xlb_copy_manual_scale(const void* in, void* out, long long n, int depth, int n_split, int manual_out,
                          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(in);
  auto* y = static_cast<float*>(out);
  if (n < 1 || !xlb::shares_alignment(in, out)) return cudaErrorInvalidValue;
  const size_t m = size_t(n);
  switch (depth * 100 + n_split * 10 + (manual_out ? 1 : 0)) {
    case 211: return xlb::launch_manual<2, 1, true>(x, y, m, s);   // B
    case 310: return xlb::launch_manual<3, 1, false>(x, y, m, s);  // C
    case 210: return xlb::launch_manual<2, 1, false>(x, y, m, s);  // C2
    case 240: return xlb::launch_manual<2, 4, false>(x, y, m, s);  // D
    case 311: return xlb::launch_manual<3, 1, true>(x, y, m, s);   // D2
    default: return cudaErrorInvalidValue;
  }
}

// 1 when the library holds the probe's variant: kernel 9 (a = words per
// thread), 10 / 11 (always), 12 (a = depth, b = n_split, c = manual_out).
int xlb_copy_has_variant(int kernel, int a, int b, int c) {
  switch (kernel) {
    case 9: return xlb::has_vector(a);
    case 10:
    case 11: return 1;
    case 12: return (c == 0 || c == 1) && xlb::has_manual(a * 100 + b * 10 + c);
    default: return 0;
  }
}

}  // extern "C"
