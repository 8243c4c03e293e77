// Fused adjoint (backward) of the single 3D collide-stream step for Hopper
// (sm_90a): a member of the kernel family of collide_stream_3d.cuh, as a
// template over the stencil S (D3Q19, D3Q27), the collision C, the store
// dtype T of the primal, shifted storage, the EXT switch (kExtHalfway: the
// halfway epilogue; kExtOpen, kExtHybrid: the open boundaries and curved
// walls, below) and FORCE (the exact-difference body force). Instantiated
// per (stencil, collision) pair with the forward kernels -- the kExtOpen and
// kExtHybrid forms in sources of their own,
// collide_stream_*_{open,hybrid}_adjoint.cu -- and launched through
// collide_stream.cu's xlb_collide_stream_adjoint.
//
// adjoint_kernel, with adjoint_centred_kernel (its boundary and centred
// phases) and adjoint_staging_kernel after it where the scene needs them,
// replaces the TPU kernel xlb_tpu/kernels/adjoint_step.py::
// build_fused_adjoint_3d for every configuration the forward K1 takes:
// every collision, D3Q27, the body force, the streaming-step "equilibrium"
// and "halfway" BCs, the collision-step "fullway" BC, the solid keep-out,
// plain or shifted storage; and on D3Q19 BGK and D3Q27 KBC the open
// boundaries (3D Zou-He and regularized, do-nothing, free-slip, the
// extrapolation outflow and its staging, per-voxel prescriptions from the
// aux field) and the hybrid curved wall.
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
// kExtOpen and kExtHybrid (the branches of adjoint_centred_kernel under
// ext_reads_aux(EXT), adjoint_staging_kernel). The forward is out = Phi(fs,
// fp, st, w) with a third input, the outflow's staged reads st_m = f_m[y -
// t] (t = n + c_m tangential), and epilogues that mix fs and fp (Zou-He,
// the regularized closure, Tao's and Grad's hybrid closures). K8 splits by
// voxel class: ~99.7% of a flow past a sphere's voxels are solid,
// fullway, "equilibrium" or fluid with no epilogue, where the streamed
// populations reduce to the walled form's, so adjoint_kernel runs there as
// the walled form does (the bulk), with no epilogue code compiled in; a
// kernel's registers and local frame are set by its heaviest path, and the
// forward-mode transposes below need many (on the H100 the unsplit open
// form's adjoint_kernel ran at 2.4x the walled one's time on the same
// grid). The voxels of an epilogue BC take a launch of their own, the
// boundary phase of adjoint_centred_kernel. Per such voxel y:
// - the collision's VJP (as above) gives h_post, the cotangent of the
//   post-epilogue populations; at an outflow voxel the staged slots l =
//   opp(m) are overwritten after the collision (out_l := cs st_m + (1 - cs)
//   fs_m), so their g_l leaves the collision's cotangent and adds
//   (1 - cs) g_l to h_post_m (open_post_vjp); unforced BGK still takes the
//   hand-derived transpose (the open forms compile the force, and apply it
//   only when the scene has one);
// - the epilogues' transpose takes h_post back to the pulled fs and the
//   centred fp in forward mode: streamed_populations, the forward's own
//   template, on Dual numbers, one pass per input (epilogue_vjp) -- q passes
//   at BC voxels for fs, q more for fp, and none at the other voxels. The
//   aux field enters as a constant (prescriptions carry no gradient);
// - ownership: the h_fs terms are pushed by y's thread as above, in the
//   boundary phase; the h_fp and staged terms belong to entries of other
//   threads, so the centred phase (adjoint_centred_kernel, after the bulk
//   and the boundary phase have written every push) adds h_fp(x) at every
//   voxel x of an fp-reading epilogue, and a last launch
//   (adjoint_staging_kernel, for scenes with an outflow) gathers the staged
//   cotangents cs g_opp(m)(x + t) from the outflow voxels that read f_m[x]
//   -- two outflow faces may stage from one x with different t, and a
//   gather adds both without atomics, so two calls agree bit for bit.
//
// Push side: df_m[x] gathers h_fs_m from y = x + c_m, so the thread of
// voxel y writes h_fs_m(y) to df_m[y - c_m] (periodic wrap). Each (m, x)
// has exactly one writer and no atomics are needed. The solid term
// h_fp_m[x] = g_m[x] is folded into that write: when has_solids, the
// writing thread reads the mask of x (a cache hit mostly) and adds g_m[x]
// where x is solid. The halfway term h_fp_opp(l)[x] += h_l(x) has another
// owner, so a later launch (adjoint_centred_kernel, only for scenes with
// an epilogue that reads centred populations) recomputes h at those
// voxels and adds it in place; its threads touch only their own voxel's
// entries. In the split forms the bulk and the boundary phase each push
// from the voxels of their class, so each (m, x) still has one writer.
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

// ---- the kExtOpen and kExtHybrid epilogues' transpose ----------------------

// The aux field's entries of one voxel (kExtOpen, kExtHybrid).
struct AuxAt {
  const float* aux;
  size_t plane, v;
  __device__ __forceinline__ float operator()(int ch) const { return aux[ch * plane + v]; }
};

// The BC whose streaming-step epilogue runs at cell type bc (halfway,
// zouhe, regularized, do-nothing, free-slip, outflow, hybrid), or -1.
__device__ __forceinline__ int epilogue_bc(int bc, const XlbStepParams& p) {
  for (int b = 0; b < p.n_bc; ++b)
    if (bc == p.bc_id[b] && p.bc_kind[b] >= XLB_BC_HALFWAY) return b;
  return -1;
}

// Whether the streaming-step epilogue of BC b reads centred populations
// (every one but Zou-He's and the regularized closure's; the outflow's
// also stages). The host asks it too, to launch the second kernel.
__host__ __device__ __forceinline__ bool reads_centred(const XlbStepParams& p, int b) {
  return p.bc_kind[b] >= XLB_BC_HALFWAY && p.bc_kind[b] != XLB_BC_ZOUHE && p.bc_kind[b] != XLB_BC_REGULARIZED;
}

// The offset t = n + c_m of outflow BC b's staged read of direction m, and
// whether it is within reach (|t_a| <= 1), as outflow_staging tests it.
template <class S>
__device__ __forceinline__ bool staging_offset(const XlbStepParams& p, int b, int m, int& tx, int& ty, int& tz) {
  tx = int(p.bc[b].vec[0]) + S::c(0, m);
  ty = int(p.bc[b].vec[1]) + S::c(1, m);
  tz = int(p.bc[b].vec[2]) + S::c(2, m);
  return tx >= -1 && tx <= 1 && ty >= -1 && ty <= 1 && tz >= -1 && tz <= 1;
}

// Whether outflow BC b stages missing direction m into the outgoing slot
// opp(m) at a voxel of mask word packed.
template <class S>
__device__ __forceinline__ bool staged_slot(int packed, const XlbStepParams& p, int b, int m) {
  int tx, ty, tz;
  return missing_bit(packed, m) && staging_offset<S>(p, b, m, tx, ty, tz);
}

// At a voxel that is neither solid nor fullway, of epilogue BC b (or -1):
// h = the cotangent of the post-epilogue populations fs, and dom. An
// outflow voxel's staged slots l = opp(m) leave the collision's output
// (out[l] := cs f_m[x - t] + (1 - cs) fs[m]), so their g goes to fs[m] with
// (1 - cs) and not through the collision. BGK without a force in the
// scene by the hand-derived transpose, every other case in forward mode.
template <class S, class C, bool FORCE>
__device__ __forceinline__ void open_post_vjp(const float fs[S::q], const float g[S::q], int packed, int b, float omega,
                                              const XlbStepParams& p, float h[S::q], float& dom) {
  const bool outflow = b >= 0 && p.bc_kind[b] == XLB_BC_OUTFLOW;
  float gc[S::q];
#pragma unroll
  for (int m = 0; m < S::q; ++m) gc[S::opp(m)] = outflow && staged_slot<S>(packed, p, b, m) ? 0.0f : g[S::opp(m)];
  // physics_vjp is not inlined: its arguments are copies, so that fs, gc
  // and h need not live in local memory where the hand transpose runs
  auto forward_mode = [&]() {
    float fs_c[S::q], g_c[S::q], h_c[S::q], dom_c;
#pragma unroll
    for (int l = 0; l < S::q; ++l) fs_c[l] = fs[l], g_c[l] = gc[l];
    physics_vjp<S, C, FORCE>(fs_c, g_c, omega, p, h_c, &dom_c);
#pragma unroll
    for (int l = 0; l < S::q; ++l) h[l] = h_c[l];
    dom = dom_c;
  };
  if constexpr (std::is_same<C, CollBGK>::value) {
    if (!(FORCE && p.has_force)) bgk_vjp<S>(fs, gc, omega, p, h, dom);
    else forward_mode();
  } else {
    forward_mode();
  }
  if (outflow) {
    const float cs1 = 1.0f - p.bc[b].vec[3];
#pragma unroll
    for (int m = 0; m < S::q; ++m)
      if (staged_slot<S>(packed, p, b, m)) h[m] += cs1 * g[S::opp(m)];
  }
}

// The selection epilogues -- halfway (plus its constant or per-voxel wall
// term), the outflow, do-nothing and free-slip -- set each post-epilogue
// population to one pulled or one centred population plus a constant, so
// their transpose is a selection too, taken here by hand rather than by
// 2q forward-mode passes: walls are the most common BC, and a wall at a
// z face puts a BC voxel in one warp of every few. The tests below follow
// open_halfway_epilogue, free_slip_epilogue and open_epilogue's outflow
// and do-nothing branches.
__device__ __forceinline__ bool is_selection(int kind) {
  return kind == XLB_BC_HALFWAY || kind == XLB_BC_OUTFLOW || kind == XLB_BC_DO_NOTHING || kind == XLB_BC_FREE_SLIP;
}

// The free-slip BC b's normal axis and outward sign.
__device__ __forceinline__ void free_slip_axis(const XlbStepParams& p, int b, int& axis, int& sign) {
  const int n0 = int(p.bc[b].vec[0]), n1 = int(p.bc[b].vec[1]), n2 = int(p.bc[b].vec[2]);
  axis = n0 != 0 ? 0 : (n1 != 0 ? 1 : 2);
  sign = n0 + n1 + n2;
}

// h[A-mirror of l] += h_post[l] for each l that free-slip BC takes from
// the centred mirror across the wall normal to axis A; with CLEAR, h_post
// is h itself and those l are zeroed instead (the pulled side).
template <class S, int A, bool CLEAR>
__device__ __forceinline__ void free_slip_vjp(int packed, int sign, const float h_post[S::q], float h[S::q]) {
#pragma unroll
  for (int l = 0; l < S::q; ++l) {
    if (!missing_bit(packed, l) || S::c(A, l) != -sign) continue;
    if constexpr (CLEAR) h[l] = 0.0f;
    else h[mirror_dir<S>(A, l)] += h_post[l];
  }
}

// The pulled side of a selection epilogue's transpose, in place: h (the
// post-epilogue cotangent on entry) keeps h_l where population l was the
// pulled one, and 0 where it was a centred one.
template <class S>
__device__ __forceinline__ void selection_pulled_vjp(int packed, const XlbStepParams& p, int b, float h[S::q]) {
  const int kind = p.bc_kind[b];
  if (kind == XLB_BC_DO_NOTHING) {
#pragma unroll
    for (int l = 0; l < S::q; ++l) h[l] = 0.0f;
  } else if (kind == XLB_BC_FREE_SLIP) {
    int axis, sign;
    free_slip_axis(p, b, axis, sign);
    if (axis == 0) free_slip_vjp<S, 0, true>(packed, sign, h, h);
    else if (axis == 1) free_slip_vjp<S, 1, true>(packed, sign, h, h);
    else free_slip_vjp<S, 2, true>(packed, sign, h, h);
  } else {  // halfway, outflow: a missing l took the centred opp(l)
#pragma unroll
    for (int l = 0; l < S::q; ++l)
      if (missing_bit(packed, l)) h[l] = 0.0f;
  }
}

// The centred side: acc_k += h_post_l for each l that took the centred k.
template <class S>
__device__ __forceinline__ void selection_centred_vjp(int packed, const XlbStepParams& p, int b,
                                                      const float h_post[S::q], float acc[S::q]) {
  const int kind = p.bc_kind[b];
  if (kind == XLB_BC_DO_NOTHING) {
#pragma unroll
    for (int l = 0; l < S::q; ++l) acc[l] += h_post[l];
  } else if (kind == XLB_BC_FREE_SLIP) {
    int axis, sign;
    free_slip_axis(p, b, axis, sign);
    if (axis == 0) free_slip_vjp<S, 0, false>(packed, sign, h_post, acc);
    else if (axis == 1) free_slip_vjp<S, 1, false>(packed, sign, h_post, acc);
    else free_slip_vjp<S, 2, false>(packed, sign, h_post, acc);
  } else {
#pragma unroll
    for (int l = 0; l < S::q; ++l)
      if (missing_bit(packed, l)) acc[S::opp(l)] += h_post[l];
  }
}

// The transpose of the streaming-step epilogues at one voxel:
// h_in[j - first] = sum_l h_post[l] d fs_l / d input_j for first <= j <
// last, input j < q the pulled population j and q + j the centred j (both
// store-form reads as f32), in forward mode: streamed_populations on Dual
// numbers, one pass per input. Not inlined, so the passes share one copy of
// the epilogues.
template <class S, bool SHIFTED, int EXT>
__device__ __noinline__ void epilogue_vjp(const float* pulled, const float* centre, int packed, const XlbStepParams& p,
                                          AuxAt aux, const float* h_post, int first, int last, float* h_in) {
#pragma unroll 1
  for (int j = first; j < last; ++j) {
    auto pull = [&](int l) { return Dual(pulled[l], l == j ? 1.0f : 0.0f); };
    auto center = [&](int l) { return Dual(centre[l], l + S::q == j ? 1.0f : 0.0f); };
    Dual fs[S::q];
    streamed_populations<S, SHIFTED, EXT>(pull, center, packed, p, fs, aux);
    float acc = 0.0f;
#pragma unroll
    for (int l = 0; l < S::q; ++l) acc += h_post[l] * fs[l].d;
    h_in[j - first] = acc;
  }
}

// The pushes of one voxel: df_m[neighbour(m)] = h_m, plus the solid
// keep-out term g_m there where that voxel is solid; neighbour(m) is the
// voxel's pull source of direction m, its push target (periodic wrap).
// Each (m, x) has one pushing voxel, x + c_m.
template <class S, typename Neighbour>
__device__ __forceinline__ void push_cotangents(const float h[S::q], const float* __restrict__ g,
                                                const int* __restrict__ mask, float* __restrict__ df, size_t plane,
                                                const XlbStepParams& p, const Neighbour& neighbour) {
#pragma unroll
  for (int m = 0; m < S::q; ++m) {
    const size_t t = neighbour(m);
    float d = h[m];
    if (p.has_solids && cell_type<S>(mask[t]) == S::solid_id) d += g[m * plane + t];
    df[m * plane + t] = d;
  }
}

// K8's first launch. The thread of voxel y writes df_m[y - c_m] = h_fs_m(y)
// (+ g_m there when solid, push_cotangents) and dom(y). In the kExtOpen and
// kExtHybrid forms it is the bulk: it returns at the voxels of an epilogue
// BC, whose pushes and dom the boundary launch writes (adjoint_centred_kernel
// with BOUNDARY), and runs the walled form's path everywhere else -- the
// solid, fullway and "equilibrium" voxels and the fluid with no epilogue,
// where the open form's populations reduce to the walled form's -- with
// none of the epilogues' transposes compiled in. Its FORCE follows the
// scene's force (launch_ext_adjoint_impl).
template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE>
__global__ void __launch_bounds__(kAdjointThreads)
    adjoint_kernel(const T* __restrict__ f, const float* __restrict__ g, const int* __restrict__ mask,
                   const float* __restrict__ aux, float* __restrict__ df, float* __restrict__ dom, int X, int Y, int Z,
                   float omega, const __grid_constant__ XlbStepParams p) {
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
  if constexpr (ext_reads_aux(EXT)) {
    if (epilogue_bc(bc, p) >= 0) return;  // the boundary launch's voxel
  }
  float fs[S::q];
  const bool fixed = streamed_populations<S, SHIFTED, ext_reads_aux(EXT) ? kExtNone : EXT>(pull, center, packed, p, fs);

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
    if constexpr (EXT == kExtHalfway) {
      if (has_bc_kind(bc, p, XLB_BC_HALFWAY)) {
#pragma unroll
        for (int m = 0; m < S::q; ++m)
          if (missing_bit(packed, m)) h[m] = 0.0f;  // a centred population's: adjoint_centred_kernel
      }
    }
  }
  if (fixed) {
#pragma unroll
    for (int m = 0; m < S::q; ++m) h[m] = 0.0f;
  }
  push_cotangents<S>(h, g, mask, df, plane, p, neighbour);
  dom[v] = d_omega;
}

// The epilogue launches' scan in the kExtOpen and kExtHybrid forms: a block
// reads the mask of kEpilogueScan chunks of kAdjointThreads voxels, one
// voxel of each per thread, lists those of its phase in shared memory, in
// voxel order, and its threads then take the list in turn, so that warps
// run the epilogues' transposes with every lane busy. One thread per
// voxel, as the walled form's centred launch has, leaves a warp with one
// wall voxel to run them for one lane, and a block that exits on the mask
// costs a read's latency. Chunk k of block b is chunk k G + b of the grid
// (G blocks): a face that is BC voxels end to end spans consecutive
// chunks, so its voxels spread over as many blocks, one per thread, where
// contiguous tiles would queue kEpilogueScan of them on each thread of a
// few blocks.
constexpr int kEpilogueScan = 8;
constexpr int kEpilogueTile = kAdjointThreads * kEpilogueScan;

// Lists the voxels v of this block's chunks whose cell type has an
// epilogue BC (BOUNDARY: any; else one that reads centred populations)
// into list, in voxel order, and returns their number; warp_count holds
// kEpilogueScan x the block's warps, count one word, all in shared memory.
// The offsets come from ballots and one prefix sum, so the list is the
// same on every call.
template <class S, bool BOUNDARY>
__device__ __forceinline__ unsigned epilogue_voxels(const int* __restrict__ mask, unsigned n, const XlbStepParams& p,
                                                    unsigned* list, unsigned* warp_count, unsigned* count) {
  constexpr int kWarps = kAdjointThreads / 32;
  const unsigned lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  auto voxel = [&](int k) { return (k * gridDim.x + blockIdx.x) * unsigned(kAdjointThreads) + threadIdx.x; };
  int packed[kEpilogueScan];
#pragma unroll
  for (int k = 0; k < kEpilogueScan; ++k) packed[k] = voxel(k) < n ? mask[voxel(k)] : 0;
  unsigned ballot[kEpilogueScan];
#pragma unroll
  for (int k = 0; k < kEpilogueScan; ++k) {
    const int b = epilogue_bc(cell_type<S>(packed[k]), p);
    const bool in = voxel(k) < n && b >= 0 && (BOUNDARY || reads_centred(p, b));
    ballot[k] = __ballot_sync(0xffffffffu, in);
    if (lane == 0) warp_count[k * kWarps + warp] = __popc(ballot[k]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // exclusive prefix sum in voxel order: k, then warp
    unsigned sum = 0;
    for (int i = 0; i < kEpilogueScan * kWarps; ++i) {
      const unsigned c = warp_count[i];
      warp_count[i] = sum;
      sum += c;
    }
    *count = sum;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kEpilogueScan; ++k)
    if ((ballot[k] >> lane) & 1u) list[warp_count[k * kWarps + warp] + __popc(ballot[k] & below)] = voxel(k);
  __syncthreads();
  return *count;
}

// One voxel v of an epilogue BC b in the kExtOpen and kExtHybrid forms:
// with BOUNDARY its pushes and dom (the boundary phase), else its centred
// term (the centred phase), as adjoint_centred_kernel says.
template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE, bool BOUNDARY>
__device__ __forceinline__ void epilogue_voxel_vjp(unsigned v, const T* __restrict__ f, const float* __restrict__ g,
                                                   const int* __restrict__ mask, const float* __restrict__ aux,
                                                   float* __restrict__ df, float* __restrict__ dom, int X, int Y,
                                                   int Z, float omega, const XlbStepParams& p) {
  const size_t plane = size_t(X) * Y * Z;
  const int packed = mask[v];
  const int b = epilogue_bc(cell_type<S>(packed), p);
  const int z = int(v % unsigned(Z));
  const unsigned xy = v / unsigned(Z);
  const int y = int(xy % unsigned(Y));
  const int x = int(xy / unsigned(Y));
  auto neighbour = [&](int l) {
    const int xs = wrap1(x - S::c(0, l), X);
    const int ys = wrap1(y - S::c(1, l), Y);
    const int zs = wrap1(z - S::c(2, l), Z);
    return (size_t(xs) * Y + ys) * Z + zs;
  };
  auto pull = [&](int l) { return to_f32(f[l * plane + neighbour(l)]); };
  auto center = [&](int l) { return to_f32(f[l * plane + v]); };
  const AuxAt aux_at{aux, plane, v};
  float fs[S::q], gv[S::q], h[S::q], d_omega;
  [[maybe_unused]] const bool fixed = streamed_populations<S, SHIFTED, EXT>(pull, center, packed, p, fs, aux_at);
#pragma unroll
  for (int l = 0; l < S::q; ++l) gv[l] = g[l * plane + v];
  open_post_vjp<S, C, FORCE>(fs, gv, packed, b, omega, p, h, d_omega);
  if constexpr (BOUNDARY) {
    if (fixed) {
#pragma unroll
      for (int m = 0; m < S::q; ++m) h[m] = 0.0f;
    } else if (is_selection(p.bc_kind[b])) {
      selection_pulled_vjp<S>(packed, p, b, h);
    } else {
      // copies for the call, so that h itself need not live in local memory
      float fr[S::q], fc[S::q], hp[S::q], hin[S::q];
#pragma unroll
      for (int l = 0; l < S::q; ++l) fr[l] = pull(l), fc[l] = center(l), hp[l] = h[l];
      epilogue_vjp<S, SHIFTED, EXT>(fr, fc, packed, p, aux_at, hp, 0, S::q, hin);
#pragma unroll
      for (int m = 0; m < S::q; ++m) h[m] = hin[m];
    }
    push_cotangents<S>(h, g, mask, df, plane, p, neighbour);
    dom[v] = d_omega;
  } else {
    float acc[S::q];
#pragma unroll
    for (int l = 0; l < S::q; ++l) acc[l] = 0.0f;
    if (is_selection(p.bc_kind[b])) {
      selection_centred_vjp<S>(packed, p, b, h, acc);
    } else {
      float fr[S::q], fc[S::q], hp[S::q];
#pragma unroll
      for (int l = 0; l < S::q; ++l) fr[l] = pull(l), fc[l] = center(l), hp[l] = h[l];
      epilogue_vjp<S, SHIFTED, EXT>(fr, fc, packed, p, aux_at, hp, S::q, 2 * S::q, acc);
    }
#pragma unroll
    for (int m = 0; m < S::q; ++m) df[m * plane + v] += acc[m];
  }
}

// K8's launch at the voxels of the epilogues, in two phases. With
// BOUNDARY (the kExtOpen and kExtHybrid forms' boundary launch, before
// the centred phase): at each voxel y of an epilogue BC, the cotangent of
// the post-epilogue populations (open_post_vjp) goes back to the pulled
// populations through the epilogues' transpose (selection_pulled_vjp, or
// epilogue_vjp), the aux field a constant (prescriptions carry no
// gradient); the thread writes y's pushes and dom, as adjoint_kernel does
// at the other voxels. Without it, after the pushes of every voxel: for
// scenes with an epilogue that reads centred populations (reads_centred:
// halfway, and in the kExtOpen and kExtHybrid forms do-nothing, free-slip,
// the outflow and the hybrid wall), at such a voxel x, df_m[x] +=
// h_fp_m(x), recomputed as in the boundary phase. The halfway epilogue's
// transpose is a selection (a missing l took the centred opp(l):
// df_opp(l)[x] += h_l(x)); the open epilogues go through
// selection_centred_vjp, or epilogue_vjp with the centred inputs seeded.
// This phase's thread x touches only voxel x's entries of df, as the
// third launch's (adjoint_staging_kernel), so no two threads write one
// entry and no atomics are needed. The kExtOpen and kExtHybrid forms take
// kEpilogueScan chunks of voxels per block (epilogue_voxels), the walled
// form one voxel per thread. The two phases share one template so that
// every K8 launch is one of three kernel names.
template <class S, class C, typename T, bool SHIFTED, int EXT, bool FORCE, bool BOUNDARY>
__global__ void __launch_bounds__(kAdjointThreads)
    adjoint_centred_kernel(const T* __restrict__ f, const float* __restrict__ g, const int* __restrict__ mask,
                           const float* __restrict__ aux, float* __restrict__ df, float* __restrict__ dom, int X, int Y,
                           int Z, float omega, const __grid_constant__ XlbStepParams p) {
  static_assert(!BOUNDARY || ext_reads_aux(EXT), "the boundary phase is the kExtOpen and kExtHybrid forms'");
  const unsigned n = unsigned(X) * unsigned(Y) * unsigned(Z);
  if constexpr (ext_reads_aux(EXT)) {
    __shared__ unsigned list[kEpilogueTile], warp_count[kEpilogueTile / 32], count;
    const unsigned listed = epilogue_voxels<S, BOUNDARY>(mask, n, p, list, warp_count, &count);
    for (unsigned i = threadIdx.x; i < listed; i += kAdjointThreads)
      epilogue_voxel_vjp<S, C, T, SHIFTED, EXT, FORCE, BOUNDARY>(list[i], f, g, mask, aux, df, dom, X, Y, Z, omega, p);
  } else {
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
    streamed_populations<S, SHIFTED, EXT>(pull, center, packed, p, fs);
#pragma unroll
    for (int l = 0; l < S::q; ++l) gv[l] = g[l * plane + v];
    voxel_vjp<S, C, FORCE>(fs, gv, omega, p, h, d_omega);
#pragma unroll
    for (int l = 0; l < S::q; ++l)
      if (missing_bit(packed, l)) df[S::opp(l) * plane + v] += h[l];
  }
}

// The third launch, for scenes with an outflow: the staged term, a
// gather. The outflow voxel y = x + t that stages missing m from x (t =
// n + c_m) read f_m[x] with weight cs into its slot opp(m), so df_m[x] +=
// cs g_opp(m)(y). Two outflow faces may stage from one x with different t;
// each is gathered here in turn. A kernel of its own: it needs few
// registers, where the recompute of the second launch needs many.
template <class S>
__global__ void __launch_bounds__(kAdjointThreads)
    adjoint_staging_kernel(const float* __restrict__ g, const int* __restrict__ mask, float* __restrict__ df, int X,
                           int Y, int Z, const __grid_constant__ XlbStepParams p) {
  const unsigned n = unsigned(X) * unsigned(Y) * unsigned(Z);
  const unsigned v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int z = int(v % unsigned(Z));
  const unsigned xy = v / unsigned(Z);
  const int y = int(xy % unsigned(Y));
  const int x = int(xy / unsigned(Y));
  const size_t plane = n;
  for (int ob = 0; ob < p.n_bc; ++ob) {
    if (p.bc_kind[ob] != XLB_BC_OUTFLOW) continue;
    const float cs = p.bc[ob].vec[3];
#pragma unroll
    for (int m = 0; m < S::q; ++m) {
      int tx, ty, tz;
      if (!staging_offset<S>(p, ob, m, tx, ty, tz)) continue;
      const size_t u = (size_t(wrap1(x + tx, X)) * Y + wrap1(y + ty, Y)) * Z + wrap1(z + tz, Z);
      const int pk = mask[u];
      if (cell_type<S>(pk) != p.bc_id[ob] || !missing_bit(pk, m)) continue;
      df[m * plane + v] += cs * g[S::opp(m) * plane + u];
    }
  }
}

}  // namespace xlb
