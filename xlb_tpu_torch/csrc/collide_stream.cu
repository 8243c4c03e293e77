// The C launchers of the fused 3D collide-stream kernels (K1 step_kernel,
// K2 kstep_kernel, K0 blocked_kernel and the adjoint K8 adjoint_kernel of
// collide_stream_3d.cuh, collide_stream_blocked.cuh and adjoint_step.cuh),
// bound to Python through ctypes
// (xlb_tpu_torch/kernels/_cuda.py), and the D3Q19 BGK instantiations.
//
// Each launcher packs its arguments into an XlbLaunch and dispatches on the
// launch parameters' stencil (p.q) and collision (p.collision) to the
// (stencil, collision) pair's instantiations, which live one pair per
// source (collide_stream_d3q19_*.cu, collide_stream_d3q27_*.cu) so that
// the build compiles them in parallel. A configuration outside the
// instantiation table (has_form) returns cudaErrorInvalidValue;
// xlb_has_instantiation lets the wrappers refuse it first, naming it.
#include <cuda_runtime.h>

#include "collide_stream_3d.cuh"

namespace xlb {

XLB_INSTANTIATE_PAIR(D3Q19, CollBGK)

// launch_pair of the other sources
template <>
cudaError_t launch_pair<D3Q19, CollSmagorinsky>(const XlbLaunch& a);
template <>
cudaError_t launch_pair<D3Q19, CollTRT>(const XlbLaunch& a);
template <>
cudaError_t launch_pair<D3Q19, CollMRT>(const XlbLaunch& a);
template <>
cudaError_t launch_pair<D3Q19, CollPowerLaw>(const XlbLaunch& a);
template <>
cudaError_t launch_pair<D3Q27, CollBGK>(const XlbLaunch& a);
template <>
cudaError_t launch_pair<D3Q27, CollKBC>(const XlbLaunch& a);

// the field modes of K1 (collide_stream_*_field.cu)
template <>
cudaError_t launch_field<D3Q19, CollBGK>(const XlbLaunch& a);
template <>
cudaError_t launch_field<D3Q27, CollKBC>(const XlbLaunch& a);

// Whether the library holds a (stencil, collision) pair.
constexpr bool has_pair(int q, int collision) {
  return (q == 19 && collision != XLB_COLL_KBC && collision >= XLB_COLL_BGK && collision <= XLB_COLL_POWERLAW) ||
         (q == 27 && (collision == XLB_COLL_BGK || collision == XLB_COLL_KBC));
}

cudaError_t dispatch(const XlbLaunch& a) {
  const XlbStepParams& p = *a.p;
  if (p.q == 19) {
    switch (p.collision) {
      case XLB_COLL_BGK: return launch_pair<D3Q19, CollBGK>(a);
      case XLB_COLL_SMAGORINSKY: return launch_pair<D3Q19, CollSmagorinsky>(a);
      case XLB_COLL_TRT: return launch_pair<D3Q19, CollTRT>(a);
      case XLB_COLL_MRT: return launch_pair<D3Q19, CollMRT>(a);
      case XLB_COLL_POWERLAW: return launch_pair<D3Q19, CollPowerLaw>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (p.q == 27) {
    switch (p.collision) {
      case XLB_COLL_BGK: return launch_pair<D3Q27, CollBGK>(a);
      case XLB_COLL_KBC: return launch_pair<D3Q27, CollKBC>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace xlb

extern "C" {

// store_kind: 0 = float32, 1 = bfloat16; aux: the (nchan, X, Y, Z) float32
// aux field of the BCs' per-voxel prescriptions, or null. Each returns the
// cudaError_t of the launch.
int xlb_collide_stream_step(int store_kind, int shifted, const void* f, const void* mask, void* out, int X, int Y,
                            int Z, float omega, const void* aux, const XlbStepParams* params, void* stream) {
  const xlb::XlbLaunch a{xlb::XLB_KERNEL_STEP, store_kind, shifted, f, mask, out, X, Y, Z, 0, 0, 0, 0, omega, params,
                         static_cast<cudaStream_t>(stream), nullptr, nullptr, static_cast<const float*>(aux)};
  return xlb::dispatch(a);
}

// The k-step kernel on (TY, TZ) columns marching over segments of seg
// planes of x.
int xlb_collide_stream_kstep(int store_kind, int shifted, int steps, const void* f, const void* mask, void* out,
                             int X, int Y, int Z, int seg, int TY, int TZ, float omega, const void* aux,
                             const XlbStepParams* params, void* stream) {
  xlb::XlbLaunch a{xlb::XLB_KERNEL_KSTEP, store_kind, shifted, f, mask, out, X, Y, Z, 0, TY, TZ, steps, omega,
                   params, static_cast<cudaStream_t>(stream), nullptr, nullptr, static_cast<const float*>(aux)};
  a.seg = seg;
  return xlb::dispatch(a);
}

// The launch shape of that kernel's configuration, without a launch:
// shape[0] resident blocks per SM, shape[1] registers per thread,
// shape[2] local-memory (spill) bytes per thread.
int xlb_collide_stream_kstep_shape(int store_kind, int shifted, int steps, int TY, int TZ,
                                   const XlbStepParams* params, int* shape) {
  xlb::XlbLaunch a{xlb::XLB_KERNEL_KSTEP, store_kind, shifted, nullptr, nullptr, nullptr, 1, 1, 1, 0, TY, TZ, steps,
                   0.0f, params, nullptr};
  a.seg = 1;
  a.shape = shape;
  return xlb::dispatch(a);
}

int xlb_collide_stream_blocked(int store_kind, int shifted, const void* f, const void* mask, void* out, int X, int Y,
                               int Z, int TX, int TY, int TZ, float omega, const void* aux,
                               const XlbStepParams* params, void* stream) {
  const xlb::XlbLaunch a{xlb::XLB_KERNEL_BLOCKED, store_kind, shifted, f, mask, out, X, Y, Z, TX, TY, TZ, 0, omega,
                         params, static_cast<cudaStream_t>(stream), nullptr, nullptr, static_cast<const float*>(aux)};
  return xlb::dispatch(a);
}

// The adjoint of one step: store_kind and shifted describe the primal f;
// the cotangent g and the outputs df (q, X, Y, Z) and dom (X, Y, Z) are
// float32; aux as the forward's (read as a constant), or null.
int xlb_collide_stream_adjoint(int store_kind, int shifted, const void* f, const void* g, const void* mask, void* df,
                               void* dom, int X, int Y, int Z, float omega, const void* aux,
                               const XlbStepParams* params, void* stream) {
  const xlb::XlbLaunch a{xlb::XLB_KERNEL_ADJOINT, store_kind, shifted, f, mask, df, X, Y, Z, 0, 0, 0, 0, omega,
                         params, static_cast<cudaStream_t>(stream), g, dom, static_cast<const float*>(aux)};
  return xlb::dispatch(a);
}

// The launch shapes of the adjoint's kernels for this configuration,
// without a launch: for each of K8's kAdjointLaunches kernels in launch
// order, shape[3 i .. 3 i + 2] := resident blocks per SM, registers per
// thread, local-memory bytes per thread (zeros where the form has none).
int xlb_collide_stream_adjoint_shape(int store_kind, int shifted, const XlbStepParams* params, int* shape) {
  xlb::XlbLaunch a{xlb::XLB_KERNEL_ADJOINT, store_kind, shifted, nullptr, nullptr, nullptr, 1, 1, 1, 0, 0, 0, 0,
                   0.0f, params, nullptr};
  a.shape = shape;
  return xlb::dispatch(a);
}

// 1 when the library holds the kernel of this configuration (kernel:
// 1 = step, 2 = k-step, 3 = blocked, 4 = adjoint; walled: 0, 1, 2 for
// the open-boundary epilogues, or 3 for those and the hybrid curved wall).
int xlb_has_instantiation(int kernel, int q, int collision, int walled, int store_kind, int shifted) {
  return xlb::has_pair(q, collision) && xlb::has_form(kernel, walled, store_kind, shifted) &&
         (walled < 2 || xlb::has_open(q, collision));
}

// K1's field modes: field 1 (the advection-diffusion step) or 2 (a
// per-voxel force); aux holds the field's d channels, then the BCs'; the
// form is the params' walled code. Unshifted f32 (store_kind 0) or bf16 (1).
int xlb_collide_stream_field_step(int field, int store_kind, const void* f, const void* mask, void* out, int X, int Y,
                                  int Z, float omega, const void* aux, const XlbStepParams* params, void* stream) {
  const XlbStepParams& p = *params;
  if (store_kind < 0 || store_kind > 1 || aux == nullptr || !xlb::has_field(field, p.q, p.collision, p.walled))
    return cudaErrorInvalidValue;
  const xlb::XlbLaunch a{xlb::XLB_KERNEL_STEP, store_kind, 0, f, mask, out, X, Y, Z, 0, 0, 0, 0, omega, params,
                         static_cast<cudaStream_t>(stream), nullptr, nullptr, static_cast<const float*>(aux), field};
  if (p.q == 19 && p.collision == XLB_COLL_BGK) return xlb::launch_field<xlb::D3Q19, xlb::CollBGK>(a);
  if (p.q == 27 && p.collision == XLB_COLL_KBC) return xlb::launch_field<xlb::D3Q27, xlb::CollKBC>(a);
  return cudaErrorInvalidValue;
}

const char* xlb_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int xlb_params_size(void) { return int(sizeof(XlbStepParams)); }

int xlb_bc_size(void) { return int(sizeof(XlbBc)); }

}  // extern "C"
