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

// store_kind: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of the launch.
int xlb_collide_stream_step(int store_kind, int shifted, const void* f, const void* mask, void* out, int X, int Y,
                            int Z, float omega, const XlbStepParams* params, void* stream) {
  const xlb::XlbLaunch a{xlb::XLB_KERNEL_STEP, store_kind, shifted, f, mask, out, X, Y, Z, 0, 0, 0, 0, omega, params,
                         static_cast<cudaStream_t>(stream)};
  return xlb::dispatch(a);
}

int xlb_collide_stream_kstep(int store_kind, int shifted, int steps, const void* f, const void* mask, void* out,
                             int X, int Y, int Z, int TX, int TY, int TZ, float omega, const XlbStepParams* params,
                             void* stream) {
  const xlb::XlbLaunch a{xlb::XLB_KERNEL_KSTEP, store_kind, shifted, f, mask, out, X, Y, Z, TX, TY, TZ, steps, omega,
                         params, static_cast<cudaStream_t>(stream)};
  return xlb::dispatch(a);
}

int xlb_collide_stream_blocked(int store_kind, int shifted, const void* f, const void* mask, void* out, int X, int Y,
                               int Z, int TX, int TY, int TZ, float omega, const XlbStepParams* params,
                               void* stream) {
  const xlb::XlbLaunch a{xlb::XLB_KERNEL_BLOCKED, store_kind, shifted, f, mask, out, X, Y, Z, TX, TY, TZ, 0, omega,
                         params, static_cast<cudaStream_t>(stream)};
  return xlb::dispatch(a);
}

// The adjoint of one step: store_kind and shifted describe the primal f;
// the cotangent g and the outputs df (q, X, Y, Z) and dom (X, Y, Z) are
// float32.
int xlb_collide_stream_adjoint(int store_kind, int shifted, const void* f, const void* g, const void* mask, void* df,
                               void* dom, int X, int Y, int Z, float omega, const XlbStepParams* params,
                               void* stream) {
  const xlb::XlbLaunch a{xlb::XLB_KERNEL_ADJOINT, store_kind, shifted, f, mask, df, X, Y, Z, 0, 0, 0, 0, omega,
                         params, static_cast<cudaStream_t>(stream), g, dom};
  return xlb::dispatch(a);
}

// 1 when the library holds the kernel of this configuration (kernel:
// 1 = step, 2 = k-step, 3 = blocked, 4 = adjoint).
int xlb_has_instantiation(int kernel, int q, int collision, int walled, int store_kind, int shifted) {
  return xlb::has_pair(q, collision) && xlb::has_form(kernel, walled, store_kind, shifted);
}

const char* xlb_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int xlb_params_size(void) { return int(sizeof(XlbStepParams)); }

int xlb_bc_size(void) { return int(sizeof(XlbBc)); }

}  // extern "C"
