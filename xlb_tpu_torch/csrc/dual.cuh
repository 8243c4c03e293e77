// The scalar arithmetic of the per-voxel physics (collide_stream.cuh,
// mrt_projectors.cuh), templated on float or Dual.
#pragma once

#include <cuda_runtime.h>

namespace xlb {

// A float32 value with one forward-mode tangent. The adjoint kernel
// (adjoint_step.cuh) runs the voxel physics on it to take the columns of
// the physics' Jacobian; the forward runs the same templates on float.
struct Dual {
  float v, d;
  __device__ __forceinline__ Dual() : v(0.0f), d(0.0f) {}
  __device__ __forceinline__ Dual(float x) : v(x), d(0.0f) {}  // a constant
  __device__ __forceinline__ Dual(float x, float dx) : v(x), d(dx) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return Dual(a.v * b.v, a.d * b.v + a.v * b.d); }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float r = a.v / b.v;
  return Dual(r, (a.d - r * b.d) / b.v);
}

// The arithmetic of the templated physics: on float the intrinsics that
// nvcc never contracts into FMAs and the libm calls the forward always ran,
// on Dual their derivatives.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float sqrt_of(float a) { return sqrtf(a); }
__device__ __forceinline__ float pow_of(float a, float e) { return powf(a, e); }
__device__ __forceinline__ float clamp_of(float a, float lo, float hi) { return fminf(fmaxf(a, lo), hi); }

__device__ __forceinline__ Dual mul_rn(Dual a, Dual b) { return Dual(__fmul_rn(a.v, b.v), a.d * b.v + a.v * b.d); }
__device__ __forceinline__ Dual add_rn(Dual a, Dual b) { return Dual(__fadd_rn(a.v, b.v), a.d + b.d); }
__device__ __forceinline__ Dual sub_rn(Dual a, Dual b) { return Dual(__fsub_rn(a.v, b.v), a.d - b.d); }
__device__ __forceinline__ Dual sqrt_of(Dual a) {
  const float r = sqrtf(a.v);
  return Dual(r, a.d * (0.5f / r));
}
__device__ __forceinline__ Dual pow_of(Dual a, float e) { return Dual(powf(a.v, e), a.d * (e * powf(a.v, e - 1.0f))); }
// the derivative passes where lo <= a <= hi, as torch.clamp's
__device__ __forceinline__ Dual clamp_of(Dual a, float lo, float hi) {
  return a.v < lo ? Dual(lo) : (a.v > hi ? Dual(hi) : a);
}

}  // namespace xlb
