// K1's field modes on D3Q19 BGK: the advection-diffusion step (walled and kExtOpen forms) and
// the per-voxel force (walled, kExtOpen and kExtHybrid forms), f32 and bf16 storage (field_step_kernel; the
// table has_field of collide_stream.cuh), in a source of their own so that
// the build compiles them beside the pair's other kernels.
#include "collide_stream_3d.cuh"

namespace xlb {

XLB_INSTANTIATE_FIELD(D3Q19, CollBGK)

}  // namespace xlb
