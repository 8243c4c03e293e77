// The D3Q27 KBC kExtHybrid instantiations of the fused 3D kernels (K1, K2,
// K0 with the open-boundary epilogues and the hybrid curved wall, the aux
// field and the outflow's staging; the table of collide_stream_3d.cuh), in
// a source of their own so that the build compiles them beside the pair's
// other kernels.
#include "collide_stream_3d.cuh"

namespace xlb {

XLB_INSTANTIATE_HYBRID(D3Q27, CollKBC)

}  // namespace xlb
