// The D3Q19 Smagorinsky LES BGK instantiations of the fused 3D kernels (K1, K2, K0; the
// table of collide_stream_3d.cuh), one (stencil, collision) pair per source
// so that the build compiles the pairs in parallel.
#include "collide_stream_3d.cuh"

namespace xlb {

XLB_INSTANTIATE_PAIR(D3Q19, CollSmagorinsky)

}  // namespace xlb
