// The D3Q19 BGK kExtOpen form of the adjoint K8 (adjoint_kernel and its
// second and third launches, adjoint_step.cuh; the table of
// collide_stream_3d.cuh), in a source of its own so that the build
// compiles it beside the pair's forward forms.
#include "collide_stream_3d.cuh"

namespace xlb {

XLB_INSTANTIATE_OPEN_ADJOINT(D3Q19, CollBGK)

}  // namespace xlb
