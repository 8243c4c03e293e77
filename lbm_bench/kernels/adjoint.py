"""The adjoint kernel K8 of ``xlb_tpu_torch/csrc/adjoint_step.cuh``: one
adjoint step is ``adjoint_kernel``, and on scenes with halfway walls or
open boundaries also ``adjoint_centred_kernel`` and
``adjoint_staging_kernel``.

Per adjoint step, counted on its ``adjoint_kernel`` call: the state read
in the store type, the cotangent read and the state's cotangent written
in float32, the mask read, omega's per-voxel cotangent written (D3Q19:
236 B per voxel with float32 storage, 198 B with bfloat16), and the aux
field's bytes as the forward step reads them; float32 operations: 495 per
voxel (514 with the shifted load) for D3Q19 BGK, counted from the
hand-derived transpose of the step. The other two launches add time and
no work."""

import re

from lbm_bench.kernels import cell_sizes

NAME = re.compile(r"xlb::(adjoint|adjoint_centred|adjoint_staging)_kernel<")
COUNTERS = {"adjoint": ("xlb_tpu_torch.kernels.adjoint_step", "CollideStreamAdjoint")}
FLOPS_PER_VOXEL = {("D3Q19", "BGK"): {False: 495, True: 514}}


def matches(name):
    """The launch ("adjoint", "adjoint_centred" or "adjoint_staging"), or None."""
    m = NAME.search(name)
    return m.group(1) if m else None


def work(form, cell):
    """(bytes, float32 operations) of one launch of this family, or None
    where the cell's lattice and collision have no count here."""
    flops = FLOPS_PER_VOXEL.get((cell["velocity_set"], cell["collision"]))
    if flops is None:
        return None
    if form != "adjoint":
        return 0, 0
    n, q, store, shifted, aux = cell_sizes(cell)
    return q * n * store + 2 * q * n * 4 + 4 * n + 4 * n + aux, flops[shifted] * n
