"""The stream kernels: K2 (the k-step kernel), K1 (the single step) and K0
(the block-tiled step) of ``xlb_tpu_torch/csrc/collide_stream_3d.cuh`` and
``collide_stream_blocked.cuh``.

Per call: the q populations read once and written once in the store type
(D3Q19: 156 B per voxel in float32, 80 B in bfloat16), the packed int32
mask read once, and the aux field's channels at the voxels of the BCs
that read it (a per-voxel velocity: 12 B per voxel), whatever the call's
number of steps. Operations: the call's steps x the float32 operations of
one step per voxel, counted from the kernels' body (D3Q19 BGK: 202; 240
with the shifted load and store); the halo a k-step call recomputes does
not count. A K2 call's steps: the window's steps less those of its K1 and
K0 launches, over its K2 launches."""

import re

from lbm_bench.kernels import cell_sizes

NAME = re.compile(r"xlb::(kstep|step|blocked)_kernel<")
# the launch counters of each form: (module, class) of the port's kernel wrapper
COUNTERS = {"kstep": ("xlb_tpu_torch.kernels.collide_stream_2step", "CollideStreamKStep"),
            "step": ("xlb_tpu_torch.kernels.collide_stream_dma", "CollideStreamStep"),
            "blocked": ("xlb_tpu_torch.kernels.collide_stream_blocked", "CollideStreamBlocked")}
# float32 operations of one step per voxel: (lattice, collision) -> {shifted storage: count}
FLOPS_PER_VOXEL = {("D3Q19", "BGK"): {False: 202, True: 240}}


def matches(name):
    """The kernel's form ("kstep", "step" or "blocked"), or None."""
    m = NAME.search(name)
    return m.group(1) if m else None


def steps_per_call(form, cell):
    """The steps one call of ``form`` advances, from the launches of one
    window call, or None when the window made no such call."""
    launches = cell["launches"].get("stream", {})
    if form != "kstep":
        return 1
    if not launches.get("kstep"):
        return None
    return (cell["steps"] - launches.get("step", 0) - launches.get("blocked", 0)) / launches["kstep"]


def work(form, cell):
    """(bytes, float32 operations) of one call of a kernel of this family,
    or None where the cell's lattice and collision have no count here."""
    flops = FLOPS_PER_VOXEL.get((cell["velocity_set"], cell["collision"]))
    steps = steps_per_call(form, cell)
    if flops is None or steps is None:
        return None
    n, q, store, shifted, aux = cell_sizes(cell)
    return 2 * q * n * store + 4 * n + aux, steps * flops[shifted] * n
