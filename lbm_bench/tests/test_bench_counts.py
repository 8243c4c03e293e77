"""The kernel families' bytes and operations against hand counts, the
least time, and which profiler names each family takes."""

import pytest

from lbm_bench.bench import kernel_families
from lbm_bench.roofline import least_seconds

FAM = kernel_families()
SHAPE = [512, 256, 256]
N = 512 * 256 * 256
INLET = 254 * 254


def cell(storage, launches=None, velocity_set="D3Q19", profiled=True):
    return {"shape": SHAPE, "velocity_set": velocity_set, "collision": "BGK", "storage": storage, "steps": 200,
            "launches": launches or {"stream": {"kstep": 100, "step": 0, "blocked": 0}},
            "profile_voxels": [INLET] if profiled else [], "profile_channels": [3] if profiled else []}


@pytest.mark.parametrize("storage,per_voxel,flops", [("f32", 156, 202), ("bf16", 80, 240)])
def test_stream_counts(storage, per_voxel, flops):
    # q populations read and written in the store type, the int32 mask read; 12 B per inlet voxel
    aux = 12 * INLET
    assert FAM["stream"].work("step", cell(storage)) == (per_voxel * N + aux, flops * N)
    assert FAM["stream"].work("blocked", cell(storage)) == (per_voxel * N + aux, flops * N)
    # 100 K2 launches for 200 steps: 2 steps a call
    assert FAM["stream"].work("kstep", cell(storage)) == (per_voxel * N + aux, 2 * flops * N)
    # 90 K2 launches and 20 K1 launches: 2 steps a K2 call
    mixed = cell(storage, {"stream": {"kstep": 90, "step": 20, "blocked": 0}})
    assert FAM["stream"].work("kstep", mixed) == (per_voxel * N + aux, 2 * flops * N)


def test_stream_counts_without_a_count():
    # a lattice with no operation count, or a window with no K2 call, gives no work
    assert FAM["stream"].work("kstep", cell("f32", velocity_set="D3Q27")) is None
    assert FAM["stream"].work("kstep", cell("f32", {"stream": {"kstep": 0, "step": 200, "blocked": 0}})) is None
    assert FAM["stream"].work("step", cell("f32", {"stream": {"kstep": 0, "step": 200, "blocked": 0}})) is not None


@pytest.mark.parametrize("storage,per_voxel,flops", [("f32", 236, 495), ("bf16", 198, 514)])
def test_adjoint_counts(storage, per_voxel, flops):
    c = cell(storage, profiled=False)
    assert FAM["adjoint"].work("adjoint", c) == (per_voxel * N, flops * N)
    assert FAM["adjoint"].work("adjoint_centred", c) == (0, 0)
    assert FAM["adjoint"].work("adjoint_staging", c) == (0, 0)
    assert FAM["adjoint"].work("adjoint", cell(storage, velocity_set="D3Q27")) is None


def test_least_time():
    assert least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert least_seconds(0, 67e12) == pytest.approx(1.0)
    assert least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)
    # K2 at k = 2 on the 512^3 cavity is bound by its bytes
    n = 512**3
    assert 156 * n / 3.35e12 > 2 * 202 * n / 67e12


@pytest.mark.parametrize("name,family,form", [
    ("void xlb::kstep_kernel<xlb::D3Q19, float, (xlb::Ext)2>(float const*, int const*, float*, int, int)", "stream",
     "kstep"),
    ("void xlb::step_kernel<xlb::D3Q19, __nv_bfloat16, true>(__nv_bfloat16 const*, int const*)", "stream", "step"),
    ("void xlb::blocked_kernel<xlb::D3Q19, float>(float const*)", "stream", "blocked"),
    ("void xlb::adjoint_kernel<xlb::D3Q19, float>(float const*)", "adjoint", "adjoint"),
    ("void xlb::adjoint_centred_kernel<xlb::D3Q19, float>(float const*)", "adjoint", "adjoint_centred"),
    ("void xlb::adjoint_staging_kernel<xlb::D3Q19>(float const*)", "adjoint", "adjoint_staging"),
])
def test_names(name, family, form):
    assert FAM[family].matches(name) == form
    assert all(FAM[f].matches(name) is None for f in FAM if f != family)


@pytest.mark.parametrize("name", ["void xlb::field_step_kernel<xlb::D3Q19, float>(float const*)",
                                  "void xlb::step_2d_kernel<float>(float const*)",
                                  "void at::native::vectorized_elementwise_kernel<4>(int)", "Memcpy DtoD"])
def test_names_outside_the_families(name):
    assert all(FAM[f].matches(name) is None for f in FAM)
