"""K8's split by voxel class, on the CPU: the voxels the boundary launch
takes (``CollideStreamAdjoint.boundary_voxels``), the forms that split,
the names ``chip_smoke.k8_launch_name`` gives K8's launches in a profiler
trace, and K8's limit failing the planted faults of a K8 without its
boundary or its centred launch (``chip_smoke.k8_without``), on the flow
past a sphere of ``chip_smoke.open_bcs`` at 32x16x16 (a regularized inlet
through the aux field, the outflow, halfway walls and sphere). The kernels
themselves run on the card (tests/test_torch_gpu.py). (torch is imported
inside the tests; test_torch_setup.py says why.)
"""

import functools

import pytest

SHAPE = (32, 16, 16)
OMEGA = 1.6


@functools.cache
def _sphere():
    """(stepper, packed mask, bc_mask, aux or None) of the sphere scene,
    built once per test process."""
    import torch

    import xlb_tpu_torch as xlb
    from chip_smoke import open_scene
    from xlb_tpu_torch.kernels.fused_step import build_aux_field, pack_masks

    stepper, (_, _, bc_mask, missing_mask) = open_scene("sphere", SHAPE, xlb.PrecisionPolicy.FP32FP32,
                                                        xlb.ComputeBackend.TORCH, torch.device("cpu"))
    aux = build_aux_field(stepper)
    return stepper, pack_masks(bc_mask, missing_mask), bc_mask, None if aux is None else torch.as_tensor(aux)


def _adjoint(stepper, **kw):
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint
    from xlb_tpu_torch.kernels.collide_stream import kernel_collision_spec
    from xlb_tpu_torch.kernels.fused_step import bc_to_spec

    vs = stepper.velocity_set
    return CollideStreamAdjoint(vs, SHAPE, collision=kernel_collision_spec(stepper), has_solids=stepper.has_solids,
                                bc_specs=[bc_to_spec(b, vs) for b in stepper.boundary_conditions], **kw)


def test_boundary_voxels_are_those_of_the_epilogue_bcs():
    """The boundary launch takes the voxels of every BC with a
    streaming-step epilogue (inlet, outlet, walls, sphere) and no other:
    not the fluid, not the sphere's solid interior."""
    import torch

    stepper, mask, bc_mask, _ = _sphere()
    adj = _adjoint(stepper)
    ids = [bc.id for bc in stepper.boundary_conditions]
    expected = torch.isin(bc_mask[0].long(), torch.tensor(ids))
    got = adj.boundary_voxels(mask)
    assert torch.equal(got, expected)
    assert 0.0 < adj.boundary_share(mask) == float(expected.sum()) / expected.numel() < 0.5
    assert not bool((got & (bc_mask[0] == 255)).any())


@pytest.mark.parametrize("kinds,split", [((), False), (("halfway",), False), (("regularized",), True),
                                         (("extrapolation_outflow", "halfway"), True)])
def test_open_forms_split(kinds, split):
    """``split`` is the kExtOpen and kExtHybrid forms' (walled code 2, 3),
    never the walled forms' (0, 1): the sphere scene's BCs of ``kinds``."""
    from xlb_tpu_torch.kernels.adjoint_step import CollideStreamAdjoint

    adj = _adjoint(_sphere()[0])
    specs = [s for s in adj.bc_specs if s["kind"] in kinds]
    assert {s["kind"] for s in specs} == set(kinds)
    assert CollideStreamAdjoint(adj.vs, SHAPE, bc_specs=specs).split == split


@pytest.mark.parametrize("key,name", [
    ("void xlb::adjoint_kernel<xlb::D3Q19, xlb::CollBGK, float, false, 3, false>(float const*)", "adjoint"),
    ("void xlb::adjoint_centred_kernel<xlb::D3Q19, xlb::CollBGK, float, false, 3, true, true>(float const*)",
     "boundary"),
    ("void xlb::adjoint_centred_kernel<xlb::D3Q19, xlb::CollBGK, float, false, 2, true, false>(float const*)",
     "centred"),
    ("void xlb::adjoint_centred_kernel<xlb::D3Q19, xlb::CollBGK, float, false, 3, true>(float const*)", "centred"),
    ("void xlb::adjoint_staging_kernel<xlb::D3Q19>(float const*, int const*)", "staging"),
    ("void xlb::kstep_kernel<xlb::D3Q19, xlb::CollBGK, float, false, 3, true>(float const*)", None),
])
def test_launch_names(key, name):
    """Every K8 launch is named; the boundary phase by its seventh template
    argument, an older tree's six-argument centred launch as centred."""
    from chip_smoke import k8_launch_name

    assert k8_launch_name(key) == name


@pytest.mark.parametrize("launch", ["boundary", "centred"])
def test_limit_fails_k8_without_a_launch(launch):
    """K8's limit against its plain version (``chip_smoke.k8_held``) fails
    the plain version with the terms of the boundary or the centred launch
    dropped, by far."""
    import torch

    from chip_smoke import k8_held, k8_without

    stepper, mask, _, aux = _sphere()
    adj = _adjoint(stepper)
    vs = stepper.velocity_set
    gen = torch.Generator().manual_seed(5)
    w = torch.as_tensor(vs._w, dtype=torch.float32).reshape(-1, 1, 1, 1)
    f = (w * (1.0 + 0.05 * torch.randn((vs.q,) + SHAPE, generator=gen))).contiguous()
    g = (w * torch.randn(f.shape, generator=gen)).contiguous()
    extra = () if aux is None else (aux,)
    pdf, pdom = adj.plain(f, g, mask, OMEGA, *extra)
    assert k8_held(pdf, pdom, pdf, pdom)[1] == 0.0
    assert k8_held(*k8_without(launch, adj, f, g, mask, OMEGA, aux), pdf, pdom)[1] > 100.0
