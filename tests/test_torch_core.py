"""Core parity of xlb_tpu_torch with xlb_tpu: velocity-set constants,
precision policies, config and grid. (torch is imported inside the tests;
test_torch_setup.py says why.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import xlb_tpu
from xlb_tpu.velocity_set import stencils as jax_stencils
from tests.test_torch_setup import reset_port_state


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


@pytest.mark.parametrize("name", ["D2Q9", "D3Q19", "D3Q27"])
def test_velocity_set_constants_equal(name):
    from xlb_tpu_torch.velocity_set import stencils

    ref = getattr(jax_stencils, name)()
    vs = getattr(stencils, name)()
    assert (vs.d, vs.q, vs.center_index) == (ref.d, ref.q, ref.center_index)
    for attr in ("_c", "_w", "_opp_indices", "_cc", "_qi", "_c_float", "main_indices", "right_indices", "left_indices"):
        np.testing.assert_array_equal(getattr(vs, attr), getattr(ref, attr), err_msg=attr)
        assert getattr(vs, attr).dtype == getattr(ref, attr).dtype, attr
    # torch-side constants equal the jnp-side ones
    for attr in ("c", "w", "opp_indices", "cc", "c_float", "qi"):
        np.testing.assert_array_equal(getattr(vs, attr).numpy(), np.asarray(getattr(ref, attr)), err_msg=attr)


@pytest.mark.parametrize("name", [p.name for p in xlb_tpu.PrecisionPolicy])
def test_precision_policy_dtypes(name):
    import torch

    import xlb_tpu_torch

    policy, ref = xlb_tpu_torch.PrecisionPolicy[name], xlb_tpu.PrecisionPolicy[name]
    assert [p.name for p in xlb_tpu_torch.PrecisionPolicy] == [p.name for p in xlb_tpu.PrecisionPolicy]
    assert policy.compute_precision.name == ref.compute_precision.name
    assert policy.store_precision.name == ref.store_precision.name
    for ours, theirs in ((policy.compute_dtype, ref.compute_dtype), (policy.store_dtype, ref.store_dtype)):
        assert str(ours).removeprefix("torch.") == jnp.dtype(theirs).name
    x = torch.ones(3, dtype=torch.float64)
    assert policy.cast_to_store(x).dtype == policy.store_dtype
    assert policy.cast_to_compute(x).dtype == policy.compute_dtype


def test_precision_torch_dtype():
    import torch

    from xlb_tpu_torch import Precision as P

    assert P.FP32.torch_dtype == torch.float32
    assert P.BF16.torch_dtype == torch.bfloat16
    assert P.FP16.torch_dtype == torch.float16
    assert P.FP64.torch_dtype == torch.float64
    assert P.UINT8.torch_dtype == torch.uint8
    assert P.BOOL.torch_dtype == torch.bool


def test_init_and_reset():
    import torch

    import xlb_tpu_torch
    from xlb_tpu_torch.velocity_set import D3Q19

    vs = D3Q19()
    cfg = xlb_tpu_torch.init(vs, xlb_tpu_torch.ComputeBackend.CUDA, xlb_tpu_torch.PrecisionPolicy.FP32BF16)
    assert cfg.velocity_set is vs and cfg.default_backend == xlb_tpu_torch.ComputeBackend.CUDA
    op = xlb_tpu_torch.Operator()
    assert op.store_dtype == torch.bfloat16 and op.compute_dtype == torch.float32
    xlb_tpu_torch.DefaultConfig.reset()
    assert xlb_tpu_torch.DefaultConfig.velocity_set is None
    with pytest.raises(RuntimeError, match="init"):
        xlb_tpu_torch.Operator()
    with pytest.raises(TypeError):
        xlb_tpu_torch.init(vs, default_backend="CUDA")


@pytest.mark.parametrize("remove_edges", [False, True])
def test_bounding_box_indices_equal(remove_edges):
    import xlb_tpu_torch

    shape = (7, 5, 6)
    ref = xlb_tpu.grid_factory(shape, mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    grid = xlb_tpu_torch.grid_factory(shape, device="cpu")
    assert grid.bounding_box_indices(remove_edges=remove_edges) == ref.bounding_box_indices(remove_edges=remove_edges)


def test_grid_create_field():
    import torch

    import xlb_tpu_torch
    from xlb_tpu_torch.velocity_set import D3Q19

    xlb_tpu_torch.init(D3Q19(), default_precision_policy=xlb_tpu_torch.PrecisionPolicy.FP32BF16)
    grid = xlb_tpu_torch.grid_factory((4, 3, 2), device="cpu")
    assert grid.device == torch.device("cpu")
    f = grid.create_field(19)
    assert f.shape == (19, 4, 3, 2) and f.dtype == torch.bfloat16 and not f.any()
    m = grid.create_field(1, dtype=xlb_tpu_torch.Precision.UINT8, fill_value=7)
    assert m.dtype == torch.uint8 and bool((m == 7).all())
