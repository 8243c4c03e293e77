"""The slice as a whole: the lid-driven cavity stepped by the port against
xlb_tpu, and the state carried across between the two. (torch is imported
inside the tests; test_torch_setup.py says why.)"""

import jax.numpy as jnp
import numpy as np
import pytest

from xlb_tpu.kernels.fused_step import build_fused_window as jax_build_fused_window
from tests.test_torch_setup import build_cavity, reset_port_state

OMEGA = 1.9


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def _perturbed(f0, seed):
    f = np.asarray(f0).astype(np.float32)
    return (f * (1.0 + 0.05 * np.random.default_rng(seed).standard_normal(f.shape))).astype(np.float32)


def test_torch_tier_cavity_20_steps_matches_jnp_tier():
    """20 TORCH-tier steps against 20 jnp-tier steps, FP32FP32 (rtol=1e-5,
    atol=1e-6: float32 reassociation accumulated over 20 steps)."""
    from xlb_tpu_torch.utils import fields_from_numpy

    shape = (16, 12, 10)
    sj, (f0j, _, bmj, mmj) = build_cavity("xlb_tpu", shape)
    st, (_, _, bmt, mmt) = build_cavity("xlb_tpu_torch", shape)
    f = _perturbed(f0j, seed=0)
    ref, _ = sj.build_multi_step(20)(jnp.asarray(f), jnp.asarray(f), bmj, mmj, OMEGA)
    f_0, f_1, _, _ = fields_from_numpy(f, f, bmj, mmj, device="cpu")
    ours, _ = st.build_multi_step(20)(f_0, f_1, bmt, mmt, OMEGA)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_fused_window_bf16_shifted_matches_xlb_tpu():
    """4-step FP32BF16 window: xlb_tpu's interpret-mode DMA + k=2 path
    against the port's window (plain versions on the CPU), within the
    bf16 8-ulp bound."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep
    from xlb_tpu_torch.kernels.fused_step import build_fused_window
    from xlb_tpu_torch.utils import fields_from_numpy

    shape = (8, 8, 128)
    sj, (f0j, _, bmj, mmj) = build_cavity("xlb_tpu", shape, "FP32BF16")
    st, (_, _, bmt, mmt) = build_cavity("xlb_tpu_torch", shape, "FP32BF16")
    fj = jnp.asarray(_perturbed(f0j, seed=1), dtype=jnp.bfloat16)
    ref, _ = jax_build_fused_window(sj, 4, interpret=True)(fj, fj, bmj, mmj, OMEGA)

    f_0, f_1, _, _ = fields_from_numpy(np.asarray(fj), np.asarray(fj), bmj, mmj, device="cpu")
    assert f_0.dtype == torch.bfloat16
    counts = (CollideStreamStep.plain_calls, CollideStreamKStep.plain_calls)
    run = build_fused_window(st, 4)
    ours, _ = run(f_0, f_1, bmt, mmt, OMEGA)
    assert ours.dtype == torch.float32  # shifted windows return the compute dtype
    assert (CollideStreamStep.plain_calls, CollideStreamKStep.plain_calls) == (counts[0], counts[1] + 2)
    eps = float(jnp.finfo(jnp.bfloat16).eps)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=8 * eps, atol=8 * eps * 0.05)


def test_rest_state_window_shift_is_exact():
    """The window boundary shifts by the store-dtype-rounded weights, so a
    bf16 rest state maps to g = 0 exactly and converts back unchanged; the
    kernels' float32 weights then keep a periodic rest state to within
    float32 roundoff of the collision (as in xlb_tpu)."""
    import torch

    import xlb_tpu_torch
    from xlb_tpu_torch.kernels.fused_step import build_fused_window

    xlb_tpu_torch.init(
        xlb_tpu_torch.velocity_set.D3Q19(), default_precision_policy=xlb_tpu_torch.PrecisionPolicy.FP32BF16
    )
    from xlb_tpu_torch.models import IncompressibleNavierStokesStepper

    stepper = IncompressibleNavierStokesStepper(xlb_tpu_torch.grid_factory((6, 5, 4), device="cpu"))
    f_0, f_1, bc_mask, missing_mask = stepper.prepare_fields()
    out, _ = build_fused_window(stepper, 0)(f_0, f_1, bc_mask, missing_mask, OMEGA)
    assert torch.equal(out, f_0.float())
    out, _ = build_fused_window(stepper, 3)(f_0, f_1, bc_mask, missing_mask, OMEGA)
    assert float((out - f_0.float()).abs().max()) <= 2 * torch.finfo(torch.float32).eps


@pytest.mark.parametrize("policy", ["FP32FP32", "FP32BF16"])
def test_interop_round_trip(policy):
    import torch

    import xlb_tpu_torch
    from xlb_tpu_torch.utils import fields_from_numpy, fields_to_numpy

    _, (f0j, f1j, bmj, mmj) = build_cavity("xlb_tpu", (6, 5, 4), policy)
    tensors = fields_from_numpy(np.asarray(f0j), np.asarray(f1j), np.asarray(bmj), np.asarray(mmj), device="cpu")
    store = xlb_tpu_torch.PrecisionPolicy[policy].store_dtype
    assert [t.dtype for t in tensors] == [store, store, torch.uint8, torch.bool]
    arrays = fields_to_numpy(*tensors)
    np.testing.assert_array_equal(arrays[0], np.asarray(f0j).astype(np.float32))
    np.testing.assert_array_equal(arrays[2], np.asarray(bmj))
    np.testing.assert_array_equal(arrays[3], np.asarray(mmj))
    back = fields_from_numpy(*arrays, device="cpu", dtype=store)
    for a, b in zip(back, tensors):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_torch_tier_single_step_swaps_like_xlb_tpu():
    """stepper(...) returns (f_0, f_new) and leaves f_0 as it was."""
    import torch

    st, (f_0, f_1, bc_mask, missing_mask) = build_cavity("xlb_tpu_torch", (6, 5, 4))
    keep = f_0.clone()
    a, b = st(f_0, f_1, bc_mask, missing_mask, OMEGA, 0)
    assert a is f_0 and torch.equal(f_0, keep) and b.shape == f_0.shape
