"""The fused steps' plain versions against xlb_tpu's TPU kernels, run in
Pallas interpret mode on the CPU (as xlb_tpu's own kernel tests run them).

Cavity masks at (8, 8, 128), tile (8, 8) on the xlb_tpu side, seeded
perturbed fields. Tolerance: the 8-ulp bound of the store dtype
(``rtol=8*eps, atol=8*eps*0.05``, tests/kernels/test_fused_2step.py) --
XLA's FMA contraction differs from torch's CPU arithmetic. (torch is
imported inside the tests; test_torch_setup.py says why.)
"""

import jax.numpy as jnp
import numpy as np
import pytest

from xlb_tpu.kernels.collide_stream_2step import build_fused_collide_stream_3d_kstep as jax_kstep
from xlb_tpu.kernels.collide_stream_dma import build_fused_collide_stream_3d_dma as jax_step
from xlb_tpu.kernels.fused_step import bc_to_spec as jax_bc_to_spec, pack_masks as jax_pack_masks
from tests.test_torch_setup import build_cavity, reset_port_state

SHAPE = (8, 8, 128)
OMEGA = 1.9
# store dtype: (jnp dtype, torch dtype name, shifted)
STORES = {"f32": (jnp.float32, "float32", False), "bf16-shifted": (jnp.bfloat16, "bfloat16", True)}


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def _setup(store_key, seed):
    import torch

    from xlb_tpu_torch.kernels.fused_step import bc_to_spec, pack_masks

    jstore, tstore, shifted = STORES[store_key]
    tstore = getattr(torch, tstore)
    sj, (_, _, bmj, mmj) = build_cavity("xlb_tpu", SHAPE)
    st, (_, _, bmt, mmt) = build_cavity("xlb_tpu_torch", SHAPE)
    vs = st.velocity_set
    w = vs._w.reshape(-1, 1, 1, 1)
    noise = np.random.default_rng(seed).standard_normal((vs.q,) + SHAPE)
    g = (0.02 * noise * w if shifted else w * (1.0 + 0.05 * noise)).astype(np.float32)
    gj = jnp.asarray(g, dtype=jstore)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(tstore)
    jax_kw = dict(bc_specs=[jax_bc_to_spec(b, sj.velocity_set) for b in sj.boundary_conditions],
                  store_dtype=jstore, tile=(8, 8), interpret=True, shifted=shifted)
    kw = dict(bc_specs=[bc_to_spec(b, vs) for b in st.boundary_conditions], store_dtype=tstore, shifted=shifted)
    return (sj.velocity_set, gj, jax_pack_masks(bmj, mmj), jax_kw), (vs, gt, pack_masks(bmt, mmt), kw), jstore


def _assert_8ulp(ours, ref, jstore):
    eps = float(jnp.finfo(jstore).eps)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol=8 * eps, atol=8 * eps * 0.05)


@pytest.mark.parametrize("store", list(STORES))
def test_single_step_matches_xlb_tpu_dma_kernel(store):
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep

    (jvs, gj, mj, jkw), (vs, gt, mt, kw), jstore = _setup(store, seed=1)
    ref = jax_step(jvs, SHAPE, **jkw)(gj, mj, OMEGA)
    ours = CollideStreamStep(vs, SHAPE, **kw)(gt, mt, OMEGA)
    assert ours.dtype == gt.dtype and ours.shape == gt.shape
    _assert_8ulp(ours, ref, jstore)


def test_kstep_matches_xlb_tpu_kstep_kernel():
    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep

    (jvs, gj, mj, jkw), (vs, gt, mt, kw), jstore = _setup("bf16-shifted", seed=2)
    ref = jax_kstep(jvs, SHAPE, steps=2, **jkw)(gj, mj, OMEGA)
    ours = CollideStreamKStep(vs, SHAPE, steps=2, **kw)(gt, mt, OMEGA)
    _assert_8ulp(ours, ref, jstore)


@pytest.mark.parametrize("steps", [2, 3])
def test_kstep_plain_is_k_single_steps(steps):
    """The k-step's plain version is k single steps with store-dtype
    rounding in between (no xlb_tpu call: the same arithmetic, bit-equal)."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream_2step import CollideStreamKStep
    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep

    _, (vs, gt, mt, kw), _ = _setup("bf16-shifted", seed=3)
    one = CollideStreamStep(vs, SHAPE, **kw)
    ref = gt
    for _ in range(steps):
        ref = one(ref, mt, OMEGA)
    ours = CollideStreamKStep(vs, SHAPE, steps=steps, **kw)(gt, mt, OMEGA)
    assert torch.equal(ours, ref)


def test_solid_keep_out():
    """Cell type 255 keeps its populations (the plain version of the
    kernels' solid keep-out), shifted storage included."""
    import torch

    from xlb_tpu_torch.kernels.collide_stream_dma import CollideStreamStep

    _, (vs, gt, mt, kw), _ = _setup("bf16-shifted", seed=4)
    solid = torch.zeros(SHAPE, dtype=torch.bool)
    solid[3:5, 2:6, 40:90] = True
    mt = torch.where(solid, torch.tensor(255 << 19, dtype=torch.int32), mt)
    out = CollideStreamStep(vs, SHAPE, has_solids=True, **kw)(gt, mt, OMEGA)
    assert torch.equal(out[:, solid], gt[:, solid])
    assert not torch.equal(out[:, ~solid], gt[:, ~solid])
