"""Operator parity of xlb_tpu_torch with xlb_tpu on random float32 fields.
(torch is imported inside the tests; test_torch_setup.py says why.)

Tolerance rtol=1e-6, atol=1e-7: the same arithmetic, up to float32
reassociation (the density sums reduce in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest

from xlb_tpu.ops import collision as jax_collision, equilibrium as jax_eq, macroscopic as jax_mac, stream as jax_stream
from xlb_tpu.velocity_set import stencils as jax_stencils
from tests.test_torch_setup import reset_port_state

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"D2Q9": (6, 5), "D3Q19": (6, 5, 4)}


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def _fields(name, seed):
    vs = getattr(jax_stencils, name)()  # the constants are bit-equal (test_torch_core)
    rng = np.random.default_rng(seed)
    w = vs._w.reshape((-1,) + (1,) * vs.d)
    f = (w * (1.0 + 0.1 * rng.standard_normal((vs.q,) + SHAPES[name]))).astype(np.float32)
    return vs, f


@pytest.mark.parametrize("name", list(SHAPES))
def test_stream_pull(name):
    import torch

    from xlb_tpu_torch.ops import stream

    vs, f = _fields(name, 0)
    out = stream.stream_pull(torch.from_numpy(f), vs._c).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_stream.stream_pull(jnp.asarray(f), vs._c)))


@pytest.mark.parametrize("name", list(SHAPES))
def test_macroscopic(name):
    import torch

    from xlb_tpu_torch.ops import macroscopic

    vs, f = _fields(name, 1)
    rho = macroscopic.density(torch.from_numpy(f))
    u = macroscopic.velocity(torch.from_numpy(f), rho, vs._c)
    rho_j = jax_mac.density(jnp.asarray(f))
    u_j = jax_mac.velocity(jnp.asarray(f), rho_j, vs._c)
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_j), **TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **TOL)


@pytest.mark.parametrize("name", list(SHAPES))
def test_quadratic_equilibrium(name):
    import torch

    from xlb_tpu_torch.ops import equilibrium

    vs, f = _fields(name, 2)
    rng = np.random.default_rng(3)
    rho = (1.0 + 0.05 * rng.standard_normal((1,) + SHAPES[name])).astype(np.float32)
    u = (0.05 * rng.standard_normal((vs.d,) + SHAPES[name])).astype(np.float32)
    ours = equilibrium.quadratic_equilibrium(torch.from_numpy(rho), torch.from_numpy(u), vs._c, vs._w, torch.float32)
    ref = jax_eq.quadratic_equilibrium(jnp.asarray(rho), jnp.asarray(u), vs._c, vs._w, jnp.float32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(
        equilibrium.quadratic_equilibrium_np([1.0], [0.02] + [0.0] * (vs.d - 1), vs._c, vs._w),
        jax_eq.quadratic_equilibrium_np([1.0], [0.02] + [0.0] * (vs.d - 1), vs._c, vs._w),
    )


@pytest.mark.parametrize("name", list(SHAPES))
def test_bgk(name):
    import torch

    from xlb_tpu_torch.ops import collision

    vs, f = _fields(name, 4)
    feq = _fields(name, 5)[1]
    ours = collision.bgk_collide(torch.from_numpy(f), torch.from_numpy(feq), 1.7)
    ref = jax_collision.bgk_collide(jnp.asarray(f), jnp.asarray(feq), jnp.float32(1.7))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
