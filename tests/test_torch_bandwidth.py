"""The copy-bandwidth probes (K9-K12) and the performance entry points of
the port, on the CPU.

- The plain versions of K9-K12 against the reference's own Pallas kernel
  bodies, run in interpret mode at (3, 16, 16, 16) float32, bit for bit.
  The reference scripts run their 1.3 GB benchmark when imported, so the
  kernels (and the module-level ``pallas_call``s of K10 and K11) are taken
  from their source with ``ast`` and executed with N = 16, q = 3 and a
  ``pl`` whose ``pallas_call`` adds ``interpret=True``; K9 runs under the
  script's three blockings scaled to N = 16.
- The wrappers' input checks, and their plain versions on CPU tensors.
- ``memory_bandwidth.run``, ``dma_experiments.run`` and the three
  ``mlups_*`` functions with ``device="cpu"`` at tiny sizes.

(torch is imported inside the tests; test_torch_setup.py says why.)
"""

import ast
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_setup import reset_port_state

PERF = pathlib.Path(__file__).resolve().parents[1] / "examples" / "performance"
N, Q = 16, 3
# dma_experiments.py:175-181
MANUAL = [("B", 2, 1, True), ("C", 3, 1, False), ("C2", 2, 1, False), ("D", 2, 4, False), ("D2", 3, 1, True)]


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def _reference(script, functions, assigns=()):
    """The named top-level functions (and the values of the named
    top-level assignments) of ``examples/performance/<script>``, executed
    with N, q and an interpret-mode ``pl``."""
    tree = ast.parse((PERF / script).read_text())
    keep = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef) and node.name in functions)
            or (isinstance(node, ast.Assign) and any(getattr(t, "id", None) in assigns for t in node.targets))]
    interpret_pl = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    interpret_pl.pallas_call = lambda *args, **kw: pl.pallas_call(*args, interpret=True, **kw)
    namespace = {"N": N, "q": Q, "jax": jax, "jnp": jnp, "pl": interpret_pl, "pltpu": pltpu}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(PERF / script), "exec"), namespace)
    return namespace


def _field(seed=0):
    return np.random.default_rng(seed).standard_normal((Q, N, N, N)).astype(np.float32)


def _k9_blockings():
    """memory_bandwidth.py:48's three blockings, their 64- and 32-row
    extents scaled from N = 256 to N = 16, with the script's BlockSpecs."""
    s = N // 16
    out = []
    for blk, grid in [((1, 4 * s, 4 * s, N), (Q, 4, 4)), ((1, 2 * s, N, N), (Q, 8)), ((Q, s, 4 * s, N), (N // s, 4))]:
        if len(grid) == 3:
            spec = pl.BlockSpec(blk, lambda a, b, c: (a, b, c, 0))
        else:
            spec = pl.BlockSpec(blk, (lambda a, b: (0, a, b, 0)) if blk[0] == Q else (lambda a, b: (a, b, 0, 0)))
        out.append((blk, grid, spec))
    return out


def test_k9_plain_matches_reference_copy_kernel():
    import torch

    from xlb_tpu_torch.kernels.copy_bandwidth import PipelinedCopy, copy_plain

    ref = _reference("memory_bandwidth.py", {"copy_kernel"})
    x = _field(9)
    ours = copy_plain(torch.from_numpy(x)).numpy()
    for blk, grid, spec in _k9_blockings():
        fn = pl.pallas_call(ref["copy_kernel"], grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0, grid=grid, in_specs=[spec], out_specs=spec),
            out_shape=jax.ShapeDtypeStruct((Q, N, N, N), jnp.float32), interpret=True)
        assert np.array_equal(np.asarray(fn(jnp.asarray(x))), ours), blk
    assert np.array_equal(PipelinedCopy()(torch.from_numpy(x)).numpy(), ours)


@pytest.mark.parametrize("name", ["hbm2hbm", "hbm2hbm_q"])
def test_k10_k11_plain_match_reference_dma_kernels(name):
    import torch

    from xlb_tpu_torch.kernels.copy_bandwidth import BulkCopy, SplitBulkCopy, copy_plain

    ref = _reference("dma_experiments.py", {f"{name}_kernel"}, {name})
    x = _field(10)
    ours = copy_plain(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.asarray(ref[name](jnp.asarray(x))), ours)
    wrapper = BulkCopy() if name == "hbm2hbm" else SplitBulkCopy(Q)
    assert np.array_equal(wrapper(torch.from_numpy(x)).numpy(), ours)


@pytest.mark.parametrize("label,depth,n_split,manual_out", MANUAL)
def test_k12_plain_matches_reference_manual_pipeline(label, depth, n_split, manual_out):
    import torch

    from xlb_tpu_torch.kernels.copy_bandwidth import ManualScaleCopy, scale_copy_plain

    ref = _reference("dma_experiments.py", {"make_manual"})
    x = _field(12)
    ours = scale_copy_plain(torch.from_numpy(x)).numpy()
    out = np.asarray(ref["make_manual"](depth, n_split, manual_out)(jnp.asarray(x)))
    assert np.array_equal(out, ours), label
    assert not np.array_equal(ours, x)  # the scale moves values by an ulp
    assert np.array_equal(ManualScaleCopy(depth, n_split, manual_out)(torch.from_numpy(x)).numpy(), ours)


def test_wrappers_check_their_inputs():
    """Each wrapper runs its plain version on a CPU tensor (counted as a
    plain call, not a launch) and raises on another device, another dtype,
    a non-contiguous or empty tensor, another shape than it was built for,
    and (K11) another channel count."""
    import torch

    from xlb_tpu_torch.kernels import copy_bandwidth as cb

    x = torch.from_numpy(_field(1))
    for make in (lambda **kw: cb.PipelinedCopy(**kw), lambda **kw: cb.BulkCopy(**kw),
                 lambda **kw: cb.SplitBulkCopy(Q, **kw), lambda **kw: cb.ManualScaleCopy(3, 1, True, **kw)):
        kernel = make()
        before = cb.counts()[type(kernel).__name__]
        assert kernel(x).shape == x.shape
        assert cb.counts()[type(kernel).__name__] == (before[0], before[1] + 1)
        with pytest.raises(ValueError, match="CUDA"):
            kernel(torch.empty(x.shape, device="meta"))
        with pytest.raises(TypeError):
            kernel(x.double())
        with pytest.raises(ValueError, match="contiguous"):
            kernel(x.transpose(1, 2))
        with pytest.raises(ValueError):
            kernel(x[:, :0])
        with pytest.raises(ValueError, match="shape"):
            make(shape=(Q, N, N, N + 1))(x)
        with pytest.raises(RuntimeError, match="autograd"):
            kernel(x.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="channels"):
        cb.SplitBulkCopy(Q + 1)(x)
    with pytest.raises(NotImplementedError):
        cb.ManualScaleCopy(depth=3, n_split=4)
    with pytest.raises(NotImplementedError):
        cb.PipelinedCopy(per_thread=2)
    # the output shares the input's address modulo 16 bytes, as the bulk copies need
    view = x.reshape(-1)[1:]
    assert cb.like_aligned(view).data_ptr() % 16 == view.data_ptr() % 16


def test_bulk_chunk_matches_the_source():
    """BULK_CHUNK mirrors kBulkChunk of csrc/copy_bandwidth.cu: the GPU
    tests size their one-chunk ranges by it."""
    import re

    from xlb_tpu_torch.kernels import _cuda, copy_bandwidth

    src = (_cuda.CSRC / "copy_bandwidth.cu").read_text()
    assert int(re.search(r"constexpr int kBulkChunk = (\d+);", src).group(1)) == copy_bandwidth.BULK_CHUNK


def test_probe_runs_on_cpu():
    from xlb_tpu_torch.examples.performance import dma_experiments, memory_bandwidth

    for run, n_lines in ((memory_bandwidth.run, 5), (dma_experiments.run, 9)):
        res = run(device="cpu", N=4, q=Q, iters=2, reps=1)
        assert res["device"] == "cpu" and res["shape"] == (Q, 4, 4, 4) and res["bytes"] == Q * 64 * 4
        assert len(res["lines"]) == n_lines
        assert all(np.isfinite(r["ms"]) and r["ms"] > 0 and np.isfinite(r["GBps"]) for r in res["lines"].values())


def test_mlups_entry_points_run_on_cpu():
    from xlb_tpu_torch.examples.performance import mlups_2d, mlups_3d, mlups_3d_multires

    results = [
        mlups_2d.benchmark(16, 4, "cuda", "FP32BF16", 1, 1, temporal_steps=2, device="cpu"),
        mlups_2d.benchmark(16, 4, "torch", "FP32FP32", 1, 1, device="cpu"),
        mlups_3d.benchmark(8, 2, "cuda", "D3Q19", "TRT", "FP32FP32", 1, 1, device="cpu"),
        mlups_3d.benchmark(8, 2, "cuda", "D3Q27", "KBC", "FP32BF16", 1, 1, window=True, device="cpu"),
        mlups_3d.benchmark(8, 2, "cuda", "D3Q19", "BGK", "FP32FP32", 1, 1, window=True, kernel="blocked",
                           tile=(1, 4, 8), device="cpu"),
        mlups_3d.benchmark(8, 2, "torch", "D3Q19", "PowerLawBGK", "FP32FP32", 1, 1, device="cpu"),
        mlups_3d_multires.run(16, 0.5, 2, 1, 1, "fusion_at_finest", device="cpu"),
    ]
    assert all(np.isfinite(m) and m > 0 for m in results)
    with pytest.raises(NotImplementedError, match=r"a device mesh \(multires over several cards\) is not ported yet"):
        mlups_3d_multires.run(16, mesh_shape=(2, 1), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        mlups_2d.benchmark(16, 4, "pallas", "FP32FP32", 1, 1, device="cpu")
