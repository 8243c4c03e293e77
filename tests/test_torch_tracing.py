"""The port's tracer (``xlb_tpu_torch.utils.tracing``) and its spans in the
fused window and its backward, on the CPU: a (16, 16, 16) lid cavity
through ``build_fused_window``, whose kernel wrappers run their plain
versions on CPU tensors. Without a profiler a span is one shared null
context; under ``torch.profiler`` the spans keep records with their
parents and show as ``user_annotation`` ranges in the trace; the numbers
are the same either way. (torch is imported inside the tests;
test_torch_setup.py says why.)"""

import json

import pytest

from tests.test_torch_setup import build_cavity, reset_port_state

SHAPE = (16, 16, 16)
STEPS = 3  # one k-step group (k = 2) and one single step
OMEGA = 1.9
POLICIES = ["FP32FP32", "FP32BF16"]


@pytest.fixture(autouse=True)
def _reset_port():
    reset_port_state()
    yield


def _window(policy):
    """(the window, (f_0, bc_mask, missing_mask)) of the cavity."""
    from xlb_tpu_torch.kernels.fused_step import build_fused_window

    stepper, (f_0, _, bc_mask, missing_mask) = build_cavity("xlb_tpu_torch", SHAPE, policy=policy)
    return build_fused_window(stepper, STEPS), (f_0, bc_mask, missing_mask)


def _train_step(window, fields):
    """One training step's forward and backward: (output, d f_0, d omega)."""
    import torch

    f_0, bc_mask, missing_mask = fields
    f_in = f_0.detach().float().requires_grad_(True)
    omega = torch.tensor(1.5, requires_grad=True)
    out, _ = window(f_in, f_in, bc_mask, missing_mask, omega)
    torch.mean((out - 1.0 / 19) ** 2).backward()
    return out.detach(), f_in.grad, omega.grad


def _profiled(fn):
    """(fn(), the records of its profiler session, the profiler)."""
    import torch

    from xlb_tpu_torch.utils import tracing

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, tracing.records(), prof


def _shape(recs):
    """[(name, parent's name)] sorted."""
    return sorted((r.name, r.parent.name if r.parent else None) for r in recs)


def test_span_without_profiler_is_the_shared_null_context(monkeypatch):
    import torch

    from xlb_tpu_torch.utils import tracing

    window, (f_0, bc_mask, missing_mask) = _window("FP32BF16")
    before = tracing.records()

    def refuse(*args, **kwargs):
        raise AssertionError("a span with no profiler active reached the profiler, a clock or a CUDA event")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tracing.time, "perf_counter_ns", refuse)
    null = tracing.span("xlb.window", torch.device("cpu"))
    assert tracing.span("xlb.backward", torch.device("cuda")) is null
    assert tracing.wait("omega", torch.device("cuda")) is null
    assert tracing.wait("omega", torch.device("cpu")) is null
    with null, null:
        pass
    window(f_0, f_0, bc_mask, missing_mask, OMEGA)
    _train_step(window, (f_0, bc_mask, missing_mask))
    assert tracing.records() == before


@pytest.mark.parametrize("policy", POLICIES)
def test_window_spans_and_their_parents(policy, tmp_path):
    window, (f_0, bc_mask, missing_mask) = _window(policy)
    window(f_0, f_0, bc_mask, missing_mask, OMEGA)  # outside the session
    _, recs, prof = _profiled(lambda: window(f_0, f_0, bc_mask, missing_mask, OMEGA))
    want = [("xlb.window", None), ("xlb.window.pack_masks", "xlb.window"), ("xlb.window.sweep", "xlb.window")]
    if policy == "FP32BF16":  # the deviation shift in and out; on the CPU no copy waits
        want += [("xlb.window.shift_in", "xlb.window"), ("xlb.window.shift_out", "xlb.window")]
    assert _shape(recs) == sorted(want)
    assert all(r.device_ms is None and r.host_ms > 0 for r in recs)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    ranges = sorted(e["name"] for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("xlb."))
    assert ranges == sorted(name for name, _ in want)


@pytest.mark.parametrize("policy", POLICIES)
def test_training_step_spans_the_backward(policy):
    window, fields = _window(policy)
    _, recs, _ = _profiled(lambda: _train_step(window, fields))
    backward = [r for r in recs if r.name == "xlb.backward"]
    assert len(backward) == 1 and backward[0].parent is None
    kids = [r.name for r in recs if r.parent is backward[0]]
    assert sorted(kids) == ["xlb.backward.adjoint"] * STEPS + ["xlb.backward.replay"]
    assert sum(r.name == "xlb.window" for r in recs) == 1


@pytest.mark.parametrize("between", ["records", "unprofiled call"])
def test_two_profiled_stretches_keep_their_records_apart(between):
    from xlb_tpu_torch.utils import tracing

    window, (f_0, bc_mask, missing_mask) = _window("FP32FP32")
    _, first, _ = _profiled(lambda: window(f_0, f_0, bc_mask, missing_mask, OMEGA))
    kept = list(first)
    if between == "records":
        assert tracing.records() == first
    else:
        window(f_0, f_0, bc_mask, missing_mask, OMEGA)
    _, second, _ = _profiled(lambda: [window(f_0, f_0, bc_mask, missing_mask, OMEGA) for _ in range(2)])
    assert len(first) == 3 and first == kept
    assert len(second) == 6 and not {id(r) for r in first} & {id(r) for r in second}
    assert tracing.records() == second


@pytest.mark.parametrize("policy", POLICIES)
def test_outputs_and_gradients_are_the_same_when_profiled(policy):
    import torch

    window, fields = _window(policy)
    f_0, bc_mask, missing_mask = fields
    plain = window(f_0, f_0, bc_mask, missing_mask, OMEGA)[0], *_train_step(window, fields)
    traced, recs, _ = _profiled(lambda: (window(f_0, f_0, bc_mask, missing_mask, OMEGA)[0],
                                         *_train_step(window, fields)))
    assert recs
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)
