"""The readers of the port's spans (``spans.py`` and the metrics that use
it): None without the port's tracer, as on a checkout from before it;
None on the CPU run of each cell, whose trace has no device operation,
while the port's records are there (with no wait); and their arithmetic
on a stand-in stretch with device operations."""

import json
import sys
import time
from types import SimpleNamespace

import pytest

from lbm_bench import spans
from lbm_bench.bench import ROOT, SPEC, Cell, run_cell
from lbm_bench.tests.support import SMALL, CpuSystem
from lbm_bench.trace import RANGE, Trace

SPEC_DATA = json.loads(SPEC.read_text())
READERS = {m["name"]: m["workloads"] for m in SPEC_DATA["per_layer"]
           if "from lbm_bench import spans" in (ROOT / "metrics" / f"{m['name']}.py").read_text()}


def _event(name, cat, start_us, end_us):
    return {"ph": "X", "name": name, "cat": cat, "ts": start_us, "dur": end_us - start_us}


def _record(name, parent, device_ms):
    return SimpleNamespace(name=name, parent=parent, host_ms=1.0, device_ms=device_ms)


def _stretch(drop=None):
    """A stand-in stretch of 100 ms: two window calls, each with its sweep,
    and one backward with its replay and adjoint on the host; the card busy
    over [10, 30], [40, 60] and [70, 90] ms. ``drop``: a range left out."""
    ms = 1000
    host = [("xlb.window", 0, 15), ("xlb.window.sweep", 5, 14), ("xlb.window", 35, 45),
            ("xlb.window.sweep", 38, 44), ("xlb.backward", 60, 80), ("xlb.backward.replay", 61, 65),
            ("xlb.backward.adjoint", 66, 79)]
    host = [_event(RANGE, "user_annotation", 0, 100 * ms)] + [
        _event(n, "user_annotation", s * ms, e * ms) for n, s, e in host if n != drop]
    device = [_event("xlb::kstep_kernel", "kernel", 10 * ms, 30 * ms),
              _event("xlb::adjoint_kernel", "kernel", 40 * ms, 60 * ms),
              _event("at::native::elementwise_kernel", "kernel", 70 * ms, 90 * ms)]
    return SimpleNamespace(trace=Trace(host + device), spans={}, sizes={}, families={})


def test_nine_readers_read_the_spans():
    assert len(READERS) == 9


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_is_none_without_the_tracer(metric, monkeypatch):
    monkeypatch.setitem(sys.modules, "xlb_tpu_torch.utils.tracing", None)  # the import fails
    reader = Cell(READERS[metric][0]).metric_reader(metric)
    assert reader.read(_stretch()) is None


@pytest.mark.parametrize("cell", sorted({c for cells in READERS.values() for c in cells}))
def test_cpu_run_records_no_wait_and_reports_no_device_number(cell):
    # no card: no device operation in the trace, so no reader reports; the
    # port's records are there, with no wait (a CPU copy or read blocks on nothing)
    result, _ = run_cell(cell, 2**31 + 7, 0, 1, CpuSystem(), time.perf_counter(), overrides=SMALL[cell])
    assert result["correct"]
    assert not set(READERS) & set(result["metrics"])
    recs = spans.records()
    assert recs and any(r.name == spans.WINDOW for r in recs)
    assert not [r for r in recs if r.name.startswith(spans.WAIT)]


def test_readers_arithmetic_on_a_stand_in_stretch(monkeypatch):
    w1, w2, back = _record("xlb.window", None, 10.0), _record("xlb.window", None, 12.0), _record("xlb.backward", None, 30.0)
    recs = [_record("xlb.window.sweep", w1, 7.0), w1, _record("xlb.window.sweep", w2, 8.0), w2,
            _record("xlb.window.pack_masks", w1, 2.0), _record("xlb.wait.omega", w1, None),
            _record("xlb.backward.replay", back, 5.0), _record("xlb.backward.adjoint", back, 20.0), back]
    monkeypatch.setattr(spans, "records", lambda: recs)
    run = _stretch()
    # idle after the first device operation: [30, 40], [60, 70], [90, 100] ms; the gap
    # [0, 10] before it (the profiler's start) is left out, though the first window spans it
    assert spans.idle_gaps(run.trace) == [pytest.approx((0.03, 0.04)), pytest.approx((0.06, 0.07)),
                                          pytest.approx((0.09, 0.1))]
    assert spans.host_syncs(run) == 0.5
    # busy device ms: window 1 (10 - 0) - (7 - 0); window 2 (12 - 5) - (8 - 2)
    assert spans.glue_device_ms(run) == pytest.approx((3.0 + 1.0) / 2)
    # backward (30 - 10) - (5 - 4) - (20 - 4); over 60 ms busy
    assert spans.port_glue_share(run) == pytest.approx(100.0 * (3.0 + 1.0 + 3.0) / 60.0)
    # idle inside [0, 15], [35, 45], [60, 80]: 0 + 5 + 10 ms over two calls
    assert spans.port_idle_ms(run) == pytest.approx(15.0 / 2)
    assert spans.glue_device_ms(_stretch(drop="xlb.window.sweep")) is None  # ranges and records do not pair
    recs[0].device_ms = None
    assert spans.glue_device_ms(run) is None and spans.port_glue_share(run) is None


def test_a_stretch_busy_from_its_start_keeps_its_first_gap():
    ms = 1000
    tr = Trace([_event(RANGE, "user_annotation", 0, 100 * ms), _event("k", "kernel", 0, 20 * ms),
                _event("k", "kernel", 50 * ms, 100 * ms)])
    assert spans.idle_gaps(tr) == [pytest.approx((0.02, 0.05))]
