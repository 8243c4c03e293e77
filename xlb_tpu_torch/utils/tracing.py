"""Spans of the port's phases, on the profiler's clock.

``span(name, device=None)`` wraps one phase of the port: a window call,
its mask packing, its kernel sweep, the reverse sweep, a blocking host
sync. With no ``torch.profiler`` session active, as in every run that
does not profile, it returns one shared null context: no clock read, no
``record_function``, no record, no CUDA event. Inside a session a span
enters ``torch.profiler.record_function(name)``, so the phase sits in the
profiler's trace as a ``user_annotation`` range on the clock of the
device's operations, and it keeps a record: its name, the span it is
nested in, its host interval (``time.perf_counter_ns``) and, when
``device`` is a CUDA device, a pair of timing events recorded on that
device's current stream at entry and exit.

``wait(site, device)`` is ``span("xlb.wait.<site>")`` around a call that
blocks the host until a CUDA device is done, and the null context
elsewhere.

``records()`` gives the records of the current or last session, their
device extents resolved after one synchronize. A session's records start
when a span finds the profiler on after the last span, or the last call
of ``records()``, found it off: torch keeps no handle of the active
session, only whether one is active. So call ``records()`` after each
session; two sessions back to back, with no span of the port and no
``records()`` between them, read as one.
"""

import threading
import time
from contextlib import nullcontext

import torch
from torch.autograd import profiler as _profiler

_NULL = nullcontext()
_open = threading.local()  # the spans open on this thread, innermost last
_records = []
_in_session = False


class Record:
    """One finished span: ``name``, ``parent`` (the record of the span it
    was nested in on its thread, or None), ``host_ms``, and ``device_ms``
    (the device's time between its two events; None without a CUDA
    device)."""

    __slots__ = ("name", "parent", "host_ms", "device_ms", "_events")

    def __init__(self, name, parent):
        self.name, self.parent = name, parent
        self.host_ms = self.device_ms = self._events = None


class _Span:
    __slots__ = ("record", "device", "range", "t0")

    def __init__(self, name, device):
        self.record = Record(name, None)
        self.device = device if device is not None and device.type == "cuda" else None

    def __enter__(self):
        rec, stack = self.record, _stack()
        rec.parent = stack[-1] if stack else None
        stack.append(rec)
        self.range = torch.profiler.record_function(rec.name)
        self.range.__enter__()
        if self.device is not None:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
            rec._events = (self.device, start, end)
        self.t0 = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.record
        rec.host_ms = (time.perf_counter_ns() - self.t0) / 1e6
        if rec._events is not None:
            device, _, end = rec._events
            end.record(torch.cuda.current_stream(device))
        self.range.__exit__(*exc)
        _stack().pop()
        _records.append(rec)
        return False


def _stack():
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def span(name, device=None):
    """A context manager around one phase of the port: the shared null
    context when no profiler session is active, else a ``record_function``
    range that keeps a record (with CUDA timing events when ``device`` is
    a CUDA device)."""
    global _in_session, _records
    if not _profiler._is_profiler_enabled:
        _in_session = False
        return _NULL
    if not _in_session:
        _in_session, _records = True, []
    return _Span(name, device)


def records():
    """The records of the current or last profiler session (see the
    module's note on two sessions back to back), in the order the spans
    ended, each with ``host_ms``, ``device_ms`` (None on the
    CPU) and ``parent``. Resolving device extents synchronizes the devices
    the spans ran on, once."""
    global _in_session
    if not _profiler._is_profiler_enabled:
        _in_session = False
    out = list(_records)
    pending = [r for r in out if r._events is not None]
    for device in {r._events[0] for r in pending}:
        torch.cuda.synchronize(device)
    for r in pending:
        _, start, end = r._events
        r.device_ms, r._events = start.elapsed_time(end), None
    return out


def wait(site, device):
    """``span("xlb.wait.<site>")`` around a call that blocks the host until
    the device is done (a read-back, a copy from pageable host memory),
    when ``device`` is a CUDA device; else the null context."""
    if device.type != "cuda":
        return _NULL
    return span("xlb.wait." + site)
