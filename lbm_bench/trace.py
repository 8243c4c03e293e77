"""A torch.profiler trace of a short stretch of the measured window, read
from its Chrome-trace export: the device's operations, the host's, and
the stretch itself (the ``lbm_bench.traced`` range, which starts after a
synchronize and ends in one)."""

import json
import os
import tempfile
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
RANGE = "lbm_bench.traced"


class Trace:
    """Device and host intervals (name, start, end) in seconds on the
    profiler's clock, and the traced stretch (start, end)."""

    def __init__(self, events):
        self.device, self.host, self.stretch = [], [], None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            iv = (e.get("name", ""), float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6)
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append(iv)
            elif cat in HOST_CATS:
                if iv[0] == RANGE and cat == "user_annotation":
                    self.stretch = iv[1:]
                else:
                    self.host.append(iv)
        if self.stretch is None:
            raise RuntimeError(f"the trace has no {RANGE!r} range")
        a, b = self.stretch
        self.device = sorted((iv for iv in self.device if iv[2] > a and iv[1] < b), key=lambda iv: iv[1])

    @property
    def window_s(self):
        return self.stretch[1] - self.stretch[0]

    def busy_intervals(self):
        """The union of the device's intervals inside the stretch, merged."""
        a, b = self.stretch
        out = []
        for _, s, e in self.device:
            s, e = max(s, a), min(e, b)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self):
        """(start, end) of the stretch's spans in which no device operation ran."""
        a, b = self.stretch
        gaps, t = [], a
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if b > t:
            gaps.append((t, b))
        return gaps

    def host_at(self, s, e):
        """The host operation that overlaps [s, e] most (the shortest on a tie)."""
        best = None
        for name, hs, he in self.host:
            ov = min(he, e) - max(hs, s)
            if ov > 0 and (best is None or (ov, hs - he) > best[0]):
                best = ((ov, hs - he), name)
        return best[1] if best else "(no host operation)"

    def breakdown(self, top=10):
        """{"device_ops": the operations that took most device time, summed by
        name, "idle_gaps": the longest idle gaps by the host operation they
        fell in}, each [[name, seconds], ...]."""
        by_name = {}
        for name, s, e in self.device:
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.host_at(s, e), e - s] for s, e in gaps]}


def short_name(name):
    """A kernel's name without its template and call arguments."""
    for stop in ("<", "("):
        if stop in name:
            name = name.split(stop, 1)[0]
    return name.replace("void ", "").strip()[:120]


@contextmanager
def profiled(sync):
    """Profile the body (CPU and CUDA activities) inside the ``lbm_bench.traced``
    range, with ``sync()`` at both of its ends; yields a holder whose
    ``trace`` is set on exit. The export goes through a temporary file,
    which is removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    holder = type("Traced", (), {"trace": None})()
    sync()
    with profile(activities=activities) as prof:
        with record_function(RANGE):
            yield holder
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    holder.trace = Trace(events)
