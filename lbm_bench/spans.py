"""The port's own spans in the traced stretch (``xlb_tpu_torch.utils.
tracing``), as the per-layer metrics read them: its records (host and
device milliseconds, parent) and its ``xlb.*`` ranges in the profiler's
trace. Each reading is None when the port has no tracer (a checkout from
before it), recorded nothing in the stretch, or the trace has no device
operation (the CPU).

Idle time is counted from the stretch's first device operation on. The
stretch opens on an idle card after a synchronize, and the first CUDA
call after the profiler starts holds the host for some milliseconds:
that first gap is the profiler's, and a run without it has none."""

import importlib

WINDOW, SWEEP = "xlb.window", "xlb.window.sweep"
BACKWARD, KERNELS_BACK = "xlb.backward", ("xlb.backward.replay", "xlb.backward.adjoint")
WAIT = "xlb.wait."


def records():
    """The port's records of the last profiler session, or None."""
    try:
        tracing = importlib.import_module("xlb_tpu_torch.utils.tracing")
    except ImportError:
        return None
    return tracing.records() or None


def idle_gaps(tr):
    """The stretch's idle gaps (start, end) after its first device operation."""
    gaps = tr.idle_gaps()
    return gaps[1:] if gaps and gaps[0][0] <= tr.stretch[0] else gaps


def idle_within(gaps, s, e):
    """Seconds of ``gaps`` inside [s, e]."""
    return sum(max(0.0, min(ge, e) - max(gs, s)) for gs, ge in gaps)


def host_syncs(run):
    """Blocking host syncs (``xlb.wait.*`` records) per window call."""
    recs = records()
    if run.trace is None or not run.trace.device or recs is None:
        return None
    calls = sum(r.name == WINDOW for r in recs)
    return sum(r.name.startswith(WAIT) for r in recs) / calls if calls else None


def busy_ms(tr, recs, names):
    """{id(record): its device ms less the idle device ms while the host was
    inside its range in the trace} for the records named in ``names``; None
    where one lacks a device extent or a name's records and ranges do not
    pair (the n-th record of a name is its n-th range: such spans never
    overlap). The span's CUDA events take the time between its ends, and
    the card is idle inside it only while the host is."""
    gaps, out = idle_gaps(tr), {}
    for name in names:
        rs = [r for r in recs if r.name == name]
        ranges = sorted((s, e) for n, s, e in tr.host if n == name)
        if len(rs) != len(ranges) or any(r.device_ms is None for r in rs):
            return None
        for r, (s, e) in zip(rs, ranges):
            out[id(r)] = r.device_ms - 1e3 * idle_within(gaps, s, e)
    return out


def outside(tr, recs, name, inner):
    """[busy device ms of each ``name`` record less those of its children
    named in ``inner``], or None (``busy_ms``)."""
    busy = busy_ms(tr, recs, (name,) + inner)
    if busy is None:
        return None
    return [busy[id(r)] - sum(busy[id(k)] for k in recs if k.parent is r and k.name in inner)
            for r in recs if r.name == name]


def glue_device_ms(run):
    """Busy device ms per window call outside its kernel sweep: the mask
    packing, the storage shifts; not the card's waits on the host."""
    recs = records()
    if run.trace is None or recs is None or not run.trace.device:
        return None
    per_call = outside(run.trace, recs, WINDOW, (SWEEP,))
    return sum(per_call) / len(per_call) if per_call else None


def port_glue_share(run):
    """100 x the busy device ms of the window calls outside their sweeps and
    of the reverse sweeps outside their replay and adjoint kernels, over the
    stretch's busy device time."""
    recs = records()
    if run.trace is None or recs is None or not run.trace.device:
        return None
    fwd, bwd = outside(run.trace, recs, WINDOW, (SWEEP,)), outside(run.trace, recs, BACKWARD, KERNELS_BACK)
    busy = run.trace.busy_s()
    if not fwd or not bwd or busy <= 0:
        return None
    return 100.0 * (sum(fwd) + sum(bwd)) / (busy * 1e3)


def port_idle_ms(run):
    """Idle device ms per window call in which the host was inside the port:
    the idle gaps after the stretch's first device operation where they
    overlap the trace's ``xlb.window`` and ``xlb.backward`` ranges."""
    tr = run.trace
    if tr is None or records() is None or not tr.device:
        return None
    calls = sum(name == WINDOW for name, _, _ in tr.host)
    if not calls:
        return None
    ranges = []
    for s, e in sorted((s, e) for name, s, e in tr.host if name in (WINDOW, BACKWARD)):
        if ranges and s <= ranges[-1][1]:
            ranges[-1][1] = max(ranges[-1][1], e)
        else:
            ranges.append([s, e])
    gaps = idle_gaps(tr)
    return sum(idle_within(gaps, s, e) for s, e in ranges) * 1e3 / calls
