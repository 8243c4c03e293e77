"""Shares of the traced stretch that the per-layer metrics read."""

from lbm_bench.roofline import least_seconds


def roofline_percent(run, family):
    """100 x the least time of the family's calls in the stretch over their
    device time, or None when none ran or the family has no count of the
    cell's work."""
    if run.trace is None:
        return None
    fam = run.families[family]
    least = spent = 0.0
    for name, s, e in run.trace.device:
        form = fam.matches(name)
        if form is None:
            continue
        work = fam.work(form, run.sizes)
        if work is None:
            return None
        least += least_seconds(*work)
        spent += e - s
    return 100.0 * least / spent if spent > 0 else None


def idle_percent(run):
    """100 x the share of the stretch in which no device operation ran, or
    None when the trace saw no device operation."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def other_percent(run, families):
    """100 x the device time of operations outside ``families`` over all
    device time in the stretch, or None when the trace saw none."""
    if run.trace is None or not run.trace.device:
        return None
    total = other = 0.0
    for name, s, e in run.trace.device:
        total += e - s
        if all(run.families[f].matches(name) is None for f in families):
            other += e - s
    return 100.0 * other / total if total > 0 else None
