"""The harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel family sits in a file of its own, found by its name:

- ``configs/<config>.json`` (the configuration as it is run: sizes,
  lattice, collision, parameters, source, ``assumed``, ``reduced``) and
  ``configs/<config>.py`` (its boundary list, the port's scene built from
  it, omega, and ``REFERENCE``: the plain reference it is checked
  against);
- ``traffic/<traffic>.json``: the mix that drives the measured window
  (``"mix"``) and its parameters;
- ``mixes/<mix>.py``: ``run(ctx)`` measures and returns the materials of
  the check, ``check(ctx, materials)`` compares them with the reference;
- ``limits/<workload>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: ``read(run)``, a per-layer metric or None;
- ``kernels/<family>.py``: a family's profiler names, its launch
  counters in the port and its work per call.

A later cell, mix, metric or kernel family comes as new files and
entries. An end-to-end metric ``<quantity>.<part>`` reports the mix's
``<quantity>`` in the cells it lists, so that cells whose runs spread
differently can hold one quantity to bounds of their own. The program
under test is ``xlb_tpu_torch``; the benchmark takes from it only the
system, its kernels' names in the profiler's trace and its launch
counters.
"""

import functools
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPEC = ROOT.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "xlb_tpu")


def load_module(path, tag):
    """The Python file at ``path`` as a module (its name may hold dots)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = "lbm_bench_" + tag + "_" + "".join(ch if ch.isalnum() else "_" for ch in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path):
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One workload of ``BENCHMARK.json`` and the files it resolves to."""

    def __init__(self, workload, spec=None, overrides=None):
        spec = spec or read_json(SPEC)
        entries = {w["name"]: w for w in spec["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in {SPEC.name}")
        self.name = workload
        self.entry = entries[workload]
        config = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        self.cfg = read_json(ROOT.parent / config["file"])
        self.config = load_module(ROOT / "configs" / f"{config['name']}.py", "config")
        self.reference = importlib.import_module(self.config.REFERENCE)
        self.traffic = read_json(ROOT / "traffic" / f"{self.entry['traffic']}.json")
        self.mix = load_module(ROOT / "mixes" / f"{self.traffic['mix']}.py", "mix")
        self.limits = read_json(ROOT / "limits" / f"{workload}.json")
        for key, value in (overrides or {}).items():  # tests: a small shape, a short window
            (self.cfg if key in self.cfg else self.traffic)[key] = value
        self.end_to_end = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]

    def metric_reader(self, name):
        return load_module(ROOT / "metrics" / f"{name}.py", "metric")


@functools.cache
def kernel_families():
    """{family name: module} of every file under ``kernels/``."""
    return {p.stem: load_module(p, "kernels") for p in sorted((ROOT / "kernels").glob("*.py"))
            if not p.name.startswith("_")}


class CudaSystem:
    """The program on the card: the CUDA tier's scene and window."""

    device = "cuda"

    def scene(self, config, cfg, boundaries, policy):
        return config.program_scene(cfg, boundaries, policy, self.device, "CUDA")

    def window(self, stepper, steps):
        return stepper.build_multi_step(steps)

    def sync(self):
        import torch

        torch.cuda.synchronize()

    def event(self):
        """A marker of the work enqueued so far, with ``synchronize()``."""
        import torch

        event = torch.cuda.Event()
        event.record()
        return event

    def memory_peak(self):
        import torch

        return int(torch.cuda.max_memory_allocated())

    def counters(self):
        return launch_counters("launches")

    def device_info(self, chips):
        import torch

        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def launch_counters(field):
    """{family: {form: the ``field`` counter of its kernel class}} of the
    port's kernel wrappers that the kernel families name."""
    out = {}
    for family, mod in kernel_families().items():
        out[family] = {}
        for form, (module, cls) in mod.COUNTERS.items():
            out[family][form] = int(getattr(getattr(importlib.import_module(module), cls), field))
    return out


def counter_delta(after, before):
    """{family: {form: launches}} from ``before`` to ``after``."""
    return {f: {k: v - before.get(f, {}).get(k, 0) for k, v in forms.items()} for f, forms in after.items()}


def sizes(cfg, traffic, boundaries, launches):
    """What the kernel families work out a call's bytes and operations
    from: the configuration's shape, lattice and collision, the traffic's
    storage and steps per window call, the launches of one window call,
    and the voxels and channels of every boundary with a per-voxel
    profile."""
    profiled = [b for b in boundaries if "profile" in b]
    return {"shape": list(cfg["shape"]), "velocity_set": cfg["velocity_set"], "collision": cfg["collision"],
            "storage": traffic["storage"], "steps": int(traffic["steps"]), "launches": launches,
            "profile_voxels": [int(b["indices"].shape[1]) for b in profiled],
            "profile_channels": [int(len(b["profile"])) for b in profiled]}


class Context:
    """What a mix sees of its run: the cell's files, the seed, the window's
    length, whether to trace, the system, and the spans it records."""

    def __init__(self, cell, seed, seconds, trace, system):
        self.cfg, self.config, self.traffic, self.reference = cell.cfg, cell.config, cell.traffic, cell.reference
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.system = system
        self.spans = {}
        self.gc = {"collections": 0, "seconds": 0.0, "longest_s": 0.0}
        self._gc_at = None

    def start_window(self):
        """End set-up and start the measured window: wait for the card,
        collect the set-up's garbage and freeze what survives, so that a
        collection in the window does not scan the set-up's objects while
        the card waits for the host; count the window's collections from
        here. Returns the start on ``time.perf_counter``'s clock."""
        self.system.sync()
        gc.collect()
        gc.freeze()
        gc.callbacks.append(self._time_gc)
        return time.perf_counter()

    def end_window(self):
        """Stop counting collections and thaw the set-up's objects."""
        if self._time_gc in gc.callbacks:
            gc.callbacks.remove(self._time_gc)
        gc.unfreeze()

    def _time_gc(self, phase, info):
        if phase == "start":
            self._gc_at = time.perf_counter()
        elif self._gc_at is not None:
            pause = time.perf_counter() - self._gc_at
            self.gc["collections"] += 1
            self.gc["seconds"] += pause
            self.gc["longest_s"] = max(self.gc["longest_s"], pause)

    @contextmanager
    def span(self, name):
        """Record the seconds of the body, ending in a synchronize."""
        t = time.perf_counter()
        yield
        self.system.sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t)


class RunView:
    """What a per-layer metric's reader sees: the spans, the trace, the
    kernel families and the cell's sizes (``sizes``)."""

    def __init__(self, ctx, measured, families):
        self.spans = ctx.spans
        self.trace = measured.get("trace")
        self.sizes = measured.get("sizes", {})
        self.families = families


def run_cell(workload, seed, seconds, trace, system, t_start, chips=1, overrides=None):
    """One run: returns (the result's dict, its lines for standard error).
    ``t_start``: the process's start on ``time.perf_counter``'s clock."""
    cell = Cell(workload, overrides=overrides)
    ctx = Context(cell, seed, seconds, trace, system)
    try:
        measured, materials = cell.mix.run(ctx)
    finally:
        ctx.end_window()
    setup_s = measured["first_step_at"] - t_start
    peak = system.memory_peak()
    t = time.perf_counter()
    numbers = cell.mix.check(ctx, materials)
    check_s = time.perf_counter() - t
    del materials
    checks = {name: {"value": float(numbers[name]), "limit": float(limit)} for name, limit in cell.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if trace:
        view = RunView(ctx, measured, kernel_families())
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(measured["end_to_end"], setup_s=setup_s)
        for m in cell.end_to_end:
            value = values[m["name"]] if m["name"] in values else values[m["name"].split(".")[0]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = dict(system.device_info(chips), memory_peak_bytes=peak)
    result = {"correct": correct, "attempted": int(measured["attempted"]), "failed": 0 if correct else 1,
              "metrics": metrics, "device": device}
    tr = measured.get("trace")
    if trace and tr is not None:
        device["busy_s"], device["window_s"] = tr.busy_s(), tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    lines = [f"launches in set-up {json.dumps(measured.get('launches', {}))}; set-up {setup_s:.2f} s; "
             f"spans {json.dumps({k: v[:3] for k, v in ctx.spans.items()})}; the check's reference {check_s:.2f} s; "
             f"garbage collections in the window {json.dumps(ctx.gc)}"]
    lines += [f"check {n}: {c['value']!r} (limit {c['limit']!r})" for n, c in checks.items()]
    return result, lines


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})
