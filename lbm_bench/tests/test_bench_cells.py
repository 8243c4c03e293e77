"""``BENCHMARK.json``: every cell resolves to its files, and the names,
units, lengths and metric lists keep to the format's rules."""

import json
import re

import pytest

from lbm_bench.bench import ROOT, SPEC, Cell, kernel_families

SPEC_DATA = json.loads(SPEC.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC_DATA["workloads"]]


def test_top_level_keys():
    assert set(SPEC_DATA) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC_DATA["run_seconds"] <= 51 and isinstance(SPEC_DATA["run_seconds"], int)
    assert len(SPEC.read_bytes()) <= 64 * 1024
    for path in SPEC_DATA["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and (ROOT.parent / path).is_dir()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = Cell(cell)
    assert c.cfg["name"] == c.entry["config"] and c.limits and callable(c.mix.run) and callable(c.mix.check)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    reported = {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert m["moves"] in reported
        assert callable(c.metric_reader(m["name"]).read)


def test_names_units_and_lengths():
    entries = SPEC_DATA["configs"] + SPEC_DATA["workloads"] + SPEC_DATA["end_to_end"] + SPEC_DATA["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in SPEC_DATA["end_to_end"] + SPEC_DATA["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC_DATA["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC_DATA["workloads"]]
    assert len(pairs) == len(set(pairs)) and all(w["chips"] in (1, 4) for w in SPEC_DATA["workloads"])


def test_configs_and_layers():
    used = {w["config"] for w in SPEC_DATA["workloads"]}
    assert used == {c["name"] for c in SPEC_DATA["configs"]}
    files = [c["file"] for c in SPEC_DATA["configs"]]
    assert len(set(files)) == len(files) and all(f.startswith("lbm_bench/") for f in files)
    for c in SPEC_DATA["configs"]:
        data = json.loads((ROOT.parent / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
    for c in SPEC_DATA["configs"]:
        config = Cell(next(w["name"] for w in SPEC_DATA["workloads"] if w["config"] == c["name"]))
        # the configuration's lattice and collision are what both sides are built with
        assert config.cfg["velocity_set"] and config.cfg["collision"] and config.reference.Lattice


def test_every_metric_file_is_used():
    metrics = {p.name[:-3] for p in (ROOT / "metrics").glob("*.py")}
    assert metrics <= {m["name"] for m in SPEC_DATA["per_layer"]}


@pytest.mark.parametrize("family", sorted(kernel_families()))
def test_every_kernel_family_is_used(family):
    # its launch counters exist in the port, and a metric of BENCHMARK.json reads it
    import importlib

    fam = kernel_families()[family]
    for module, cls in fam.COUNTERS.values():
        kernel = getattr(importlib.import_module(module), cls)
        assert isinstance(kernel.launches, int) and isinstance(kernel.plain_calls, int)
    readers = [(ROOT / "metrics" / f"{m['name']}.py").read_text() for m in SPEC_DATA["per_layer"]]
    assert any(f'"{family}"' in src for src in readers)
