"""The readings that a cell's limits are set from, on the card at the
cell's own size, many seeds in one process:

    python3 -m lbm_bench.calibrate --workload <name> --seeds 1,2,3 --mode program|control|<fault> [--out FILE]

- ``program``: sound runs of the program (a window of no length: set-up
  and the checked window), their compared numbers;
- ``control``: the traffic's ``control`` in the program's place -- the
  program under a lower-precision policy of its own (``{"policy": ...}``),
  or the reference in a lower storage type (``{"reference_storage": ...}``)
  -- compared with the reference as a run would;
- a fault of ``lbm_bench.faults`` planted under the window.

Prints one JSON line per seed (and appends it to ``--out``). The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time

from lbm_bench import faults
from lbm_bench.bench import Cell, CudaSystem, run_cell

DEVICE = "cuda"


def reference_control(cell, seed, storage):
    """The reference in ``storage`` against the reference in the cell's
    storage, from the seeded populations (window 0)."""
    from lbm_bench import inputs

    cfg, p, lbm = cell.cfg, cell.traffic, cell.reference
    f_in = inputs.populations(lbm, tuple(cfg["shape"]), seed, 0, cfg["initial_flow"], DEVICE)
    lat = lbm.Lattice(cfg["shape"], cell.config.boundaries(cfg), DEVICE, cfg["velocity_set"], cfg["collision"])
    omega = cell.config.omega(cfg)
    ref = lbm.window(lat, f_in, p["steps"], omega, p["storage"])
    ctl = lbm.window(lat, f_in, p["steps"], omega, storage)
    return cell.mix.compare(ctl, ref, lbm.W)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--out")
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        cell = Cell(args.workload)
        control = cell.traffic.get("control", {})
        if args.mode == "control" and "reference_storage" in control:
            numbers = reference_control(cell, seed, control["reference_storage"])
        else:
            overrides = {"policy": control["policy"]} if args.mode == "control" else None
            system = CudaSystem()
            if args.mode not in ("program", "control"):
                system = faults.Planted(system, getattr(faults, args.mode))
            result, _ = run_cell(args.workload, seed, 0, 0, system, t, overrides=overrides)
            numbers = {k: v["value"] for k, v in result["checks"].items()}
        line = json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed, "numbers": numbers,
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
