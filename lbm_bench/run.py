"""Run one cell of ``BENCHMARK.json`` once, on the card of this machine:

    python3 -m lbm_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the card's name and power limit on standard error first, the
compared numbers beside their limits as its last lines, and one JSON
object as the last line of standard output. Exits non-zero, printing no
result, without a CUDA card (or with fewer than the cell asks for), and
when a module of JAX, Flax or the JAX package is loaded at the end.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def power_limit():
    """(name, power limit) of the card as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from lbm_bench.bench import Cell, CudaSystem, forbidden_modules, run_cell

    chips = int(Cell(args.workload).entry["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"lbm_bench: needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    print(f"card: {power_limit() or torch.cuda.get_device_name(0)} (name, power.limit)", file=sys.stderr, flush=True)
    result, lines = run_cell(args.workload, args.seed, args.seconds, args.trace, CudaSystem(), T_START, chips=chips)
    loaded = forbidden_modules()
    if loaded:
        print(f"lbm_bench: modules of JAX or the JAX package were loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
