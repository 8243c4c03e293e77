"""Copy-mechanism experiments: the port of
``examples/performance/dma_experiments.py`` through K10-K12.

    python -m xlb_tpu_torch.examples.performance.dma_experiments [--N 256] [--q 19]

On a (q, N, N, N) float32 array of ones, windows of ``iters`` calls, one
warm-up window, then the best of ``reps``, CUDA events:

  E   the library scale-copy ``torch.mul(x, 1.0000001, out=y)`` (the
      script's XLA baseline), and A0 the library copy ``y.copy_(x)``
  A   K10, the whole array through bulk copies (TMA) via shared memory
  A2  K11, the same split into q per-channel chains in one launch
  B, C, C2, D, D2  K12, the manually pipelined scale-copy, with the
      script's (ring depth, bulk loads per stage, manual output copy)

GB/s counts the array read and written.
"""

import argparse

from xlb_tpu_torch.examples.performance.common import best_window_ms, device_name, field, library_step, line
from xlb_tpu_torch.kernels.copy_bandwidth import MANUAL_VARIANTS, BulkCopy, ManualScaleCopy, SplitBulkCopy

# dma_experiments.py:175-181: the names of copy_bandwidth.MANUAL_VARIANTS' (depth, n_split, manual_out)
MANUAL_NAMES = ("B manual in+out db2", "C manual in db3", "C2 manual in db2", "D manual in 4-split",
                "D2 in db3 + man out")


def run(device="cuda", N=256, q=19, iters=50, reps=3):
    """Time each line; returns {"device", "shape", "bytes", "lines": {name:
    {"ms", "GBps"}}}."""
    x = field(N, q, device)
    nbytes = x.numel() * x.element_size()
    name = device_name(device)
    print(f"dma_experiments: {tuple(x.shape)} float32, {nbytes / 1e9:.3f} GB per array, {name}, "
          f"windows of {iters}, best of {reps}")
    steps = [("E library scale-copy", library_step("scale", x)), ("A0 library copy_", library_step("copy", x)),
             ("A bulk copy, 1 range (K10)", BulkCopy()), (f"A2 bulk copy, {q} ranges (K11)", SplitBulkCopy(q))]
    steps += [(f"{label} (K12)", ManualScaleCopy(*variant)) for label, variant in zip(MANUAL_NAMES, MANUAL_VARIANTS)]
    lines = {}
    for label, step in steps:
        ms, _ = best_window_ms(step, x.clone(), iters, reps)
        lines[label] = line(label, ms, nbytes)
    return {"device": name, "shape": tuple(x.shape), "bytes": nbytes, "lines": lines}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="copy-mechanism experiments through K10-K12")
    p.add_argument("--N", type=int, default=256)
    p.add_argument("--q", type=int, default=19)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    run(args.device, args.N, args.q, args.iters, args.reps)
