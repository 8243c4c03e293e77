"""Device-memory bandwidth probe: the library scale-copy against K9, the
port of ``examples/performance/memory_bandwidth.py``.

    python -m xlb_tpu_torch.examples.performance.memory_bandwidth [--N 256] [--q 19]

On a (q, N, N, N) float32 array of ones (19 x 256^3: 1.275 GB), windows of
``iters`` calls, one warm-up window, then the best of ``reps``, CUDA
events: ``torch.mul(x, 1.0000001, out=y)`` (the script's XLA scale-copy),
``y.copy_(x)`` (the copy engine), and K9 (``PipelinedCopy``) under three
launch shapes, which stand in for the script's three TPU blockings: threads
per block x floats per thread. GB/s counts the array read and written.
"""

import argparse

from xlb_tpu_torch.examples.performance.common import best_window_ms, device_name, field, library_step, line
from xlb_tpu_torch.kernels.copy_bandwidth import PipelinedCopy

# K9's launch shapes: (threads per block, 16-byte words per thread)
LAUNCH_SHAPES = ((128, 1), (256, 4), (512, 8))


def run(device="cuda", N=256, q=19, iters=200, reps=3):
    """Time each line; returns {"device", "shape", "bytes", "lines": {name:
    {"ms", "GBps"}}}."""
    x = field(N, q, device)
    nbytes = x.numel() * x.element_size()
    name = device_name(device)
    print(f"memory_bandwidth: {tuple(x.shape)} float32, {nbytes / 1e9:.3f} GB per array, {name}, "
          f"windows of {iters}, best of {reps}")
    lines = {}
    for label, step in (("library scale-copy (torch.mul, out=)", library_step("scale", x)),
                        ("library copy (Tensor.copy_)", library_step("copy", x))):
        ms, _ = best_window_ms(step, x.clone(), iters, reps)
        lines[label] = line(label, ms, nbytes)
    for threads, per_thread in LAUNCH_SHAPES:
        kernel = PipelinedCopy(threads, per_thread)
        label = f"K9 copy, {kernel.label}"
        ms, _ = best_window_ms(kernel, x.clone(), iters, reps)
        lines[label] = line(label, ms, nbytes)
    return {"device": name, "shape": tuple(x.shape), "bytes": nbytes, "lines": lines}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="device-memory bandwidth: library scale-copy and copy against K9")
    p.add_argument("--N", type=int, default=256)
    p.add_argument("--q", type=int, default=19)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    run(args.device, args.N, args.q, args.iters, args.reps)
