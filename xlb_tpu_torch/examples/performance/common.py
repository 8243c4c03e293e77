"""Timing shared by the copy-bandwidth probes: every call reads its input
from device memory (the window feeds each call's output to the next, so
two buffers of the array ping-pong, and at the scripts' size both are far
larger than the 50 MB L2)."""

import time

import torch

from xlb_tpu_torch.kernels.copy_bandwidth import SCALE


def field(N, q, device):
    """The scripts' field: ones of (q, N, N, N) float32."""
    return torch.ones((q, N, N, N), dtype=torch.float32, device=device)


def device_name(device):
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def library_step(kind, x):
    """One PyTorch call as a window step: "scale" is ``torch.mul(v, s,
    out=y)`` (the scripts' XLA scale-copy), "copy" is ``y.copy_(v)`` (the
    copy engine); the two buffers swap after each call."""
    spare = [torch.empty_like(x)]
    s = torch.tensor(SCALE, dtype=torch.float32, device=x.device)

    def step(v):
        y = spare[0]
        if kind == "scale":
            torch.mul(v, s, out=y)
        else:
            y.copy_(v)
        spare[0] = v
        return y

    return step


def best_window_ms(step, x, iters, reps):
    """ms per call of ``x = step(x)`` over windows of ``iters`` calls: one
    warm-up window, then the best of ``reps``; CUDA events on the card, the
    host clock on the CPU. Returns (ms, the last output)."""
    def window(v):
        for _ in range(iters):
            v = step(v)
        return v

    cuda = x.device.type == "cuda"
    x = window(x)
    if cuda:
        torch.cuda.synchronize(x.device)
    best = float("inf")
    for _ in range(reps):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            x = window(x)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            x = window(x)
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best / iters, x


def interleaved_ms(steps, x, iters, rounds):
    """{name: ms per call} of each of ``steps`` ({name: step}) on the card,
    in windows of ``iters`` calls of ``v = step(v)`` from ``x``, the steps
    taking turns: one warm-up round, then ``rounds`` rounds, forward and
    backward in turn, each step's best window kept (CUDA events)."""
    best, order = {}, list(steps.items())
    for r in range(rounds + 1):
        for name, step in (order if r % 2 == 0 else order[::-1]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            v = x
            start.record()
            for _ in range(iters):
                v = step(v)
            end.record()
            end.synchronize()
            if r > 0:
                best[name] = min(best.get(name, float("inf")), start.elapsed_time(end) / iters)
            del v
    return best


def line(name, ms, nbytes):
    """Print and return one probe's line: ms per call and GB/s, counting
    the array read once and written once."""
    gbps = 2 * nbytes / (ms * 1e-3) / 1e9
    print(f"{name}: {ms:.3f} ms -> {gbps:.0f} GB/s")
    return {"ms": ms, "GBps": gbps}
