"""The copy-bandwidth probes (K9-K12): wrappers of the CUDA kernels of
``csrc/copy_bandwidth.cu`` and their plain versions.

They are the counterparts of the Pallas kernels of
``examples/performance/``:

- ``PipelinedCopy`` (K9, ``memory_bandwidth.py::copy_kernel``): a copy of
  16-byte words, ``per_thread`` words a thread, ``threads`` a block -- the
  card's launch shapes in place of the script's three TPU blockings;
- ``BulkCopy`` (K10, ``dma_experiments.py::hbm2hbm_kernel``): the whole
  array through bulk copies (TMA) via shared memory, chunk by chunk over a
  persistent grid;
- ``SplitBulkCopy(q)`` (K11, ``hbm2hbm_q_kernel``): the same, each of the q
  channel slices its own chain of bulk copies, all the slices' chunks one
  chunk space in one launch;
- ``ManualScaleCopy(depth, n_split, manual_out)`` (K12, ``make_manual``):
  ``x * float32(1.0000001)`` through a ring of ``depth`` shared-memory
  stages, each filled by ``n_split`` bulk loads, with bulk stores of the
  result when ``manual_out``.

Each takes any contiguous float32 tensor (of ``shape`` when given) and
returns a new one. For a CUDA tensor it launches its kernel (the output
shares the input's address modulo 16 bytes, as the kernels' bulk copies
need); for a CPU tensor it runs its plain version; any other device
raises.
"""

import ctypes

import torch

from xlb_tpu_torch.kernels import _cuda

SCALE = 1.0000001  # dma_experiments.py's jnp.float32(1.0000001)
# the launch shapes K9 is built for (csrc/copy_bandwidth.cu, has_vector)
VECTOR_PER_THREAD = (1, 4, 8)
# K12's variants (has_manual), dma_experiments.py's five: (ring depth, bulk
# loads per stage, manual output copy)
MANUAL_VARIANTS = ((2, 1, True), (3, 1, False), (2, 1, False), (2, 4, False), (3, 1, True))
# the bulk copies' chunk in bytes (kBulkChunk of csrc/copy_bandwidth.cu; a CPU test holds them equal)
BULK_CHUNK = 8192


def copy_plain(x):
    """The plain version of K9-K11: ``out = x``."""
    return x.clone()


def scale_copy_plain(x):
    """The plain version of K12: ``out = x * float32(1.0000001)``."""
    return x * torch.tensor(SCALE, dtype=torch.float32)


def like_aligned(x):
    """An empty tensor of ``x``'s shape whose address matches ``x``'s
    modulo 16 bytes (a view into a slightly longer allocation)."""
    lead = (x.data_ptr() % 16) // x.element_size()
    buf = torch.empty(x.numel() + lead, dtype=x.dtype, device=x.device)
    return buf[lead:].view(x.shape)


class CopyKernel:
    """Shared wrapper logic: input checks, device dispatch and the launch
    counters. Subclasses define ``launches`` and ``plain_calls``, ``plain``,
    ``variant`` (the ``xlb_copy_has_variant`` query) and ``_launch``."""

    kernel_id = None

    def __init__(self, shape=None):
        self.shape = None if shape is None else tuple(int(s) for s in shape)

    def _check(self, x):
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{type(self).__name__} runs on CUDA (kernel) or CPU (plain version), not {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{type(self).__name__} copies float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{type(self).__name__} takes a contiguous tensor")
        if x.numel() == 0:
            raise ValueError(f"{type(self).__name__} takes a non-empty tensor")
        if self.shape is not None and tuple(x.shape) != self.shape:
            raise ValueError(f"{type(self).__name__} was built for shape {self.shape}, got {tuple(x.shape)}")
        if x.requires_grad:
            raise RuntimeError(f"{type(self).__name__} has no autograd")

    def __call__(self, x):
        self._check(x)
        if x.device.type == "cpu":
            return self.plain(x)
        lib = _cuda.load_library()
        if not lib.xlb_copy_has_variant(self.kernel_id, *self.variant):
            raise NotImplementedError(f"{type(self).__name__}: no CUDA instantiation of {self.variant}")
        with torch.cuda.device(x.device):
            out = like_aligned(x)
            err = self._launch(lib, x, out, torch.cuda.current_stream(x.device).cuda_stream)
        _cuda.check(lib, err, f"{type(self).__name__} launch")
        type(self).launches += 1
        return out


class PipelinedCopy(CopyKernel):
    """K9: ``out = x``, ``per_thread`` 16-byte words per thread and
    ``threads`` threads per block (``4 x per_thread`` floats a thread)."""

    launches = 0
    plain_calls = 0
    kernel_id = 9

    def __init__(self, threads=256, per_thread=4, shape=None):
        super().__init__(shape)
        if per_thread not in VECTOR_PER_THREAD:
            raise NotImplementedError(f"PipelinedCopy is built for {VECTOR_PER_THREAD} words per thread, got {per_thread}")
        if not (32 <= threads <= 1024 and threads % 32 == 0):
            raise ValueError(f"threads must be a multiple of 32 in [32, 1024], got {threads}")
        self.threads, self.per_thread = int(threads), int(per_thread)
        self.variant = (self.per_thread, 0, 0)

    @property
    def label(self):
        return f"{self.threads} threads x {4 * self.per_thread} floats"

    def plain(self, x):
        PipelinedCopy.plain_calls += 1
        return copy_plain(x)

    def _launch(self, lib, x, out, stream):
        return lib.xlb_copy_vector(x.data_ptr(), out.data_ptr(), x.numel(), self.threads, self.per_thread, stream)


class BulkCopy(CopyKernel):
    """K10: ``out = x`` through bulk copies, the whole array as one range."""

    launches = 0
    plain_calls = 0
    kernel_id = 10
    variant = (0, 0, 0)

    def plain(self, x):
        BulkCopy.plain_calls += 1
        return copy_plain(x)

    def _launch(self, lib, x, out, stream):
        return lib.xlb_copy_bulk(x.data_ptr(), out.data_ptr(), x.numel(), 1, stream)


class SplitBulkCopy(CopyKernel):
    """K11: ``out = x`` for an x of q channels (its leading dimension),
    each channel slice its own chain of bulk copies."""

    launches = 0
    plain_calls = 0
    kernel_id = 11
    variant = (0, 0, 0)

    def __init__(self, q, shape=None):
        super().__init__(shape)
        if not 1 <= int(q) <= 65535:
            raise ValueError(f"q must be in [1, 65535], got {q}")
        self.q = int(q)

    def _check(self, x):
        super()._check(x)
        if x.dim() < 1 or x.shape[0] != self.q:
            raise ValueError(f"SplitBulkCopy({self.q}) takes a tensor of {self.q} channels, got {tuple(x.shape)}")

    def plain(self, x):
        SplitBulkCopy.plain_calls += 1
        return copy_plain(x)

    def _launch(self, lib, x, out, stream):
        return lib.xlb_copy_bulk(x.data_ptr(), out.data_ptr(), x.numel() // self.q, self.q, stream)


class ManualScaleCopy(CopyKernel):
    """K12: ``out = x * float32(1.0000001)`` through a ring of ``depth``
    stages, each filled by ``n_split`` bulk loads; ``manual_out``: the
    result leaves through bulk stores from shared memory."""

    launches = 0
    plain_calls = 0
    kernel_id = 12

    def __init__(self, depth=2, n_split=1, manual_out=False, shape=None):
        super().__init__(shape)
        if (depth, n_split, bool(manual_out)) not in MANUAL_VARIANTS:
            raise NotImplementedError(f"ManualScaleCopy is built for (depth, n_split, manual_out) in "
                                      f"{MANUAL_VARIANTS}, got {(depth, n_split, manual_out)}")
        self.depth, self.n_split, self.manual_out = int(depth), int(n_split), bool(manual_out)
        self.variant = (self.depth, self.n_split, int(self.manual_out))

    def plain(self, x):
        ManualScaleCopy.plain_calls += 1
        return scale_copy_plain(x)

    def _launch(self, lib, x, out, stream):
        return lib.xlb_copy_manual_scale(x.data_ptr(), out.data_ptr(), x.numel(), self.depth, self.n_split,
                                         int(self.manual_out), stream)


def bulk_shape(device=None):
    """The launch shape of K10 / K11 on a card: (resident blocks per SM,
    shared memory per block in bytes)."""
    lib = _cuda.load_library()
    per_sm, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = lib.xlb_copy_bulk_shape(ctypes.byref(per_sm), ctypes.byref(smem))
    _cuda.check(lib, err, "xlb_copy_bulk_shape")
    return per_sm.value, smem.value


KERNELS = (PipelinedCopy, BulkCopy, SplitBulkCopy, ManualScaleCopy)


def counts(reset=False):
    """{kernel class name: (launches, plain calls)} of K9-K12; ``reset``
    sets them to 0 first."""
    if reset:
        for k in KERNELS:
            k.launches = k.plain_calls = 0
    return {k.__name__: (k.launches, k.plain_calls) for k in KERNELS}
