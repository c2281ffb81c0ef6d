"""The RMS-norm kernel on the card — the counterpart of
``repro.kernels.rmsnorm``.

``rmsnorm`` launches ``csrc/rmsnorm.cu``: ``x (..., D) x scale (D,) ->
(..., D)`` in x's dtype, with the statistics in f32, 16-byte loads and
stores and the row read from device memory once (see the source's
header). ``plan(D, dtype)`` picks the kernel's form: one block a row
with 2 or 4 vectors of 16 bytes a thread, or, for rows longer than
4,096 vectors, one block that reads the row twice. The Pallas version
tiles rows in ``block_rows`` and pads the ragged tail; here every row is
its own block, so there is no padding.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream, and
raises on a launch error. ``repro_torch.kernels.ops`` picks it for CUDA
tensors and the plain version for CPU tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PER_VECTOR = {torch.float32: 4, torch.bfloat16: 8}   # values in 16 bytes
FORMS = {"block": 0, "stream": 1}
BLOCK_VECTORS = (2, 4)  # vectors a thread keeps, block form
MAX_THREADS = 1024
MAX_D = 65_536          # the wrapper's limit (the stream form has none)


class Plan(NamedTuple):
    form: str           # "block" or "stream"
    vectors: int        # 16-byte vectors a thread keeps in registers
    threads: int        # threads a block


@functools.lru_cache(maxsize=None)
def plan(D: int, dtype: torch.dtype) -> Plan:
    """The kernel's form for rows of D values of ``dtype``, with n = the
    row's whole 16-byte vectors (8 bf16 or 4 f32 values each): one block
    a row, 2 vectors a thread while 1,024 threads cover it (16,384 bf16
    or 8,192 f32 values), then 4, in as few warps as cover the row (one
    for n <= 64); a longer row goes to 1,024 threads that read it twice.
    Few vectors a thread keep the registers low and the SM full (PERF.md
    §6)."""
    n = D // _PER_VECTOR[dtype]
    for v in BLOCK_VECTORS:
        if n <= MAX_THREADS * v:
            return Plan("block", v, 32 * max(1, -(-n // (32 * v))))
    return Plan("stream", 1, MAX_THREADS)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * scale`` on the card. The checks
    read plain ints where they can: at (4, 2048, 1,600) bf16 the kernel
    takes ~19 µs on an H100 and the call's host time is about as long
    (PERF.md §6)."""
    dev = x.get_device()                     # -1 for a CPU tensor
    if dev < 0 or scale.get_device() != dev:
        raise ValueError(
            f"rmsnorm runs on one CUDA device: x on {x.device}, scale on "
            f"{scale.device}")
    D = x.shape[-1] if x.dim() else 0
    if D == 0 or scale.dim() != 1 or scale.shape[0] != D:
        raise ValueError(
            f"rmsnorm needs x (..., D) and scale (D,): got "
            f"{tuple(x.shape)} and {tuple(scale.shape)}")
    dtype = _DTYPES.get(x.dtype)
    if dtype is None or scale.dtype != x.dtype:
        raise TypeError(
            f"rmsnorm takes float32 or bfloat16, x and scale alike: got "
            f"{x.dtype} and {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm needs contiguous x and scale")
    n = x.numel()
    if D > MAX_D or n == 0:
        raise ValueError(f"rmsnorm takes 1 <= D <= {MAX_D} and a non-empty "
                         f"x: got {tuple(x.shape)}")
    if dev != torch.cuda.current_device():
        raise ValueError(
            f"rmsnorm launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), x is on {x.device}")
    lib = _build.library("rmsnorm")
    y = torch.empty_like(x)
    form, vectors, threads = plan(D, x.dtype)
    code = lib.repro_rmsnorm(dtype, FORMS[form], vectors, threads,
                             x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                             n // D, D, eps, _build.current_stream(dev))
    _build.check(lib, code, "rmsnorm launch")
    return y
