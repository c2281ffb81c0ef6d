"""The squared-distance kernels on the card — the counterpart of
``repro.kernels.sqdist``.

``sqdist_rows`` launches ``csrc/sqdist.cu``: ``(m, P) x (P,) -> (m,)``
f32, the whole fleet's local conditions ||f_i - r||^2 in one pass over
the plane. ``sqdist`` is the same kernel with m = 1 and returns a 0-d
tensor. The Pallas versions tile for the TPU's sequential grid (a
``block_m`` fallback and a jnp tail); this kernel splits columns across
blocks instead, and the last block of each row, chosen by a ticket
counter, sums the row's partials in a fixed order: one launch per call
(see the source's header).

The wrappers keep the host's work per call small, because at m = 1 the
device work (9.6 MB read) is shorter than a call: the column plan is
cached per (m, P, device), the partials and ticket counters live in a
buffer kept per (device, stream), so a call allocates only its output,
and ``sqdist`` reads its inputs in place with no reshape or indexing op.
They take CUDA tensors only: they check device, dtype, shape and
contiguity, launch on the current stream, and raise on a launch error.
``repro_torch.kernels.ops`` picks them for CUDA tensors and the plain
versions for CPU tensors.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256
_MIN_SEG = _THREADS * 4         # one unrolled sweep of the block
_MAX_SEG = _THREADS * 4 * 16    # longer segments leave SMs idle
_BLOCKS_PER_SM = 2048 // _THREADS
_MAX_SPLITS = 65535             # grid.y limit
_SCRATCH: dict = {}             # (device index, stream) -> scratch buffers


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(m: int, P: int, sms: int) -> int:
    """The column splits S, a pure function of the shape and the
    SM count, so the order of additions (and the result's bits) is fixed
    for a given card. Enough splits that m * S fills every SM's resident
    blocks four times over, and segments no longer than ``_MAX_SEG``
    columns, but none shorter than one unrolled sweep."""
    want = max(math.ceil(P / _MAX_SEG),
               math.ceil(4 * sms * _BLOCKS_PER_SM / m))
    return max(1, min(want, math.ceil(P / _MIN_SEG), _MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _plan(m: int, P: int, device_index: int) -> tuple:
    """(S, seg) for an (m, P) plane on this device: the column splits
    and their length, with no empty trailing split."""
    S = num_splits(m, P, _sm_count(device_index))
    seg = math.ceil(P / S)
    return math.ceil(P / seg), seg


def _scratch(device: torch.device, stream: int, m: int, S: int) -> tuple:
    """(partials pointer, tickets pointer) of this (device, stream)'s
    scratch, grown to at least m rows of S partials. The tickets are
    zeroed once, when the buffer is made; each call leaves them at 0.
    One buffer per stream, so launches on two streams never share
    counters; launches on one stream run in order."""
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf[0] < m or buf[1] < m * S:
        rows, size = (m, m * S) if buf is None else (max(m, buf[0]),
                                                     max(m * S, buf[1]))
        tickets = torch.zeros((rows,), dtype=torch.int32, device=device)
        partial = torch.empty((size,), dtype=torch.float32, device=device)
        buf = _SCRATCH[key] = (rows, size, partial.data_ptr(),
                               tickets.data_ptr(), partial, tickets)
    return buf[2], buf[3]


def _launch(name: str, X: torch.Tensor, r: torch.Tensor, m: int, P: int,
            shape: tuple) -> torch.Tensor:
    """Check what the kernel cannot take, then launch it once on
    ``m`` rows of ``P`` into a new f32 tensor of ``shape`` (m elements)."""
    if not (X.is_cuda and r.is_cuda and X.device == r.device):
        raise ValueError(
            f"{name} runs on one CUDA device: inputs on {X.device} and "
            f"{r.device}")
    dtype = _DTYPES.get(X.dtype)
    if dtype is None or r.dtype != X.dtype:
        raise TypeError(
            f"{name} takes float32 or bfloat16, both inputs alike: got "
            f"{X.dtype} and {r.dtype}")
    if not (X.is_contiguous() and r.is_contiguous()):
        raise ValueError(
            f"{name} needs contiguous rows: strides {X.stride()} and "
            f"{r.stride()}")
    if m == 0 or P == 0:
        raise ValueError(f"{name} got an empty plane {tuple(X.shape)}")
    device = X.device
    if device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name} launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), the inputs are on "
            f"{device}")
    S, seg = _plan(m, P, device.index)
    lib = _build.library("sqdist")
    stream = torch.cuda.current_stream(device).cuda_stream
    partial, tickets = _scratch(device, stream, m, S)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    code = lib.repro_sqdist_rows(dtype, X.data_ptr(), r.data_ptr(), partial,
                                 out.data_ptr(), tickets, m, P, seg, S,
                                 stream)
    _build.check(lib, code, f"{name} launch")
    return out


def sqdist_rows(X: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Row-wise ``||X[i] - r||^2``: X ``(m, P)``, r ``(P,)`` -> ``(m,)``
    f32, on the card."""
    if X.dim() != 2 or r.dim() != 1 or X.shape[1] != r.shape[0]:
        raise ValueError(
            f"sqdist_rows needs X (m, P) and r (P,): got {tuple(X.shape)} "
            f"and {tuple(r.shape)}")
    m, P = X.shape
    return _launch("sqdist_rows", X, r, m, P, (m,))


def sqdist(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``||x - r||^2`` over flattened same-shape inputs -> f32 scalar (a
    0-d tensor), on the card: the rows kernel with m = 1, read in place
    (no reshape, no indexing op)."""
    if x.shape != r.shape:
        raise ValueError(
            f"sqdist needs same-shape inputs: {tuple(x.shape)} vs "
            f"{tuple(r.shape)}")
    return _launch("sqdist", x, r, 1, x.numel(), ())
