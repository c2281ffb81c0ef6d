"""The squared-distance kernels on the card — the counterpart of
``repro.kernels.sqdist``.

``sqdist_rows`` launches ``csrc/sqdist.cu``: ``(m, P) x (P,) -> (m,)``
f32, the whole fleet's local conditions ||f_i - r||^2 in one pass over
the plane. ``sqdist`` is the same kernel with m = 1. The Pallas
versions tile for the TPU's sequential grid (a ``block_m`` fallback and
a jnp tail); this kernel splits columns across blocks instead and sums
the partials in a second, fixed-order pass (see the source's header).

These wrappers take CUDA tensors only: they check device, dtype, shape
and contiguity, allocate the output and scratch, launch on the current
stream, and raise on a launch error. ``repro_torch.kernels.ops`` picks
them for CUDA tensors and the plain versions for CPU tensors.
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


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(m: int, P: int, sms: int) -> int:
    """The column splits S of pass 1, a pure function of the shape and the
    SM count, so the order of additions (and the result's bits) is fixed
    for a given card. Enough splits that m * S fills every SM's resident
    blocks four times over, and segments no longer than ``_MAX_SEG``
    columns, but none shorter than one unrolled sweep."""
    want = max(math.ceil(P / _MAX_SEG),
               math.ceil(4 * sms * _BLOCKS_PER_SM / m))
    return max(1, min(want, math.ceil(P / _MIN_SEG), _MAX_SPLITS))


def sqdist_rows(X: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Row-wise ``||X[i] - r||^2``: X ``(m, P)``, r ``(P,)`` -> ``(m,)``
    f32, on the card."""
    if not (X.is_cuda and r.is_cuda and X.device == r.device):
        raise ValueError(
            f"sqdist_rows runs on one CUDA device: X on {X.device}, r on "
            f"{r.device}")
    if X.dim() != 2 or r.dim() != 1 or X.shape[1] != r.shape[0]:
        raise ValueError(
            f"sqdist_rows needs X (m, P) and r (P,): got {tuple(X.shape)} "
            f"and {tuple(r.shape)}")
    if X.dtype not in _DTYPES or r.dtype != X.dtype:
        raise TypeError(
            f"sqdist_rows takes float32 or bfloat16, X and r alike: got "
            f"{X.dtype} and {r.dtype}")
    if not (X.is_contiguous() and r.is_contiguous()):
        raise ValueError(
            f"sqdist_rows needs contiguous rows: X strides {X.stride()}, "
            f"r strides {r.stride()}")
    m, P = X.shape
    if m == 0 or P == 0:
        raise ValueError(f"sqdist_rows got an empty plane {tuple(X.shape)}")
    if X.device.index != torch.cuda.current_device():
        raise ValueError(
            f"sqdist_rows launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), X is on {X.device}")
    S = num_splits(m, P, _sm_count(X.device.index))
    seg = math.ceil(P / S)
    S = math.ceil(P / seg)          # no empty trailing split
    lib = _build.library("sqdist")
    # one allocation: the (m,) result, then the (m, S) partials
    buf = torch.empty((m + m * S,), dtype=torch.float32, device=X.device)
    out, partial = buf[:m], buf[m:]
    stream = torch.cuda.current_stream(X.device).cuda_stream
    code = lib.repro_sqdist_rows(
        _DTYPES[X.dtype], X.data_ptr(), r.data_ptr(), partial.data_ptr(),
        out.data_ptr(), m, P, seg, S, stream)
    _build.check(lib, code, "sqdist_rows launch")
    return out


def sqdist(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``||x - r||^2`` over flattened same-shape inputs -> f32 scalar, on
    the card (the rows kernel with m = 1)."""
    if x.shape != r.shape:
        raise ValueError(
            f"sqdist needs same-shape inputs: {tuple(x.shape)} vs "
            f"{tuple(r.shape)}")
    if not (x.is_contiguous() and r.is_contiguous()):
        raise ValueError("sqdist needs contiguous inputs")
    return sqdist_rows(x.reshape(1, -1), r.reshape(-1))[0]
