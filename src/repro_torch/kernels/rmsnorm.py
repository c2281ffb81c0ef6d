"""The RMS-norm kernel on the card — the counterpart of
``repro.kernels.rmsnorm``.

``rmsnorm`` launches ``csrc/rmsnorm.cu``: ``x (..., D) x scale (D,) ->
(..., D)`` in x's dtype, with the statistics in f32, one block per row
and the row read from device memory once (see the source's header). The
Pallas version tiles rows in ``block_rows`` and pads the ragged tail;
here every row is its own block, so there is no padding.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream, and
raises on a launch error. ``repro_torch.kernels.ops`` picks it for CUDA
tensors and the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 232_448 // 4 - 64        # the row in f32 shared memory, with room


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * scale`` on the card."""
    if not (x.is_cuda and scale.is_cuda and x.device == scale.device):
        raise ValueError(
            f"rmsnorm runs on one CUDA device: x on {x.device}, scale on "
            f"{scale.device}")
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(
            f"rmsnorm needs x (..., D) and scale (D,): got "
            f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _DTYPES or scale.dtype != x.dtype:
        raise TypeError(
            f"rmsnorm takes float32 or bfloat16, x and scale alike: got "
            f"{x.dtype} and {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm needs contiguous x and scale")
    D = x.shape[-1]
    if not 0 < D <= MAX_D or x.numel() == 0:
        raise ValueError(f"rmsnorm takes 1 <= D <= {MAX_D} and a non-empty "
                         f"x: got {tuple(x.shape)}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"rmsnorm launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), x is on {x.device}")
    lib = _build.library("rmsnorm")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.repro_rmsnorm(_DTYPES[x.dtype], x.data_ptr(),
                             scale.data_ptr(), y.data_ptr(), x.numel() // D,
                             D, ctypes.c_float(eps), stream)
    _build.check(lib, code, "rmsnorm launch")
    return y
