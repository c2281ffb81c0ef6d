"""The chunked SSD scan on the card — the counterpart of
``repro.kernels.ssd_scan``.

``ssd_scan`` launches ``csrc/ssd_scan.cu``: x (BH, S, P), dt (BH, S),
a (BH,) and b, c (BH / R, S, N) -> y (BH, S, P) in x's dtype and the
final state h (BH, P, N) in f32, the chunked form of
``ref.ssd_scan_ref``'s recurrence (see the source's header). Head bh
reads row ``bh // R`` of b and c, R = BH / b.shape[0]: with H heads
in G groups per batch, R = H / G, so Mamba2's shared B and C are read in
place where the reference repeats them per head; b and c per head
(R = 1) is the reference's layout. Like the Pallas kernel it needs S
to be a chunk multiple (``repro_torch.kernels.ops.ssd_scan`` pads) and
raises the reference's ``ValueError`` otherwise.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the outputs, launches on the current stream, and
raises on a launch error. ``repro_torch.kernels.ops`` picks it for CUDA
tensors and the plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (8, 16, 32, 64)
MAX_P, MAX_N = 64, 128


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 64):
    """The chunked SSD on the card -> (y (BH, S, P), h (BH, P, N) f32)."""
    if x.dim() != 3:
        raise ValueError(f"ssd_scan needs x (BH, S, P): got {tuple(x.shape)}")
    BH, S, P = x.shape
    rows, N = (b.shape[0], b.shape[-1]) if b.dim() == 3 else (0, 0)
    if (dt.shape != (BH, S) or a.shape != (BH,) or rows < 1 or BH % rows
            or b.shape != (rows, S, N) or c.shape != b.shape):
        raise ValueError(
            f"ssd_scan needs x (BH, S, P), dt (BH, S), a (BH,) and b, c "
            f"(BH / R, S, N) with R heads per row: got {tuple(x.shape)}, "
            f"{tuple(dt.shape)}, {tuple(a.shape)}, {tuple(b.shape)}, "
            f"{tuple(c.shape)}")
    R = BH // rows
    if chunk < 1 or S % chunk != 0:          # ssd_scan.py:81-84
        raise ValueError(
            f"sequence length must be a chunk multiple (callers pad): "
            f"S={S}, chunk={chunk}")
    if chunk not in CHUNKS:
        raise ValueError(f"ssd_scan takes chunks {CHUNKS}, got {chunk}")
    if not (0 < P <= MAX_P and 0 < N <= MAX_N and S > 0):
        raise ValueError(
            f"ssd_scan takes 1 <= P <= {MAX_P}, 1 <= N <= {MAX_N} and "
            f"S > 0: got P={P}, N={N}, S={S}")
    tensors = (x, dt, a, b, c)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(
            f"ssd_scan runs on one CUDA device: got "
            f"{[str(t.device) for t in tensors]}")
    if (x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, b, c))
            or a.dtype != torch.float32):
        raise TypeError(
            f"ssd_scan takes x, dt, b and c in float32 or bfloat16 alike and "
            f"a in float32: got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan needs contiguous x, dt, a, b and c")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"ssd_scan launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), x is on {x.device}")
    lib = _build.library("ssd_scan")
    y = torch.empty_like(x)
    h = torch.empty((BH, P, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.repro_ssd_scan(
        _DTYPES[x.dtype], chunk, x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        b.data_ptr(), c.data_ptr(), y.data_ptr(), h.data_ptr(), BH, S, P, N,
        R, stream)
    _build.check(lib, code, "ssd_scan launch")
    return y, h
