"""Public kernel entry points — the counterpart of ``repro.kernels.ops``.

Dispatch is by the device of the tensors: a CUDA tensor launches the
hand-written kernel (``repro_torch.kernels.sqdist``, ``.rmsnorm``,
``.flash_attention``, ``.swa_attention``, ``.ssd_scan``), a CPU tensor
runs the plain version (``repro_torch.kernels.ref``). There is no
fallback: a kernel that fails to build or launch raises.

``LAUNCHES`` counts kernel launches by kernel, so a run can show that
its main path went through the kernels, and ``ROWS_LAUNCHES`` splits the
``sqdist_rows`` count by ``(m, P, g)`` (g reference rows: 1, or a
hierarchy's clusters); ``reset_launches`` zeroes both.
``flash_attention`` and its GQA front end ``flash_attention_gqa`` launch
the same kernel and count under ``"flash_attention"``. Plain-version
calls are not counted.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import sqdist as _sqdist
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import swa_attention as _swa

LAUNCHES = {"sqdist_rows": 0, "sqdist": 0, "rmsnorm": 0,
            "flash_attention": 0, "swa_attention": 0, "ssd_scan": 0}
ROWS_LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ROWS_LAUNCHES.clear()


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def sqdist_rows(X: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Batched local condition over the flat fleet plane:
    ``(m, P) x (P,) -> (m,)`` row-wise squared distances in f32; with r
    ``(g, P)`` every row against its cluster's reference row (g equal
    clusters of consecutive rows), in the same one launch."""
    if _on_cpu(X, r):
        return ref.sqdist_rows_ref(X, r)
    out = _sqdist.sqdist_rows(X, r)
    LAUNCHES["sqdist_rows"] += 1
    ROWS_LAUNCHES[(*X.shape, 1 if r.dim() == 1 else r.shape[0])] += 1
    return out


def sqdist(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``||x - r||^2`` over flattened same-shape inputs, in f32."""
    if _on_cpu(x, r):
        return ref.sqdist_ref(x, r)
    out = _sqdist.sqdist(x, r)
    LAUNCHES["sqdist"] += 1
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """Row-wise RMS norm over the last axis: f32 statistics, x's dtype."""
    if _on_cpu(x, scale):
        return ref.rmsnorm_ref(x, scale, eps)
    out = _rmsnorm.rmsnorm(x, scale, eps)
    LAUNCHES["rmsnorm"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Masked softmax attention, q (B, Sq, d), k/v (B, Sk, d); the causal
    diagonal is right-aligned."""
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    out = _flash.flash_attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """GQA front end: q (B, S, H, d), k/v (B, S, Hkv, d)."""
    if _on_cpu(q, k, v):
        return ref.flash_attention_gqa_ref(q, k, v, causal=causal,
                                           window=window, scale=scale)
    out = _flash.flash_attention_gqa(q, k, v, causal=causal, window=window,
                                     scale=scale)
    LAUNCHES["flash_attention"] += 1
    return out


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, scale: float | None = None) -> torch.Tensor:
    """Causal banded sliding-window attention, ``S % window == 0``:
    q, k, v (B, S, d) or q (B, S, H, d), k/v (B, S, Hkv, d)."""
    if _on_cpu(q, k, v):
        return ref.swa_attention_ref(q, k, v, window=window, scale=scale)
    out = _swa.swa_attention(q, k, v, window=window, scale=scale)
    LAUNCHES["swa_attention"] += 1
    return out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 64):
    """Chunked SSD over (BH, S, *) layouts; pads S to a chunk multiple with
    zeros (dt = 0 there, so the padded steps leave the state untouched)
    and slices y back. b and c are (BH / R, S, N): head bh reads row
    ``bh // R`` (b and c per head, R = 1, is the reference's layout).
    Returns (y (BH, S, P) in x's dtype, h (BH, P, N) in f32)."""
    S = x.shape[1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        dt = F.pad(dt, (0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    if _on_cpu(x, dt, a, b, c):
        R = x.shape[0] // b.shape[0]
        if R > 1:
            b, c = b.repeat_interleave(R, dim=0), c.repeat_interleave(R, dim=0)
        y, h = ref.ssd_scan_ref(x, dt, a, b, c, chunk=chunk)
    else:
        y, h = _ssd.ssd_scan(x, dt, a, b, c, chunk=chunk)
        LAUNCHES["ssd_scan"] += 1
    if pad:
        y = y[:, :S]
    return y, h
