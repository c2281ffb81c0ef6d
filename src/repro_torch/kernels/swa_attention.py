"""The banded sliding-window attention kernel on the card — the
counterpart of ``repro.kernels.swa_attention``.

``swa_attention`` is the attention kernel of ``flash_attention.py`` (the
``wgmma`` program for bf16, the split-TF32 ``mma.sync`` one for f32) with
``causal=True`` and the window: its key loop reads only the key tiles
that overlap ``(q - window, q]``. The Pallas kernel stages a whole
window-sized block per step (k blocks i-1 and i of query block i); at
window 8192 that block cannot sit in a Hopper SM's shared memory, so the
port tiles q and k at the card's size and bounds the loop by the window
instead (ROADMAP Queue B 4). Same precondition as the reference:
``S % window == 0`` and ``S >= window``.

The gradient (ROADMAP A29, bf16 A28): ``swa_attention_differentiable``
routes the same layouts through ``flash_attention.AttentionFn`` with
``causal=True`` and the window, counted under ``"swa_attention"``. Both
forwards write the log-sum-exp, and both backward programs
(``csrc/attention_bwd.cu`` in f32, ``csrc/attention_bwd_bf16.cu`` in
bf16) bound both their passes' ranges by the window and mask its edge,
so the banded gradient reads only the band, as the forward does. Widths
and dtypes are the backward's (``flash_attention.differentiable``).
``repro_torch.kernels.ops`` takes this route for a CUDA call under a
gradient.

The wrappers take CUDA tensors only; ``repro_torch.kernels.ops`` picks
them for CUDA tensors and the plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (
    AttentionFn, attention, differentiable,
)
from repro_torch.kernels.ref import check_swa_shape


def _gqa_layout(q, k, v, window):
    """The banded kernel's precondition, and the inputs in the GQA layout
    with whether they came as (B, S, d)."""
    check_swa_shape(q.shape[1], window)
    if k.shape[1] != q.shape[1]:
        raise ValueError(
            f"swa_attention needs as many keys as queries: q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dim() == 3:
        return q[:, :, None], k[:, :, None], v[:, :, None], True
    return q, k, v, False


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, scale: float | None = None) -> torch.Tensor:
    """Causal banded attention, on the card: q, k, v (B, S, d), or the GQA
    layout q (B, S, H, d), k/v (B, S, Hkv, d)."""
    q, k, v, flat = _gqa_layout(q, k, v, window)
    out = attention(q, k, v, causal=True, window=window, scale=scale,
                    what="swa_attention")
    return out[:, :, 0] if flat else out


def swa_attention_differentiable(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, window: int,
                                 scale: float | None = None) -> torch.Tensor:
    """``swa_attention`` with its gradient, through ``AttentionFn``."""
    q, k, v, flat = _gqa_layout(q, k, v, window)
    differentiable(q, k, v, "swa_attention")
    out = AttentionFn.apply(q, k, v, True, window, scale, "swa_attention")[0]
    return out[:, :, 0] if flat else out
