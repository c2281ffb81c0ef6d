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

The wrapper takes CUDA tensors only; ``repro_torch.kernels.ops`` picks
it for CUDA tensors and the plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import attention
from repro_torch.kernels.ref import check_swa_shape


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, scale: float | None = None) -> torch.Tensor:
    """Causal banded attention, on the card: q, k, v (B, S, d), or the GQA
    layout q (B, S, H, d), k/v (B, S, Hkv, d)."""
    check_swa_shape(q.shape[1], window)
    if k.shape[1] != q.shape[1]:
        raise ValueError(
            f"swa_attention needs as many keys as queries: q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dim() == 3:
        return attention(q[:, :, None], k[:, :, None], v[:, :, None],
                         causal=True, window=window, scale=scale,
                         what="swa_attention")[:, :, 0]
    return attention(q, k, v, causal=True, window=window, scale=scale,
                     what="swa_attention")
