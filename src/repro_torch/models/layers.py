"""Shared neural-net primitives — the counterpart of ``repro.models.layers``.

Parameters are plain dicts of tensors; initializers draw from an explicit
``torch.Generator`` on its device. This slice ports the Glorot dense init
of the paper's models and what the dense decoder LM needs: the embedding
init, RMS norm (through ``repro_torch.kernels.ops.rmsnorm``, the
hand-written kernel on the card), rotary position embedding and the
SwiGLU FFN; the Mamba2 slice adds the depthwise causal conv and its
decode step. The dense products are ``torch.matmul`` on the reference's
``(d_in, d_out)`` layout, as the reference leaves them to XLA; FSDP's
``gather_weight`` and ``constrain`` are identities on one device and have
no port. The layer norm and plain MLP come with their slices.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    """Glorot/Xavier-uniform init (the paper uses Glorot, ref. [41]),
    drawn from ``generator`` on its device."""
    lim = scale * math.sqrt(6.0 / (d_in + d_out))
    w = torch.empty((d_in, d_out), dtype=dtype, device=generator.device)
    return w.uniform_(-lim, lim, generator=generator)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 0.02^2) token embeddings (vocab, d)."""
    w = torch.empty((vocab, d), dtype=dtype, device=generator.device)
    return w.normal_(0.0, 0.02, generator=generator)


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(params: dict, x: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last axis (the ``rmsnorm`` kernel on the card)."""
    return ops.rmsnorm(x, params["scale"], eps=eps)


def rope_freqs(head_dim: int, theta: float = 10_000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, d). positions: (..., S) integers. Rotates the two
    halves of the head dim in f32 and returns x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)    # (d/2,)
    ang = positions[..., None].float() * freqs          # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]                  # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu_init(generator: torch.Generator, d: int, d_ff: int,
                dtype=torch.float32) -> dict:
    return {
        "w_gate": dense_init(generator, d, d_ff, dtype),
        "w_up": dense_init(generator, d, d_ff, dtype),
        "w_down": dense_init(generator, d_ff, d, dtype),
    }


def swiglu_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, params["w_gate"])
    u = torch.matmul(x, params["w_up"])
    return torch.matmul(F.silu(g) * u, params["w_down"])


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C), w: (K, C) -> (B, S, C).

    ``out[:, t] = sum_k xp[:, t + k] * w[k]`` over the left-padded input,
    as the reference's loop of K multiply-adds in x's dtype (so bf16
    rounds after each step as it does there; ``F.conv1d`` would
    accumulate otherwise)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xp[:, k:k + S, :] * w[k]
    return out


def causal_conv1d_update(conv_state: torch.Tensor, x_t: torch.Tensor,
                         w: torch.Tensor):
    """One decode step. conv_state: (B, K-1, C), x_t: (B, C) ->
    (y_t (B, C), new_state (B, K-1, C)).

    Departure: the reference contracts the window with an einsum; here it
    is ``causal_conv1d``'s loop of K multiply-adds in x's dtype, so that in
    bf16 a decode step rounds exactly as the prefill does at the same
    position (in f32 the two forms differ only in the last bits)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)     # (B, K, C)
    y = torch.zeros_like(x_t)
    for k in range(w.shape[0]):
        y = y + window[:, k] * w[k]
    return y, window[:, 1:, :]
