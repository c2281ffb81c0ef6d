"""Shared neural-net primitives — the counterpart of ``repro.models.layers``.

Parameters are plain dicts of tensors; initializers draw from an explicit
``torch.Generator`` on its device. This slice ports the Glorot dense init
of the paper's models and what the dense decoder LM needs: the embedding
init, RMS norm (through ``repro_torch.kernels.ops.rmsnorm``, the
hand-written kernel on the card), rotary position embedding and the
SwiGLU FFN. The dense products are ``torch.matmul`` on the reference's
``(d_in, d_out)`` layout, as the reference leaves them to XLA; FSDP's
``gather_weight`` and ``constrain`` are identities on one device and have
no port. The layer norm, plain MLP and the Mamba causal conv come with
their slices.
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
