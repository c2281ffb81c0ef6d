"""Grouped-query attention (optional QKV bias, optional sliding window) —
the counterpart of ``repro.models.attention``.

* ``gqa_forward`` — full-sequence causal attention (prefill). The masked
  path goes through ``ops.flash_attention_gqa`` (with the window for a
  sliding-window arch), the banded path — a sliding window with
  ``S % window == 0`` and ``S >= 2 * window``, where the reference takes
  ``_banded_sdpa`` — through ``ops.swa_attention``. On the card both are
  the hand-written attention kernel; on the CPU their plain versions.
* ``gqa_decode`` — one new token against the KV cache, plain PyTorch as
  in the reference (which computes it outside any Pallas kernel): the
  cache is a full buffer, or for a sliding-window arch a ring buffer of
  ``window`` slots with ``pos`` tags.

Departures from the reference. The kernels mask by sequence index (query
row i at position ``i + Sk - Sq``), so ``gqa_forward`` takes its mask
from the row indices and uses ``positions`` for the rotary embedding
only: positions must be contiguous within a row (``p0, p0 + 1, ...``),
as every caller passes them; the masks then agree. In bf16 the kernels
keep scores and probabilities in f32, where the reference's ``_sdpa``
rounds scores to bf16 and casts probabilities to v's dtype, so bf16
parity with the JAX model is looser than f32's. ``gqa_decode`` updates
the cache IN PLACE and returns the same dict; it raises once a full
(non-ring) cache is full, where the reference's ``dynamic_update_slice``
would clamp the write to the last slot. MLA (``cfg.mla``) is not ported:
``ModelConfig`` refuses it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ATTN_SLIDING, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


def attn_init(cfg: ModelConfig, generator: torch.Generator,
              dtype=torch.float32) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "w_q": dense_init(generator, d, H * hd, dtype),
        "w_k": dense_init(generator, d, Hkv * hd, dtype),
        "w_v": dense_init(generator, d, Hkv * hd, dtype),
        "w_o": dense_init(generator, H * hd, d, dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("b_q", H), ("b_k", Hkv), ("b_v", Hkv)):
            p[name] = torch.zeros((n * hd,), dtype=dtype,
                                  device=generator.device)
    return p


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    """(..., Sq, Sk) boolean mask. window > 0 -> sliding window."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m = m & (k_pos[..., None, :] > q_pos[..., :, None] - window)
    return m


def _sdpa(q, k, v, mask, scale):
    """q: (B,S,Hkv,G,d) k,v: (B,T,Hkv,d). mask: (B,S,T) or (S,T)."""
    scores = torch.einsum("bshgd,bthd->bhgst", q, k).float() * scale
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhgst,bthd->bshgd", probs, v)


def _project_qkv(cfg: ModelConfig, params: dict, x: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = torch.matmul(x, params["w_q"])
    k = torch.matmul(x, params["w_k"])
    v = torch.matmul(x, params["w_v"])
    if cfg.qkv_bias:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    return (q.reshape(B, S, cfg.num_heads, hd),
            k.reshape(B, S, cfg.num_kv_heads, hd),
            v.reshape(B, S, cfg.num_kv_heads, hd))


def _window(cfg: ModelConfig) -> int:
    return cfg.sliding_window if cfg.attn_type == ATTN_SLIDING else 0


def gqa_forward(cfg: ModelConfig, params: dict, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal attention. x: (B,S,D), positions: (B,S) or
    (S,), contiguous within a row."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, params, x)
    if positions.dim() == 1:
        positions = positions[None].expand(B, S)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = _window(cfg)
    scale = 1.0 / math.sqrt(hd)
    if window > 0 and S % window == 0 and S >= 2 * window:
        out = ops.swa_attention(q, k, v, window=window, scale=scale)
    else:
        out = ops.flash_attention_gqa(q, k, v, causal=True, window=window,
                                      scale=scale)
    return torch.matmul(out.reshape(B, S, cfg.num_heads * hd),
                        params["w_o"])


def gqa_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
               cache: dict, pos: int):
    """One-token decode. x: (B,1,D); cache: {"k","v"}: (B, Smax, Hkv, hd),
    plus {"pos": (Smax,) int32} ring-buffer position tags for a sliding
    window; pos: the number of tokens already in the cache (a host int).
    Writes the new key and value into the cache in place and returns
    ``(y (B,1,D), cache)``."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    q, k_new, v_new = _project_qkv(cfg, params, x)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)
    Smax = cache["k"].shape[1]
    window = _window(cfg)
    if window:
        slot = pos % Smax
    elif pos < Smax:
        slot = pos
    else:
        raise ValueError(f"the KV cache holds {Smax} positions; position "
                         f"{pos} does not fit")
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    if window:
        tags = cache["pos"]
        tags[slot] = pos
        valid = (tags >= 0) & (tags <= pos) & (tags > pos - window)
    else:
        valid = torch.arange(Smax, device=x.device) <= pos
    mask = valid[None, None, :].expand(B, 1, Smax)
    out = _sdpa(q.reshape(B, 1, Hkv, H // Hkv, hd), cache["k"], cache["v"],
                mask, 1.0 / math.sqrt(hd))
    y = torch.matmul(out.reshape(B, 1, H * hd), params["w_o"])
    return y, cache


def attn_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                    dtype=torch.float32, device=None) -> dict:
    hd = cfg.resolved_head_dim
    if cfg.attn_type == ATTN_SLIDING:
        max_seq = min(max_seq, cfg.sliding_window)
    shape = (batch, max_seq, cfg.num_kv_heads, hd)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.attn_type == ATTN_SLIDING:
        cache["pos"] = torch.full((max_seq,), -1, dtype=torch.int32,
                                  device=device)
    return cache
