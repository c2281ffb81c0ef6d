"""Grouped-query attention (optional QKV bias, optional sliding window)
and multi-head latent attention (MLA, DeepSeek-V2) — the counterpart of
``repro.models.attention``.

* ``gqa_forward`` — full-sequence causal attention (prefill). The masked
  path goes through ``ops.flash_attention_gqa`` (with the window for a
  sliding-window arch), the banded path (``takes_band``: a sliding window
  with ``S % window == 0`` and ``S >= 2 * window``, where the reference
  takes ``_banded_sdpa``) through ``ops.swa_attention``. On the card both are
  the hand-written attention kernel; on the CPU their plain versions.
* ``gqa_decode`` — one new token against the KV cache, plain PyTorch as
  in the reference (which computes it outside any Pallas kernel): the
  cache is a full buffer, or for a sliding-window arch a ring buffer of
  ``window`` slots with ``pos`` tags.
* ``mla_forward`` — MLA prefill: queries (optionally through a low-rank
  ``w_dq``/``w_uq``), the latent ``c_kv`` and its up-projections to
  per-head keys and values, and one rotary key ``k_r`` shared by all
  heads. The reference adds two score einsums (``q_c k_c`` and
  ``q_r k_r``); here the kernel takes ``q = [q_c | q_r]`` and
  ``k = [k_c | k_r]`` (k_r broadcast over the heads), both of width
  ``hd + rope_head_dim``, against values of width ``hd``, with scale
  ``1 / sqrt(hd + rope_head_dim)`` — the same scores summed in one
  product. On the card that is the attention kernel's Dqk != Dv program.
* ``mla_decode`` — the absorbed step (``W_uk`` folded into the query,
  scores against the cached latent, ``W_uv`` after the context), plain
  PyTorch as in the reference, with the cache ``{"ckv", "krope"}``.

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
would clamp the write to the last slot; ``mla_decode`` likewise.
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
    if cfg.mla is not None:
        m = cfg.mla
        p = {"w_dkv": dense_init(generator, d, m.kv_lora_rank, dtype),
             "w_krope": dense_init(generator, d, m.rope_head_dim, dtype),
             "w_uk": dense_init(generator, m.kv_lora_rank, H * hd, dtype),
             "w_uv": dense_init(generator, m.kv_lora_rank, H * hd, dtype),
             "w_o": dense_init(generator, H * hd, d, dtype)}
        if m.q_lora_rank:
            p["w_dq"] = dense_init(generator, d, m.q_lora_rank, dtype)
            p["w_uq"] = dense_init(generator, m.q_lora_rank,
                                   H * (hd + m.rope_head_dim), dtype)
        else:
            p["w_q"] = dense_init(generator, d, H * (hd + m.rope_head_dim),
                                  dtype)
        return p
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


def takes_band(cfg: ModelConfig, S: int) -> bool:
    """Whether a prefill of S positions takes the banded path
    (``ops.swa_attention``), where the reference takes ``_banded_sdpa``:
    a sliding window w with ``S % w == 0`` and ``S >= 2 * w``."""
    w = _window(cfg)
    return w > 0 and S % w == 0 and S >= 2 * w


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
    if takes_band(cfg, S):
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
    slot = pos % Smax if window else _slot(pos, Smax)
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


def _slot(pos: int, Smax: int) -> int:
    if pos < Smax:
        return pos
    raise ValueError(f"the KV cache holds {Smax} positions; position "
                     f"{pos} does not fit")


def _mla_queries(cfg: ModelConfig, params: dict, x: torch.Tensor,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    m, hd = cfg.mla, cfg.resolved_head_dim
    if m.q_lora_rank:
        q = torch.matmul(torch.matmul(x, params["w_dq"]), params["w_uq"])
    else:
        q = torch.matmul(x, params["w_q"])
    q = q.reshape(B, S, cfg.num_heads, hd + m.rope_head_dim)
    q_c, q_r = q[..., :hd], q[..., hd:]
    return q_c, apply_rope(q_r, positions, cfg.rope_theta)


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.resolved_head_dim + cfg.mla.rope_head_dim)


def mla_forward(cfg: ModelConfig, params: dict, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """MLA prefill. x: (B, S, D), positions (B, S) or (S,), contiguous
    within a row; causal attention through ``ops.flash_attention_gqa``
    with query/key width ``hd + rope_head_dim`` and value width hd."""
    B, S, _ = x.shape
    m, hd, H = cfg.mla, cfg.resolved_head_dim, cfg.num_heads
    if positions.dim() == 1:
        positions = positions[None].expand(B, S)
    q_c, q_r = _mla_queries(cfg, params, x, positions)
    c_kv = torch.matmul(x, params["w_dkv"])
    k_r = apply_rope(torch.matmul(x, params["w_krope"])[:, :, None, :],
                     positions, cfg.rope_theta)                 # (B,S,1,rh)
    k_c = torch.matmul(c_kv, params["w_uk"]).reshape(B, S, H, hd)
    v = torch.matmul(c_kv, params["w_uv"]).reshape(B, S, H, hd)
    q = torch.cat([q_c, q_r], dim=-1)
    k = torch.cat([k_c, k_r.expand(B, S, H, m.rope_head_dim)], dim=-1)
    out = ops.flash_attention_gqa(q, k, v.contiguous(), causal=True,
                                  scale=_mla_scale(cfg))
    return torch.matmul(out.reshape(B, S, H * hd), params["w_o"])


def mla_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
               cache: dict, pos: int):
    """Absorbed MLA decode. x: (B, 1, D); cache {"ckv": (B, Smax, r),
    "krope": (B, Smax, rh)}, written in place at ``pos``. Returns
    ``(y (B, 1, D), cache)``."""
    B = x.shape[0]
    m, hd, H = cfg.mla, cfg.resolved_head_dim, cfg.num_heads
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_c, q_r = _mla_queries(cfg, params, x, posb)               # (B,1,H,.)
    c_new = torch.matmul(x, params["w_dkv"])
    kr_new = apply_rope(torch.matmul(x, params["w_krope"])[:, :, None, :],
                        posb, cfg.rope_theta)[:, :, 0, :]
    ckv, krope = cache["ckv"], cache["krope"]
    slot = _slot(pos, ckv.shape[1])
    ckv[:, slot] = c_new[:, 0].to(ckv.dtype)
    krope[:, slot] = kr_new[:, 0].to(krope.dtype)
    # absorb W_uk into the query: q_abs (B, H, r)
    w_uk = params["w_uk"].reshape(m.kv_lora_rank, H, hd)
    q_abs = torch.einsum("bshd,rhd->bshr", q_c, w_uk)[:, 0]
    scores = (torch.einsum("bhr,btr->bht", q_abs, ckv)
              + torch.einsum("bshr,btr->bht", q_r, krope))
    scores = scores.float() * _mla_scale(cfg)
    valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    scores = torch.where(valid[None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(ckv.dtype)
    ctx = torch.einsum("bht,btr->bhr", probs, ckv)              # latent
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, H, hd)
    out = torch.einsum("bhr,rhd->bhd", ctx, w_uv).reshape(B, 1, H * hd)
    return torch.matmul(out, params["w_o"]), cache


def attn_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                    dtype=torch.float32, device=None) -> dict:
    hd = cfg.resolved_head_dim
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": torch.zeros((batch, max_seq, m.kv_lora_rank),
                                   dtype=dtype, device=device),
                "krope": torch.zeros((batch, max_seq, m.rope_head_dim),
                                     dtype=dtype, device=device)}
    if cfg.attn_type == ATTN_SLIDING:
        max_seq = min(max_seq, cfg.sliding_window)
    shape = (batch, max_seq, cfg.num_kv_heads, hd)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.attn_type == ATTN_SLIDING:
        cache["pos"] = torch.full((max_seq,), -1, dtype=torch.int32,
                                  device=device)
    return cache
