"""Decoder block: mixer (attention / SSM / hybrid-parallel) + FFN (dense /
MoE) — the counterpart of ``repro.models.blocks``.

One block's parameters are a dict; the model stacks L copies on a leading
axis. The mixer is GQA or MLA attention (``BLOCK_ATTN``), a Mamba2 SSM
(``BLOCK_SSM``), or, for ``BLOCK_HYBRID`` (Hymba), both reading the same
normed input in parallel, each branch RMS-normed on its own and the two
averaged: ``0.5 * (norm_attn_out(a) + norm_ssm_out(s))``. The FFN is a
SwiGLU, a mixture of experts (``repro_torch.models.moe``) or none.
``block_forward`` returns the new residual stream and the MoE auxiliary
loss (0 without experts), as the reference's does, and the MoE kept
(token, k) mask (None without experts).
"""
from __future__ import annotations

import torch

from repro_torch.config import BLOCK_ATTN, BLOCK_HYBRID, BLOCK_SSM, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    rmsnorm_apply, rmsnorm_init, swiglu_apply, swiglu_init,
)


def block_init(cfg: ModelConfig, generator: torch.Generator,
               dtype=torch.float32) -> dict:
    dev = generator.device
    p = {"norm_mix": rmsnorm_init(cfg.d_model, dtype, dev)}
    if cfg.block_type in (BLOCK_ATTN, BLOCK_HYBRID):
        p["attn"] = attn.attn_init(cfg, generator, dtype)
    if cfg.block_type in (BLOCK_SSM, BLOCK_HYBRID):
        p["ssm"] = mamba.mamba_init(cfg, generator, dtype)
    if cfg.block_type == BLOCK_HYBRID:
        p["norm_attn_out"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["norm_ssm_out"] = rmsnorm_init(cfg.d_model, dtype, dev)
    if cfg.d_ff or cfg.is_moe:
        p["norm_ffn"] = rmsnorm_init(cfg.d_model, dtype, dev)
        if cfg.is_moe:
            p["moe"] = moe_mod.moe_init(cfg, generator, dtype)
        else:
            p["ffn"] = swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype)
    return p


def _fuse(cfg: ModelConfig, p: dict, a: torch.Tensor,
          s: torch.Tensor) -> torch.Tensor:
    """Hymba's fusion of the attention and SSM branches."""
    a = rmsnorm_apply(p["norm_attn_out"], a, cfg.norm_eps)
    s = rmsnorm_apply(p["norm_ssm_out"], s, cfg.norm_eps)
    return 0.5 * (a + s)


def _mixer_forward(cfg: ModelConfig, p: dict, h: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    if cfg.block_type == BLOCK_ATTN:
        if cfg.mla is not None:
            return attn.mla_forward(cfg, p["attn"], h, positions)
        return attn.gqa_forward(cfg, p["attn"], h, positions)
    if cfg.block_type == BLOCK_SSM:
        return mamba.mamba_forward(cfg, p["ssm"], h)
    return _fuse(cfg, p, attn.gqa_forward(cfg, p["attn"], h, positions),
                 mamba.mamba_forward(cfg, p["ssm"], h))


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor):
    h = rmsnorm_apply(p["norm_ffn"], x, cfg.norm_eps)
    if cfg.is_moe:
        return moe_mod.moe_apply(cfg, p["moe"], h)
    return swiglu_apply(p["ffn"], h), None, None


def block_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor):
    """x: (B,S,D) -> (x', aux_loss f32 scalar, MoE keep mask or None)."""
    h = rmsnorm_apply(p["norm_mix"], x, cfg.norm_eps)
    x = x + _mixer_forward(cfg, p, h, positions)
    aux = keep = None
    if "norm_ffn" in p:
        f, aux, keep = _ffn(cfg, p, x)
        x = x + f
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, keep


def block_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                     dtype=torch.float32, device=None) -> dict:
    """A block's decode cache: the KV (or MLA latent) cache of an
    attention mixer, the SSM and conv states of an SSM mixer, both for a
    hybrid one (``max_seq`` unused by the SSM)."""
    c = {}
    if cfg.block_type in (BLOCK_ATTN, BLOCK_HYBRID):
        c["attn"] = attn.attn_cache_init(cfg, batch, max_seq, dtype, device)
    if cfg.block_type in (BLOCK_SSM, BLOCK_HYBRID):
        c["ssm"] = mamba.mamba_cache_init(cfg, batch, dtype, device)
    return c


def _mixer_decode(cfg: ModelConfig, p: dict, h: torch.Tensor, cache: dict,
                  pos: int) -> torch.Tensor:
    if cfg.block_type == BLOCK_SSM:
        y, cache["ssm"] = mamba.mamba_decode(cfg, p["ssm"], h, cache["ssm"])
        return y
    if cfg.block_type == BLOCK_ATTN and cfg.mla is not None:
        y, cache["attn"] = attn.mla_decode(cfg, p["attn"], h, cache["attn"],
                                           pos)
        return y
    a, cache["attn"] = attn.gqa_decode(cfg, p["attn"], h, cache["attn"], pos)
    if cfg.block_type == BLOCK_ATTN:
        return a
    s, cache["ssm"] = mamba.mamba_decode(cfg, p["ssm"], h, cache["ssm"])
    return _fuse(cfg, p, a, s)


def block_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                 pos: int):
    """x: (B,1,D) -> (x', cache), the cache updated in place."""
    h = rmsnorm_apply(p["norm_mix"], x, cfg.norm_eps)
    x = x + _mixer_decode(cfg, p, h, cache, pos)
    if "norm_ffn" in p:
        x = x + _ffn(cfg, p, x)[0]
    return x, cache
