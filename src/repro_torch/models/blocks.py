"""Decoder block — the counterpart of ``repro.models.blocks`` for the dense
attention block (``BLOCK_ATTN`` with a SwiGLU FFN) and the Mamba2 block
(``BLOCK_SSM``, no FFN).

One block's parameters are a dict; the model stacks L copies on a leading
axis. ``block_forward`` returns the new residual stream only: the
reference's second output, the MoE auxiliary loss, is always 0 for a
dense FFN or none. Hybrid blocks and MoE FFNs are not ported:
``ModelConfig`` refuses them.
"""
from __future__ import annotations

import torch

from repro_torch.config import BLOCK_ATTN, BLOCK_SSM, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba
from repro_torch.models.layers import (
    rmsnorm_apply, rmsnorm_init, swiglu_apply, swiglu_init,
)


def block_init(cfg: ModelConfig, generator: torch.Generator,
               dtype=torch.float32) -> dict:
    dev = generator.device
    p = {"norm_mix": rmsnorm_init(cfg.d_model, dtype, dev)}
    if cfg.block_type == BLOCK_ATTN:
        p["attn"] = attn.attn_init(cfg, generator, dtype)
    if cfg.block_type == BLOCK_SSM:
        p["ssm"] = mamba.mamba_init(cfg, generator, dtype)
    if cfg.d_ff:
        p["norm_ffn"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["ffn"] = swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype)
    return p


def _mixer_forward(cfg: ModelConfig, p: dict, h: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    if cfg.block_type == BLOCK_SSM:
        return mamba.mamba_forward(cfg, p["ssm"], h)
    return attn.gqa_forward(cfg, p["attn"], h, positions)


def block_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D) -> x'."""
    h = rmsnorm_apply(p["norm_mix"], x, cfg.norm_eps)
    x = x + _mixer_forward(cfg, p, h, positions)
    if "norm_ffn" in p:
        h = rmsnorm_apply(p["norm_ffn"], x, cfg.norm_eps)
        x = x + swiglu_apply(p["ffn"], h)
    return x


def block_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                     dtype=torch.float32, device=None) -> dict:
    """A block's decode cache: the KV cache of an attention block, the
    SSM and conv states of an SSM block (``max_seq`` unused there)."""
    if cfg.block_type == BLOCK_SSM:
        return {"ssm": mamba.mamba_cache_init(cfg, batch, dtype, device)}
    return {"attn": attn.attn_cache_init(cfg, batch, max_seq, dtype, device)}


def _mixer_decode(cfg: ModelConfig, p: dict, h: torch.Tensor, cache: dict,
                  pos: int):
    if cfg.block_type == BLOCK_SSM:
        y, cache["ssm"] = mamba.mamba_decode(cfg, p["ssm"], h, cache["ssm"])
        return y
    y, cache["attn"] = attn.gqa_decode(cfg, p["attn"], h, cache["attn"], pos)
    return y


def block_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                 pos: int):
    """x: (B,1,D) -> (x', cache), the cache updated in place."""
    h = rmsnorm_apply(p["norm_mix"], x, cfg.norm_eps)
    x = x + _mixer_decode(cfg, p, h, cache, pos)
    if "norm_ffn" in p:
        h = rmsnorm_apply(p["norm_ffn"], x, cfg.norm_eps)
        x = x + swiglu_apply(p["ffn"], h)
    return x, cache
