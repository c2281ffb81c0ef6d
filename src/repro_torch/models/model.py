"""Decoder-only LM: embeddings -> the stacked blocks -> head — the
counterpart of ``repro.models.model`` for the text modality.

The parameter tree is the reference's: plain dicts, with every leaf of
``blocks`` stacked on a leading L axis, so ``repro_torch.convert`` carries
weights across unchanged. The blocks are dense attention blocks
(``{"norm_mix", "attn", "norm_ffn", "ffn"}``) or Mamba2 SSM blocks
(``{"norm_mix", "ssm"}``); the decode cache is a KV cache per attention
block, or per SSM block the SSM state ``(B, H, P, N)`` in f32 and the conv
state ``(B, d_conv - 1, C)`` in the model's dtype (``max_seq`` unused
there, as in the reference). The reference's ``lax.scan`` over layers is a
Python loop over the views ``blocks[...][i]``; ``constrain`` and
``gather_weight`` are identities on one device and have no port.

Departures: ``lm_apply`` takes tokens only and numbers them from 0 (the
reference's ``prefix_embeds`` belongs to the vision modality and
``remat`` to training, neither ported); its auxiliary loss is 0 for the
dense FFN. ``lm_decode_step`` updates the cache in place and takes
``pos`` as a host int. ``init_lm_params`` draws from a ``torch.Generator``
seeded with ``seed`` on the target device (the reference's
``jax.random`` draws differ; parity tests carry the reference's weights
across with ``convert``). ``lm_loss`` comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.flatten import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (
    dense_init, embed_init, rmsnorm_apply, rmsnorm_init,
)


def init_lm_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                   device="cuda") -> dict:
    """Fresh LM parameters on ``device`` (the card unless the caller asks
    for the CPU), drawn from a ``torch.Generator`` seeded with ``seed``.
    Each layer is drawn and copied into the stacked leaves in turn, so
    the peak is the model plus one layer."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    p = {"embed": embed_init(g, cfg.vocab_size, cfg.d_model, dtype)}
    stacked = None
    for i in range(cfg.num_layers):
        layer = blk.block_init(cfg, g, dtype)
        if stacked is None:
            stacked = tree_map(lambda a: torch.empty(
                (cfg.num_layers,) + tuple(a.shape), dtype=a.dtype,
                device=dev), layer)
        for dst, src in zip(tree_leaves(stacked), tree_leaves(layer)):
            dst[i].copy_(src)
        del layer
    p["blocks"] = stacked
    p["final_norm"] = rmsnorm_init(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(g, cfg.d_model, cfg.vocab_size, dtype)
    return p


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _embed_tokens(cfg: ModelConfig, params: dict,
                  tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def _head(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(h, params["embed"].t())
    return torch.matmul(h, params["lm_head"])


def lm_apply(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Forward pass over tokens (B, S) -> (logits (B, S, V), aux_loss)."""
    x = _embed_tokens(cfg, params, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for i in range(cfg.num_layers):
        x = blk.block_forward(cfg, _layer(params["blocks"], i), x, positions)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return _head(cfg, params, x), torch.zeros((), device=x.device)


def init_lm_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype=torch.float32, device="cuda") -> dict:
    """Stacked (L-leading) cache tree, on ``device``: KV caches, or SSM
    and conv states."""
    dev = resolve_device(device)
    one = blk.block_cache_init(cfg, batch, max_seq, dtype, dev)
    return tree_map(lambda a: a[None].repeat(
        (cfg.num_layers,) + (1,) * a.dim()), one)


def lm_decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                   cache: dict, pos: int):
    """One decode step. token: (B,) integers; pos: the tokens already in
    the cache. Returns (logits (B, V), cache), the cache updated in
    place."""
    x = _embed_tokens(cfg, params, token[:, None])
    for i in range(cfg.num_layers):
        x, _ = blk.block_decode(cfg, _layer(params["blocks"], i), x,
                                _layer(cache, i), pos)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return _head(cfg, params, x)[:, 0], cache
