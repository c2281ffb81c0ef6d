"""Decoder-only LM: embeddings -> the stacked blocks -> head — the
counterpart of ``repro.models.model``.

Handles the three modalities of the reference:

* text — tokens (B, S) integers;
* vision (VLM backbone) — stub patch embeddings ``prefix_embeds``
  (B, S_img, D) prepended to the text-token embeddings (the ViT and
  projector are the allowed frontend stub); logits cover prefix and text;
* audio (MusicGen backbone) — ``AUDIO_CODEBOOKS`` = K codebook token
  streams (B, S, K); the embedding is the sum over the codebooks' (K, V,
  D) tables, in codebook order, and the head predicts K vocabularies,
  logits (B, S, K, V).

The parameter tree is the reference's: plain dicts, with every leaf of
``blocks`` stacked on a leading L axis, so ``repro_torch.convert`` carries
weights across unchanged. A block is any of ``repro_torch.models.blocks``'
(dense or MoE FFN; GQA, MLA, SSM or hybrid mixer); the decode cache is
per block a KV cache (MLA: the latent and rotary-key cache), the SSM
state ``(B, H, P, N)`` in f32 and the conv state ``(B, d_conv - 1, C)`` in
the model's dtype, or both for a hybrid block. The reference's
``lax.scan`` over layers is a Python loop over the views
``blocks[...][i]``, and the auxiliary (MoE load-balance) loss is the sum
of the layers' in layer order; ``constrain`` and ``gather_weight`` are
identities on one device and have no port.

``lm_loss`` is the reference's next-token cross-entropy in f32 (with
``loss_mask``, the vision prefix's logits dropped, audio's (B, S, K)
labels, plus the auxiliary loss); ``_xent`` is plain PyTorch, as the
reference computes it outside any Pallas kernel. On the card its
gradient flows through the kernels' backward kernels
(``repro_torch.kernels.ops``), under ``loss.backward()``,
``torch.func.grad`` and the learners' ``torch.func.vmap`` alike.

``remat=True`` (``lm_apply``, ``lm_forward``, ``lm_loss``; the
reference's ``jax.checkpoint`` of each layer) runs every layer through
``RematLayer``, an autograd Function that keeps only the layer's inputs
and runs the layer again under ``torch.func.vjp`` in its backward. Its
vmap rule is generated, so it composes with ``loss.backward()``,
``torch.func.grad`` and the learners' ``vmap``, with the same gradient.
Under ``loss.backward()`` or ``torch.autograd.grad`` (the σ_1 step's,
``train/step.py``) a layer's activations then live only while its
gradient is taken; ``torch.func.grad`` differentiates with
``create_graph``, which keeps the recomputed activations until the
gradient returns, so there the peak does not fall (llama3-8b at 4
layers, S = 4,096, f32 on an H100: 18.67 GB against 23.92 by
``backward()``, 35.87 against 34.93 by ``torch.func.grad``;
``benchmarks/torch_remat_memory.py``). On the card
the second forward launches the layer's kernels again: each forward
kernel of a layer launches twice a step, its backward kernels once.

Departures: ``lm_apply`` numbers positions from 0 (no ``positions``
argument); ``lm_decode_step`` updates the cache in place and takes
``pos`` as a host int. ``init_lm_params`` draws from a
``torch.Generator`` seeded with ``seed`` on the target device (the
reference's ``jax.random`` draws differ; parity tests carry the
reference's weights across with ``convert``). ``_xent`` picks the
label's logit with ``gather`` where the reference sums a masked row
(its form for a vocab sharded over a mesh): the same value, one term.
"""
from __future__ import annotations

import torch

from repro_torch.config import MODALITY_AUDIO, ModelConfig
from repro_torch.core.flatten import (
    tree_leaves, tree_map, tree_structure, tree_unflatten,
)
from repro_torch.device import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (
    dense_init, embed_init, rmsnorm_apply, rmsnorm_init,
)


AUDIO_CODEBOOKS = 4


def init_lm_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                   device="cuda") -> dict:
    """Fresh LM parameters on ``device`` (the card unless the caller asks
    for the CPU), drawn from a ``torch.Generator`` seeded with ``seed``.
    Each layer is drawn and copied into the stacked leaves in turn, so
    the peak is the model plus one layer."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    audio = cfg.modality == MODALITY_AUDIO
    if audio:
        embed = torch.stack([embed_init(g, cfg.vocab_size, cfg.d_model, dtype)
                             for _ in range(AUDIO_CODEBOOKS)])  # (K, V, D)
    else:
        embed = embed_init(g, cfg.vocab_size, cfg.d_model, dtype)
    p = {"embed": embed}
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
        p["lm_head"] = dense_init(
            g, cfg.d_model,
            cfg.vocab_size * (AUDIO_CODEBOOKS if audio else 1), dtype)
    return p


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _embed_tokens(cfg: ModelConfig, params: dict,
                  tokens: torch.Tensor) -> torch.Tensor:
    if cfg.modality == MODALITY_AUDIO:
        # tokens (B, S, K), embed (K, V, D): the sum over codebooks
        e = params["embed"][0][tokens[..., 0]]
        for k in range(1, AUDIO_CODEBOOKS):
            e = e + params["embed"][k][tokens[..., k]]
        return e
    return params["embed"][tokens]


def _head(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(h, params["embed"].t())
    logits = torch.matmul(h, params["lm_head"])
    if cfg.modality == MODALITY_AUDIO:
        B, S, _ = logits.shape
        return logits.reshape(B, S, AUDIO_CODEBOOKS, cfg.vocab_size)
    return logits


class RematLayer(torch.autograd.Function):
    """One layer's ``block_forward`` that saves only its inputs:
    ``apply(cfg, structure, x, positions, *leaves) -> (x', aux[, keep])``,
    ``leaves`` the layer's parameters in ``tree_leaves`` order and
    ``keep`` the MoE layer's kept mask (not differentiable). The backward
    runs the layer again under ``torch.func.vjp``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(cfg, structure, x, positions, *leaves):
        y, aux, keep = blk.block_forward(
            cfg, tree_unflatten(structure, leaves), x, positions)
        return (y, aux) if keep is None else (y, aux, keep)

    @staticmethod
    def setup_context(ctx, inputs, output):
        cfg, structure, x, positions, *leaves = inputs
        ctx.save_for_backward(x, positions, *leaves)
        ctx.layer = (cfg, structure)
        if len(output) == 3:
            ctx.mark_non_differentiable(output[2])

    @staticmethod
    def backward(ctx, dy, daux, *_):
        x, positions, *leaves = ctx.saved_tensors
        cfg, structure = ctx.layer

        def layer(x, *leaves):
            y, aux, _ = blk.block_forward(
                cfg, tree_unflatten(structure, leaves), x, positions)
            return y, aux

        _, vjp = torch.func.vjp(layer, x, *leaves)
        dx, *dleaves = vjp((dy, daux))
        return (None, None, dx, None, *dleaves)


def _block(cfg: ModelConfig, p: dict, x: torch.Tensor,
           positions: torch.Tensor, remat: bool):
    if not remat:
        return blk.block_forward(cfg, p, x, positions)
    out = RematLayer.apply(cfg, tree_structure(p), x, positions,
                           *tree_leaves(p))
    return out if len(out) == 3 else (*out, None)


def lm_apply(cfg: ModelConfig, params: dict, tokens=None, *,
             prefix_embeds=None, remat: bool = False):
    """Forward pass -> (logits, aux_loss f32 scalar): tokens (B, S) (audio:
    (B, S, K)); ``prefix_embeds`` (B, S_img, D), the vision stub's patch
    embeddings, prepended to the token embeddings (or alone, without
    tokens). Logits cover the whole (prefix + text) sequence: (B, S, V),
    audio (B, S, K, V). ``remat`` recomputes each layer in the backward."""
    logits, aux, _ = lm_forward(cfg, params, tokens,
                                prefix_embeds=prefix_embeds, remat=remat)
    return logits, aux


def lm_forward(cfg: ModelConfig, params: dict, tokens=None, *,
               prefix_embeds=None, remat: bool = False):
    """``lm_apply`` with the routing: (logits, aux_loss, keeps), ``keeps``
    the MoE layers' kept (token, k) masks in layer order (``moe_apply``),
    empty without experts."""
    if tokens is not None:
        x = _embed_tokens(cfg, params, tokens)
    else:
        x, prefix_embeds = prefix_embeds, None
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    keeps = []
    for i in range(cfg.num_layers):
        x, a, keep = _block(cfg, _layer(params["blocks"], i), x, positions,
                            remat)
        aux = aux + a
        if keep is not None:
            keeps.append(keep)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return _head(cfg, params, x), aux, keeps


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position cross-entropy in f32: ``logsumexp(logits) -
    logits[label]`` over the last axis."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return lse - picked


def lm_loss(cfg: ModelConfig, params: dict, batch: dict,
            remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy, the f32 scalar mean, plus the auxiliary
    (MoE load-balance) loss: ``batch`` holds ``tokens`` and ``labels``
    (audio: (B, S, K) both) and optionally ``prefix_embeds`` (whose
    positions' logits are dropped) and ``loss_mask`` (B, S) (the masked
    mean, over at least 1). ``remat`` recomputes each layer in the
    backward (``RematLayer``)."""
    prefix = batch.get("prefix_embeds")
    logits, aux = lm_apply(cfg, params, batch.get("tokens"),
                           prefix_embeds=prefix, remat=remat)
    labels = batch["labels"]
    if cfg.modality == MODALITY_AUDIO:
        nll = torch.mean(_xent(logits, labels))
    else:
        if prefix is not None:
            logits = logits[:, prefix.shape[1]:, :]
        nll = _xent(logits, labels)
        mask = batch.get("loss_mask")
        if mask is not None:
            nll = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        else:
            nll = torch.mean(nll)
    return nll + aux.float()


def init_lm_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype=torch.float32, device="cuda") -> dict:
    """Stacked (L-leading) cache tree, on ``device``: KV (or MLA latent)
    caches, SSM and conv states, or both."""
    dev = resolve_device(device)
    one = blk.block_cache_init(cfg, batch, max_seq, dtype, dev)
    return tree_map(lambda a: a[None].repeat(
        (cfg.num_layers,) + (1,) * a.dim()), one)


def lm_decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                   cache: dict, pos: int):
    """One decode step. token: (B,) integers (audio: (B, K)); pos: the
    tokens already in the cache. Returns (logits (B, V) (audio:
    (B, K, V)), cache), the cache updated in place."""
    x = _embed_tokens(cfg, params, token[:, None])
    for i in range(cfg.num_layers):
        x, _ = blk.block_decode(cfg, _layer(params["blocks"], i), x,
                                _layer(cache, i), pos)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return _head(cfg, params, x)[:, 0], cache
