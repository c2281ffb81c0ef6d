"""Mixture-of-experts FFN with top-k routing and capacity-bucketed
dispatch — the counterpart of ``repro.models.moe``.

GShard-style grouped dispatch, as in the reference: the token stream is
cut into ``G`` groups of ``g = min(S, MOE_GROUP_TOKENS)`` tokens; each
group routes its tokens into per-expert buckets of
``C = group_capacity(...)`` slots; the expert FFNs run batched over the
expert axis; the outputs are combined with the router weights. The
routing keeps the reference's semantics exactly:

* the router's logits are the product in the model's dtype, then f32;
  the softmax is f32;
* top-K by a stable descending sort, so ties go to the lower expert
  index as ``jax.lax.top_k``'s do (``torch.topk`` promises no order on
  ties), then the K gates renormalized;
* the slot of each (token, k) in its expert's bucket is an exclusive
  cumsum over the group in token-major-then-k order; slots ``>= C``
  are dropped (gate 0);
* the Switch load-balance loss ``E * sum(mean p * mean count) * coef``;
* DeepSeek-style shared experts (a SwiGLU of ``num_shared_experts``
  times the expert width) added for every token.

Departures in form, not in result: the reference dispatches and
combines with one-hot einsums (moe.py:101-118, ``O(T E C D)``); here
dispatch gathers the token rows into the ``(E, G * C, D)`` expert
input by index (a one-hot product with one nonzero term per slot is
that row, bit for bit), and the combine gathers each token's K expert
outputs and adds them weighted in k order. No float atomics
(``index_add_``/``scatter_add_`` of floats are not deterministic on
CUDA): the only scatter writes integer token ids, each kept slot once.
The expert products are ``torch.bmm`` over E, as the reference leaves
them to XLA outside any Pallas kernel.

Every op batches under the learners' ``torch.func.vmap`` (the fleet's
``vmap(grad_and_value(lm_loss))``): the one-hot of the chosen experts
is a comparison with ``arange(E)`` (``F.one_hot`` reads its values'
range on the host, which vmap refuses), and the bucket index is an
out-of-place ``scatter`` (an in-place one into the unbatched
``torch.full`` cannot take the learners' values). Both give the same
values as the ops they replace.

``moe_apply`` also returns its ``keep`` mask (G, g, K), which
(token, k) pairs its buckets kept, on the device, so a caller can
compare kept sets or report the dropped share without a host sync per
layer (``repro_torch.models.model.lm_forward`` gathers one a layer).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import swiglu_apply, swiglu_init

MOE_GROUP_TOKENS = 1024  # tokens per dispatch group (capped by seq len)


def moe_init(cfg: ModelConfig, generator: torch.Generator,
             dtype=torch.float32) -> dict:
    """Router (d, E), expert weights stacked on a leading E axis
    (``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d)), Glorot-uniform
    per expert as the reference draws them, and the shared experts'
    SwiGLU when the config has any."""
    m = cfg.moe
    d, eff, E = cfg.d_model, cfg.moe.expert_d_ff or cfg.d_ff, m.num_experts
    dev = generator.device

    def stacked(d_in, d_out):
        lim = math.sqrt(6.0 / (d_in + d_out))
        w = torch.empty((E, d_in, d_out), dtype=dtype, device=dev)
        return w.uniform_(-lim, lim, generator=generator)

    lim = math.sqrt(6.0 / (d + E))
    router = torch.empty((d, E), dtype=dtype, device=dev)
    p = {"router": router.uniform_(-lim, lim, generator=generator),
         "w_gate": stacked(d, eff), "w_up": stacked(d, eff),
         "w_down": stacked(eff, d)}
    if m.num_shared_experts:
        p["shared"] = swiglu_init(generator, d, m.num_shared_experts * eff,
                                  dtype)
    return p


def group_capacity(m, group_tokens: int) -> int:
    """Slots per expert and group: ``int()`` truncation, at least 4
    (moe.py:60-62)."""
    cap = int(m.capacity_factor * group_tokens * m.num_experts_per_tok
              / m.num_experts)
    return max(cap, 4)


def moe_route(cfg: ModelConfig, params: dict, xt: torch.Tensor) -> dict:
    """The routing of grouped tokens ``xt`` (G, g, D): ``probs`` (G, g, E)
    f32, ``gate_idx`` (G, g, K) int64, ``gate`` (G, g, K) f32 (0 where
    dropped), ``slot`` (G, g, K) int64 (each pair's place in its
    expert's bucket), ``keep`` (G, g, K) bool, ``capacity`` C and the
    auxiliary loss ``aux`` (f32 scalar)."""
    m = cfg.moe
    K, E = m.num_experts_per_tok, m.num_experts
    G, g, _ = xt.shape
    logits = torch.matmul(xt, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)                        # (G,g,E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, gate_idx = vals[..., :K], idx[..., :K]
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)

    # one_hot reads its values' range on the host, which vmap refuses
    onehot = (gate_idx[..., None] == torch.arange(
        E, dtype=gate_idx.dtype, device=gate_idx.device)).to(gate_idx.dtype)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(onehot.sum(dim=2).float(), dim=(0, 1))
    aux = E * torch.sum(me * ce) * m.router_aux_loss_coef

    C = group_capacity(m, g)
    # exclusive running count of each expert over (token, k), token-major
    count = torch.cumsum(onehot.reshape(G, g * K, E), dim=1)
    slot = count.gather(-1, gate_idx.reshape(G, g * K, 1)).reshape(
        G, g, K) - 1
    keep = slot < C
    return {"probs": probs, "gate_idx": gate_idx,
            "gate": gate * keep.to(gate.dtype), "slot": slot, "keep": keep,
            "capacity": C, "aux": aux}


def moe_apply(cfg: ModelConfig, params: dict, x: torch.Tensor):
    """x: (B, S, D) -> (out (B, S, D), aux_loss f32 scalar, keep (G, g, K)
    bool: the (token, k) pairs the buckets kept)."""
    m = cfg.moe
    B, S, D = x.shape
    K, E = m.num_experts_per_tok, m.num_experts
    g = min(S, MOE_GROUP_TOKENS)
    if (B * S) % g != 0:
        raise ValueError(
            f"token count B*S={B * S} must divide into MoE routing "
            f"groups of {g} tokens")
    G = (B * S) // g
    xt = x.reshape(G, g, D)
    r = moe_route(cfg, params, xt)
    C, keep = r["capacity"], r["keep"]

    # dispatch: each kept (token, k) writes its token id into its slot of
    # the (E, C) buckets; empty slots read the zero row g
    flat = torch.where(keep, r["gate_idx"] * C + r["slot"], E * C)
    tok = torch.arange(g, device=x.device).expand(G, K, g).transpose(1, 2)
    idx = torch.full((G, E * C + 1), g, dtype=torch.long, device=x.device)
    idx = idx.scatter(1, flat.reshape(G, g * K), tok.reshape(G, g * K))
    idx = idx[:, :E * C]
    x_pad = torch.cat([xt, xt.new_zeros((G, 1, D))], dim=1)
    ein = torch.gather(x_pad, 1, idx[..., None].expand(G, E * C, D))
    ein = ein.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)

    h = F.silu(torch.bmm(ein, params["w_gate"])) * torch.bmm(
        ein, params["w_up"])
    eout = torch.bmm(h, params["w_down"])                        # (E,G*C,D)
    eout = eout.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)

    # combine: each token's K expert outputs, weighted, added in k order
    eout = torch.cat([eout, eout.new_zeros((G, 1, D))], dim=1)
    vals = torch.gather(eout, 1, flat.reshape(G, g * K, 1).expand(
        G, g * K, D)).reshape(G, g, K, D)
    gate = r["gate"].to(x.dtype)
    out = vals[:, :, 0] * gate[..., 0, None]
    for k in range(1, K):
        out = out + vals[:, :, k] * gate[..., k, None]
    if m.num_shared_experts:
        out = out + swiglu_apply(params["shared"], xt)
    return out.reshape(B, S, D), r["aux"].float(), keep
