"""Mamba2 block via SSD (state-space duality), Dao & Gu 2024
[arXiv:2405.21060] — the counterpart of ``repro.models.mamba``.

``mamba_forward`` is the full-sequence forward (prefill): the input and
gate projections, the depthwise causal conv, then the SSD, which goes
through ``ops.ssd_scan`` in the kernel's layout ``(batch * head, S, .)``
with B and C as ``(batch * group, S, N)`` (each row read by its H / G
heads in place, not repeated), in f32 as at
mamba.py:150-154. On the card that is the hand-written chunked kernel;
on the CPU its plain version, the sequential recurrence. The
reference's ``_ssd_chunked`` and ``_segsum`` (the chunked SSD in jnp)
have no port: what they compute is the kernel's work. ``mamba_decode``
is the O(1) recurrent step, plain PyTorch as in the reference (which
runs no kernel there).

Shapes: x (B, S, D); d_inner = expand * D; H = d_inner / head_dim heads of
dim P; the B/C projections have G groups of state size N shared by
H / G heads each. The same module is the SSM branch of the Hymba hybrid
block (``repro_torch.models.blocks``; hymba-1.5b: d_inner 3,200, 50
heads of 64 in one group, N = 16), which needs nothing more of it.

Departures from the reference: ``mamba_init`` draws ``conv_w`` (scale
0.1) and the dense weights from an explicit ``torch.Generator`` (the
draws differ from ``jax.random``'s; ``A_log``, ``D`` and ``dt_bias`` are
the reference's deterministic leaves, ``A_log`` within an ulp or two of
XLA's ``log``); ``mamba_decode`` updates the cache IN PLACE and returns
the same dict; FSDP's ``gather_weight`` is the identity on one device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    causal_conv1d, causal_conv1d_update, dense_init, rmsnorm_apply,
    rmsnorm_init,
)


def mamba_dims(cfg: ModelConfig, d_model=None):
    s = cfg.ssm
    d = d_model or cfg.d_model
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    return d, d_inner, H, s.head_dim, s.ngroups, s.d_state


def mamba_init(cfg: ModelConfig, generator: torch.Generator,
               dtype=torch.float32) -> dict:
    s = cfg.ssm
    d, d_inner, H, P, G, N = mamba_dims(cfg)
    dev = generator.device
    conv_w = torch.empty((s.d_conv, d_inner + 2 * G * N), dtype=dtype,
                         device=dev)
    return {
        "w_xz": dense_init(generator, d, 2 * d_inner, dtype),
        "w_bc": dense_init(generator, d, 2 * G * N, dtype),
        "w_dt": dense_init(generator, d, H, dtype),
        "dt_bias": torch.zeros((H,), dtype=dtype, device=dev),
        "conv_w": conv_w.normal_(generator=generator) * 0.1,
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=dev)).to(dtype),
        "D": torch.ones((H,), dtype=dtype, device=dev),
        "out_norm": rmsnorm_init(d_inner, dtype, dev),
        "w_out": dense_init(generator, d_inner, d, dtype),
    }


def mamba_forward(cfg: ModelConfig, params: dict, x: torch.Tensor,
                  return_state: bool = False):
    """Full-sequence forward. x: (B, S, D) -> (B, S, D), and with
    ``return_state`` the final SSM state (B, H, P, N) in f32."""
    s = cfg.ssm
    d, d_inner, H, P, G, N = mamba_dims(cfg, x.shape[-1])
    Bb, S, _ = x.shape
    xs, z = torch.chunk(torch.matmul(x, params["w_xz"]), 2, dim=-1)
    bc = torch.matmul(x, params["w_bc"])
    dt = F.softplus(torch.matmul(x, params["w_dt"]) + params["dt_bias"])

    conv_in = torch.cat([xs, bc], dim=-1)
    conv_out = F.silu(causal_conv1d(conv_in, params["conv_w"]))
    xs = conv_out[..., :d_inner].reshape(Bb, S, H, P)
    bc = conv_out[..., d_inner:]
    B_ = bc[..., :G * N].reshape(Bb, S, G, N)
    C_ = bc[..., G * N:].reshape(Bb, S, G, N)

    A = -torch.exp(params["A_log"].float())
    # the kernel's layout: (batch * head, S, .), and B, C per group
    y, final_state = ops.ssd_scan(
        xs.float().permute(0, 2, 1, 3).reshape(Bb * H, S, P).contiguous(),
        dt.float().permute(0, 2, 1).reshape(Bb * H, S).contiguous(),
        A.repeat(Bb),
        B_.float().permute(0, 2, 1, 3).reshape(Bb * G, S, N).contiguous(),
        C_.float().permute(0, 2, 1, 3).reshape(Bb * G, S, N).contiguous(),
        chunk=s.chunk_size)
    y = y.reshape(Bb, H, S, P).permute(0, 2, 1, 3)
    y = y + xs.float() * params["D"].float()[None, None, :, None]
    y = y.reshape(Bb, S, d_inner).to(x.dtype)
    y = rmsnorm_apply(params["out_norm"], y * F.silu(z), cfg.norm_eps)
    out = torch.matmul(y, params["w_out"])
    if return_state:
        return out, final_state.reshape(Bb, H, P, N)
    return out


# ---------------------------------------------------------------------------
# decode (recurrent step)
# ---------------------------------------------------------------------------

def mamba_cache_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    s = cfg.ssm
    d, d_inner, H, P, G, N = mamba_dims(cfg)
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, d_inner + 2 * G * N),
                            dtype=dtype, device=device),
    }


def mamba_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                 cache: dict):
    """One-token step. x: (B, 1, D) -> (y (B, 1, D), cache), O(1) in the
    sequence length; the cache is updated in place."""
    d, d_inner, H, P, G, N = mamba_dims(cfg, x.shape[-1])
    Bb = x.shape[0]
    xt = x[:, 0, :]
    xs, z = torch.chunk(xt @ params["w_xz"], 2, dim=-1)
    bc = xt @ params["w_bc"]
    dt = F.softplus(xt @ params["w_dt"] + params["dt_bias"]).float()

    conv_in = torch.cat([xs, bc], dim=-1)
    conv_out, new_conv = causal_conv1d_update(cache["conv"], conv_in,
                                              params["conv_w"])
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :d_inner].reshape(Bb, H, P).float()
    bcv = conv_out[..., d_inner:]
    rep = H // G
    B_ = bcv[..., :G * N].reshape(Bb, G, N).repeat_interleave(rep, dim=1)
    C_ = bcv[..., G * N:].reshape(Bb, G, N).repeat_interleave(rep, dim=1)

    A = -torch.exp(params["A_log"].float())                    # (H,)
    dA = torch.exp(dt * A)                                      # (B, H)
    h = cache["ssm"]
    h.mul_(dA[:, :, None, None]).add_(
        (dt[:, :, None, None] * B_.float()[:, :, None, :])
        * xs[:, :, :, None])
    y = torch.einsum("bhn,bhpn->bhp", C_.float(), h)
    y = y + xs * params["D"].float()[None, :, None]
    y = y.reshape(Bb, d_inner).to(x.dtype)
    y = rmsnorm_apply(params["out_norm"], y * F.silu(z), cfg.norm_eps)
    cache["conv"].copy_(new_conv)
    return (y @ params["w_out"])[:, None, :], cache
