"""Plain PyTorch versions of the port's kernels — the counterpart of
``repro.kernels.ref``.

They are the correctness references: the CPU runs them in place of the
kernels, and ``chip_smoke.py`` holds each kernel against them on the
card.

Departure from the reference: ``flash_attention_ref`` computes the
scores a slice of the batch axis at a time, so that a long sequence
never holds more than about 1 GiB of f32 scores at once; each slice is
the reference's arithmetic unchanged.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
_SCORE_BYTES = 1 << 30          # f32 scores computed at once, at most


def sqdist_ref(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """||x - r||^2 in f32. x, r: any same-shape tensors."""
    d = x.float() - r.float()
    return torch.sum(d * d)


def sqdist_rows_ref(X: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Row-wise ||X[i] - r||^2 in f32: X (m, P), r (P,) -> (m,); with r
    (g, P), g dividing m, row i against r[i // (m // g)]."""
    if r.dim() == 2:
        g, P = r.shape
        d = X.float().view(g, -1, P) - r.float()[:, None]
        return torch.sum(d * d, dim=2).reshape(-1)
    d = X.float() - r.float()[None]
    return torch.sum(d * d, dim=1)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Row-wise RMS normalization. x: (..., D), scale: (D,); statistics
    in f32, the result in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """Masked softmax attention. q: (B, Sq, d), k/v: (B, Sk, d) ->
    (B, Sq, d) in q's dtype.

    The causal diagonal is right-aligned (query row i sits at position
    ``i + Sk - Sq``); ``window`` > 0 adds sliding-window masking (key
    positions in ``(qpos - window, qpos]``). Masked scores are -1e30.
    """
    B, Sq, d = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    step = max(1, _SCORE_BYTES // max(1, 4 * Sq * Sk))
    outs = []
    for b in range(0, B, step):
        s = torch.einsum("bqd,bkd->bqk", q[b:b + step].float(),
                         k[b:b + step].float()) * scale
        s = torch.where(mask[None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bqk,bkd->bqd", p,
                                 v[b:b + step].float()).to(q.dtype))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def flash_attention_gqa_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0,
                            scale: float | None = None) -> torch.Tensor:
    """GQA front end of ``flash_attention_ref``, as
    ``repro.kernels.ops.flash_attention_gqa`` folds it: q (B, Sq, H, d),
    k/v (B, Sk, Hkv, d) -> (B, Sq, H, d); query head h reads kv head
    ``h // (H // Hkv)``."""
    B, Sq, H, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, d).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(B * H, Sq, d)
    kg = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(
        B * H, Sk, d)
    vg = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(
        B * H, Sk, d)
    out = flash_attention_ref(qg, kg, vg, causal=causal, window=window,
                              scale=scale)
    out = out.reshape(B, Hkv, G, Sq, d).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, d)


def check_swa_shape(S: int, window: int) -> None:
    """The banded kernel's precondition (swa_attention.py:71)."""
    if window < 1 or S % window != 0 or S < window:
        raise ValueError(
            f"sequence length must be a multiple of the window and at "
            f"least one window long: S={S}, window={window}")


def swa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, window: int,
                      scale: float | None = None) -> torch.Tensor:
    """Causal sliding-window attention behind the banded kernel's
    ``S % window == 0`` check: q, k, v (B, S, d), or the GQA layout
    q (B, S, H, d), k/v (B, S, Hkv, d)."""
    check_swa_shape(q.shape[1], window)
    if q.dim() == 4:
        return flash_attention_gqa_ref(q, k, v, causal=True, window=window,
                                       scale=scale)
    return flash_attention_ref(q, k, v, causal=True, window=window,
                               scale=scale)



def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, *, chunk: int = 0):
    """Sequential (non-chunked) SSD reference.

    x: (BH, S, P) inputs; dt: (BH, S) step sizes (>0); a: (BH,) negative
    decay rates; b, c: (BH, S, N). Returns (y (BH, S, P) in x's dtype,
    h (BH, P, N) in f32), in f32 throughout:
        h_t = exp(dt_t * a) h_{t-1} + dt_t * x_t b_t^T,   y_t = h_t c_t
    (y_t[p] = sum_n h_t[p, n] c_t[n]). ``chunk`` is ignored, as in the
    reference.
    """
    del chunk
    xf, dtf, af, bf, cf = (t.float() for t in (x, dt, a, b, c))
    BH, S, P = xf.shape
    h = torch.zeros((BH, P, bf.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        dtt = dtf[:, t, None, None]
        h = torch.exp(dtt * af[:, None, None]) * h + dtt * (
            xf[:, t, :, None] * bf[:, t, None, :])
        ys.append(torch.bmm(h, cf[:, t, :, None])[..., 0])     # (BH, P)
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((BH, 0, P))
    return y.to(x.dtype), h
