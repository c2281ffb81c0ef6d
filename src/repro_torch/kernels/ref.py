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

import math

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
    """Row-wise RMS normalization. x: (..., D), scale: (D,), or (g, D)
    for g equal groups of consecutive rows (the kernel's grouped form);
    statistics in f32, the result in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale.dim() == 2:
        g, D = scale.shape
        y = y.reshape(g, -1, D) * scale.float()[:, None]
        return y.reshape(x.shape).to(x.dtype)
    return (y * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5):
    """The plain version of the ``rmsnorm_bwd`` kernel: (dx, dscale), the
    autograd gradient of ``rmsnorm_ref`` at dy."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        sg = scale.detach().requires_grad_()
        dx, ds = torch.autograd.grad(rmsnorm_ref(xg, sg, eps), (xg, sg), dy)
    return dx, ds


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """Masked softmax attention. q, k: (B, Sq | Sk, d), v: (B, Sk, dv) ->
    (B, Sq, dv) in q's dtype (dv = d but for MLA's wider queries and
    keys).

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
        outs.append(torch.einsum("bqk,bke->bqe", p,
                                 v[b:b + step].float()).to(q.dtype))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def flash_attention_gqa_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0,
                            scale: float | None = None) -> torch.Tensor:
    """GQA front end of ``flash_attention_ref``, as
    ``repro.kernels.ops.flash_attention_gqa`` folds it: q (B, Sq, H, d),
    k (B, Sk, Hkv, d), v (B, Sk, Hkv, dv) -> (B, Sq, H, dv); query head h
    reads kv head ``h // (H // Hkv)``."""
    B, Sq, H, d = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, d).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(B * H, Sq, d)
    kg = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(
        B * H, Sk, d)
    vg = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(
        B * H, Sk, dv)
    out = flash_attention_ref(qg, kg, vg, causal=causal, window=window,
                              scale=scale)
    out = out.reshape(B, Hkv, G, Sq, dv).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, dv)


def flash_attention_gqa_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, do: torch.Tensor, *,
                                causal: bool = True, window: int = 0,
                                scale: float | None = None):
    """The plain version of the ``attention_bwd`` kernel: (dq, dk, dv),
    the autograd gradient of ``flash_attention_gqa_ref`` at do."""
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        o = flash_attention_gqa_ref(qg, kg, vg, causal=causal, window=window,
                                    scale=scale)
        return torch.autograd.grad(o, (qg, kg, vg), do)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      scale: float | None = None) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled kept scores, f32, (B, H,
    Sq) for q (B, Sq, H, d) and k (B, Sk, Hkv, d): what the f32 attention
    program writes for the backward (-inf for a row that keeps nothing)."""
    B, Sq, H, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kx = k.float().repeat_interleave(H // Hkv, dim=2)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    out = []
    for h in range(H):
        s = torch.einsum("bqd,bkd->bqk", q[:, :, h].float(),
                         kx[:, :, h]) * scale
        out.append(torch.logsumexp(torch.where(mask, s, -math.inf), -1))
    return torch.stack(out, dim=1)


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
    h (BH, P, N) in f32), in f32 throughout (in float64 where x is
    float64, for the backward kernel's float64 check):
        h_t = exp(dt_t * a) h_{t-1} + dt_t * x_t b_t^T,   y_t = h_t c_t
    (y_t[p] = sum_n h_t[p, n] c_t[n]). ``chunk`` is ignored, as in the
    reference.
    """
    del chunk
    work = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, dtf, af, bf, cf = (t.to(work) for t in (x, dt, a, b, c))
    BH, S, P = xf.shape
    h = torch.zeros((BH, P, bf.shape[-1]), dtype=work, device=x.device)
    ys = []
    for t in range(S):
        dtt = dtf[:, t, None, None]
        h = torch.exp(dtt * af[:, None, None]) * h + dtt * (
            xf[:, t, :, None] * bf[:, t, None, :])
        ys.append(torch.bmm(h, cf[:, t, :, None])[..., 0])     # (BH, P)
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((BH, 0, P))
    return y.to(x.dtype), h


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                     dh: torch.Tensor | None = None):
    """The plain version of the ``ssd_scan_bwd`` kernel: (dx, ddt, da, db,
    dc), the autograd gradient of ``ssd_scan_ref`` at the cotangents dy
    of y and dh of the final state (None: zero). b and c may be (BH / R,
    S, N), head bh reading row ``bh // R``; db and dc then sum each row's
    R heads in head order. Its autograd keeps two (BH, P, N) tensors a
    step of S."""
    R = x.shape[0] // b.shape[0]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (
            x, dt, a, b.repeat_interleave(R, 0), c.repeat_interleave(R, 0))]
        y, h = ssd_scan_ref(*leaves)
        outs, cots = ([y, h], [dy, dh]) if dh is not None else ([y], [dy])
        dx, ddt, da, db, dc = torch.autograd.grad(outs, leaves, cots)
    if R > 1:
        db, dc = (g.view(b.shape[0], R, *g.shape[1:]) for g in (db, dc))
        sb, sc = db[:, 0].clone(), dc[:, 0].clone()
        for i in range(1, R):
            sb += db[:, i]
            sc += dc[:, i]
        db, dc = sb, sc
    return dx, ddt, da, db, dc
