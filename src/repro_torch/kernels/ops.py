"""Public kernel entry points — the counterpart of ``repro.kernels.ops``.

Dispatch is by the device of the tensors: a CUDA tensor launches the
hand-written kernel (``repro_torch.kernels.sqdist``, ``.rmsnorm``,
``.flash_attention``, ``.swa_attention``, ``.ssd_scan``), a CPU tensor
runs the plain version (``repro_torch.kernels.ref``). There is no
fallback: a kernel that fails to build or launch raises.

``LAUNCHES`` counts kernel launches by kernel, so a run can show that
its main path went through the kernels, and ``ROWS_LAUNCHES`` splits the
``sqdist_rows`` count by ``(m, P, g)`` (g reference rows: 1, or a
hierarchy's clusters); ``reset_launches`` zeroes both. A ``meta`` tensor
takes the kernel's route without a launch (``_build``, "Meta calls"):
the wrapper checks its shapes and returns empty ``meta`` outputs, and
the call is listed in the active ``_build.tally`` blocks, with its work,
but counted in neither dict.
``flash_attention`` and its GQA front end ``flash_attention_gqa`` launch
the same kernel and count under ``"flash_attention"``. Plain-version
calls are not counted.

Gradients. Where a gradient is wanted on the card (an input requires
grad under grad mode, or is a ``torch.func`` transform's tensor),
``rmsnorm``, ``flash_attention(_gqa)`` and ``swa_attention`` at every
width pair of the forward (MLA's too) and ``ssd_scan``, in f32 and in
bf16, run through their autograd Functions (``rmsnorm.RMSNormFn``,
``flash_attention.AttentionFn``, the banded route with the window and
counted under ``"swa_attention"``, and ``ssd_scan.SSDScanFn`` after the
padding), whose backward is a kernel too (``"rmsnorm_bwd"``,
``"attention_bwd"``, ``"ssd_scan_bwd"`` in ``LAUNCHES``; bf16 attention
has its own backward program, a bf16 ``ssd_scan`` takes the f32 kernel
upcast, ``ssd_scan``'s docstring) and whose ``vmap`` rule makes one
launch a call whatever the vmapped size. The distance kernels raise
``NotImplementedError`` there, saying why none is needed, and so do a
norm past the backward's widest row, so no gradient is silently
missing. On the CPU the plain versions are differentiated as they
are.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F
from torch._C._functorch import is_functorch_wrapped_tensor

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import sqdist as _sqdist
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import swa_attention as _swa

LAUNCHES = _build.LAUNCHES
ROWS_LAUNCHES: Counter = Counter()
NO_SQDIST_BWD = ("no ROADMAP item: the protocol reads distances and "
                 "differentiates none")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ROWS_LAUNCHES.clear()


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def wants_grad(*tensors: torch.Tensor) -> bool:
    """Whether a gradient may flow through these inputs: one requires grad
    under grad mode, or one is a ``torch.func`` transform's tensor."""
    return any(is_functorch_wrapped_tensor(t) for t in tensors) or (
        torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


def _no_backward(what: str, item: str, *tensors: torch.Tensor) -> None:
    if wants_grad(*tensors):
        raise NotImplementedError(
            f"{what} has no backward kernel on the card, and a gradient or "
            f"a torch.func transform reaches it: {item}")


def sqdist_rows(X: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Batched local condition over the flat fleet plane:
    ``(m, P) x (P,) -> (m,)`` row-wise squared distances in f32; with r
    ``(g, P)`` every row against its cluster's reference row (g equal
    clusters of consecutive rows), in the same one launch."""
    if _on_cpu(X, r):
        return ref.sqdist_rows_ref(X, r)
    _no_backward("sqdist_rows", NO_SQDIST_BWD, X, r)
    out = _sqdist.sqdist_rows(X, r)
    shape = (*X.shape, 1 if r.dim() == 1 else r.shape[0])
    _build.launched("sqdist_rows", X.is_meta, _build.given, "sqdist_rows",
                    shape, X.dtype)
    if not X.is_meta:
        ROWS_LAUNCHES[shape] += 1
    return out


def sqdist(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``||x - r||^2`` over flattened same-shape inputs, in f32."""
    if _on_cpu(x, r):
        return ref.sqdist_ref(x, r)
    _no_backward("sqdist", NO_SQDIST_BWD, x, r)
    out = _sqdist.sqdist(x, r)
    _build.launched("sqdist", x.is_meta, _build.given, "sqdist",
                    (x.numel(),), x.dtype)
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """Row-wise RMS norm over the last axis: f32 statistics, x's dtype."""
    if _on_cpu(x, scale):
        return ref.rmsnorm_ref(x, scale, eps)
    if wants_grad(x, scale):
        _rmsnorm.differentiable(x)
        return _rmsnorm.RMSNormFn.apply(x, scale, eps)
    out = _rmsnorm.rmsnorm(x, scale, eps)
    _build.launched("rmsnorm", x.is_meta, _rmsnorm.work, x)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Masked softmax attention, q (B, Sq, d), k/v (B, Sk, d); the causal
    diagonal is right-aligned."""
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    if wants_grad(q, k, v):
        return flash_attention_gqa(q[:, :, None], k[:, :, None],
                                   v[:, :, None], causal=causal,
                                   window=window, scale=scale)[:, :, 0]
    out = _flash.flash_attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
    _build.launched("flash_attention", q.is_meta, _flash.work, q, k, v,
                    window)
    return out


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """GQA front end: q (B, S, H, d), k (B, S, Hkv, d), v (B, S, Hkv, dv)
    -> (B, S, H, dv); dv = d but for MLA's wider queries and keys."""
    if _on_cpu(q, k, v):
        return ref.flash_attention_gqa_ref(q, k, v, causal=causal,
                                           window=window, scale=scale)
    if wants_grad(q, k, v):
        _flash.differentiable(q, k, v, "flash_attention_gqa")
        return _flash.AttentionFn.apply(q, k, v, causal, window, scale)[0]
    out = _flash.flash_attention_gqa(q, k, v, causal=causal, window=window,
                                     scale=scale)
    _build.launched("flash_attention", q.is_meta, _flash.work, q, k, v,
                    window)
    return out


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, scale: float | None = None) -> torch.Tensor:
    """Causal banded sliding-window attention, ``S % window == 0``:
    q, k, v (B, S, d) or q (B, S, H, d), k/v (B, S, Hkv, d)."""
    if _on_cpu(q, k, v):
        return ref.swa_attention_ref(q, k, v, window=window, scale=scale)
    if wants_grad(q, k, v):
        return _swa.swa_attention_differentiable(q, k, v, window=window,
                                                 scale=scale)
    out = _swa.swa_attention(q, k, v, window=window, scale=scale)
    _build.launched("swa_attention", q.is_meta, _flash.work, q, k, v,
                    window)
    return out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 64):
    """Chunked SSD over (BH, S, *) layouts; pads S to a chunk multiple with
    zeros (dt = 0 there, so the padded steps leave the state untouched)
    and slices y back. b and c are (BH / R, S, N): head bh reads row
    ``bh // R`` (b and c per head, R = 1, is the reference's layout).
    Returns (y (BH, S, P) in x's dtype, h (BH, P, N) in f32)."""
    S = x.shape[1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        dt = F.pad(dt, (0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    if _on_cpu(x, dt, a, b, c):
        R = x.shape[0] // b.shape[0]
        if R > 1:
            b, c = b.repeat_interleave(R, dim=0), c.repeat_interleave(R, dim=0)
        y, h = ref.ssd_scan_ref(x, dt, a, b, c, chunk=chunk)
    elif wants_grad(x, dt, a, b, c):
        y, h, _ = _ssd.SSDScanFn.apply(x, dt, a, b, c, chunk)
    else:
        y, h = _ssd.ssd_scan(x, dt, a, b, c, chunk=chunk)
        _build.launched("ssd_scan", x.is_meta, _ssd.work, x, b, chunk)
    if pad:
        y = y[:, :S]
    return y, h
