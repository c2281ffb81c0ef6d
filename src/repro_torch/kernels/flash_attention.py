"""The attention kernel on the card — the counterpart of
``repro.kernels.flash_attention`` and of the GQA front end
``repro.kernels.ops.flash_attention_gqa``.

Both launch one of two programs of the ``attention`` library, chosen
by dtype (``PROGRAMS``): bf16 runs ``csrc/attention_sm90.cu`` (TMA-fed
``wgmma`` on the tensor cores, p split into two bf16 terms so the
result keeps the bf16 tolerance), f32 runs ``csrc/attention.cu``
(``mma.sync`` on the tensor cores in split TF32, three TF32 products a
product, fed by ``cp.async``: one TF32 product would miss the f32
tolerance). Each is compiled for the (query/key, value) head widths of
``WIDTHS``: equal widths of 32, 64 and 128, and MLA's wider queries and
keys (192, 128)
at deepseek-v2's width; f32 also takes (48, 32), the smoke config's. A
dtype or width pair that neither takes raises. Both compute online-softmax
attention with the causal diagonal right-aligned (query row i at
position ``i + Sk - Sq``), an optional sliding ``window`` and ``scale``,
f32 statistics and accumulator, output in q's dtype. Both read the GQA
layout ``q (B, Sq, H, d)``, ``k/v (B, Sk, Hkv, d)`` in place: query head
h reads kv head ``h // (H // Hkv)``, so nothing is transposed or
repeated (the reference folds ``(B, Hkv, G)`` into its batch axis and
repeats k and v). ``flash_attention`` on ``(B, S, d)`` is the case H = Hkv = 1. Key
positions ``>= Sk`` are masked in the kernel, so a ragged non-causal
``Sk`` is right, unlike the Pallas kernel (ROADMAP C1).

The wrappers take CUDA tensors only: they check device, dtype, shape,
contiguity and 16-byte alignment, allocate the output, launch on the
current stream, and raise on a launch error. Both programs run a
one-dimensional grid, so B * H has no limit of its own. ``repro_torch.kernels.ops`` picks them for CUDA
tensors and the plain versions for CPU tensors.

The gradient. The JAX package has no backward Pallas kernel (its
training differentiates jnp attention), so ``attention_bwd`` replaces
none. It has a program per dtype (``BWD_PROGRAMS``), each reading q, k,
v, o, do and the per-row log-sum-exp that its forward writes when
``with_lse`` asks for it (the serving path asks for none and launches as
before): f32 runs ``csrc/attention_bwd.cu`` (dq, dk and dv in f32 on the
tensor cores in split TF32, ``mma.sync`` m16n8k8, as the f32 forward),
bf16 runs ``csrc/attention_bwd_bf16.cu`` (TMA-fed ``wgmma``, a producer
warp and two consumer warpgroups, as the bf16 forward: one bf16 product
a product with f32 sums, P and dS rounded to bf16 as operands, where the
reference rounds its probabilities; dq, dk and dv written in bf16 once,
dk and dv summed over the kv head's group in the kernel's registers).
``AttentionFn`` is the autograd Function
that ``ops`` routes a CUDA call through when a gradient is wanted (an
input requires grad, or is a ``torch.func`` transform's tensor): its
backward calls ``AttentionBwdFn``, and each has a ``vmap`` rule that
folds the vmapped (learner) axis into the batch, so m learners are one
launch. They launch through the module's ``launch_forward`` and
``launch_backward``, which the CPU tests replace with stand-ins. Each
backward program takes every width pair of its dtype's forward
(``BWD_WIDTHS``), MLA's wider queries and keys too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# dtype -> (the program's name, its C entry point)
PROGRAMS = {torch.bfloat16: ("sm90_wgmma_tma", "repro_attention_sm90"),
            torch.float32: ("sm90_mma_tf32x3", "repro_attention")}
HEAD_DIMS = (32, 64, 128)
# (query/key width, value width) pairs each program is compiled for
WIDTHS = {torch.bfloat16: {(d, d) for d in HEAD_DIMS} | {(192, 128)},
          torch.float32: {(d, d) for d in HEAD_DIMS} | {(192, 128),
                                                        (48, 32)}}


# the backward by dtype: (its program's name, its library, its C entry
# point); f32 in split TF32 on mma.sync, as the f32 forward, bf16 on
# TMA-fed wgmma, as the bf16 forward
BWD_PROGRAMS = {
    torch.bfloat16: ("sm90_wgmma_tma", "attention_bwd_bf16",
                     "repro_attention_bwd_bf16"),
    torch.float32: ("sm90_mma_tf32x3", "attention", "repro_attention_bwd")}
# the (query/key, value) width pairs each backward takes: its forward's
BWD_WIDTHS = {t: WIDTHS[t] for t in BWD_PROGRAMS}


def program(dtype: torch.dtype) -> str:
    """The name of the program that runs attention in ``dtype``."""
    return PROGRAMS[dtype][0]


def bwd_program(dtype: torch.dtype) -> str:
    """The name of the program that runs the backward in ``dtype``."""
    return BWD_PROGRAMS[dtype][0]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int, scale: float | None,
              what: str = "flash_attention", with_lse: bool = False):
    """Launch the kernel on the GQA layout: q (B, Sq, H, d), k
    (B, Sk, Hkv, d), v (B, Sk, Hkv, dv) -> (B, Sq, H, dv); with
    ``with_lse`` -> (o, lse (B, H, Sq) f32), lse each row's log-sum-exp
    of its scaled kept scores, -inf where it keeps none. On ``meta``: the
    shapes checked, empty outputs, no launch."""
    meta = q.is_meta
    if not ((q.is_cuda or meta) and k.device == q.device
            and v.device == q.device):
        raise ValueError(
            f"{what} runs on one CUDA device: q on {q.device}, k on "
            f"{k.device}, v on {v.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape[:3] != v.shape[:3]:
        raise ValueError(
            f"{what} needs q (B, Sq, H, d), k (B, Sk, Hkv, d) and v "
            f"(B, Sk, Hkv, dv): got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    B, Sq, H, d = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != d or Hkv < 1 or H % Hkv:
        raise ValueError(
            f"{what}: k, v {tuple(k.shape)} do not match q {tuple(q.shape)} "
            f"(same batch and head dim, H a multiple of Hkv)")
    if q.dtype not in PROGRAMS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{what} takes float32 or bfloat16, q, k and v alike: got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if (d, dv) not in WIDTHS[q.dtype]:
        raise ValueError(
            f"{what} takes (query/key, value) head dims "
            f"{sorted(WIDTHS[q.dtype])} in {q.dtype}, got ({d}, {dv})")
    if meta:
        o = q.new_empty((B, Sq, H, dv))
        return (o, q.new_empty((B, H, Sq), dtype=torch.float32)) \
            if with_lse else o
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what} needs contiguous q, k and v")
    if min(B, Sq, Sk) < 1 or window < 0:
        raise ValueError(
            f"{what}: empty input or a negative window: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, window {window}")
    # TMA (bf16) and cp.async (f32) read 16-byte aligned addresses
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what} needs 16-byte aligned q, k and v")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{what} launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), q is on {q.device}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if with_lse:        # both programs write it at the backward's widths
        differentiable(q, k, v, what)
    lib = _build.library("attention")
    o = q.new_empty((B, Sq, H, dv))
    lse = q.new_empty((B, H, Sq), dtype=torch.float32) if with_lse else None
    name, entry = PROGRAMS[q.dtype]
    code = getattr(lib, entry)(
        d, dv, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, Hkv, Sq, Sk,
        int(causal), int(window), ctypes.c_float(scale),
        _build.current_stream(q.device.index))
    _build.check(lib, code, f"{what} launch ({name})")
    return (o, lse) if with_lse else o


def differentiable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   what: str = "flash_attention") -> None:
    """Raise ``NotImplementedError`` where no backward program takes
    these inputs: a dtype or a (query/key, value) width pair outside
    ``BWD_WIDTHS``. Each program takes every width pair its dtype's
    forward takes."""
    widths = (q.shape[-1], v.shape[-1])
    if widths not in BWD_WIDTHS.get(q.dtype, ()):
        raise NotImplementedError(
            f"{what} has no backward kernel at (query/key, value) widths "
            f"{widths} in {q.dtype}; it takes "
            f"{sorted(BWD_WIDTHS.get(q.dtype, ()))}")


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool, window: int, scale: float | None):
    """The backward kernel: (dq, dk, dv) of ``attention`` at q (B, Sq, H,
    d), k (B, Sk, Hkv, d), v (B, Sk, Hkv, dv), o and do (B, Sq, H, dv),
    all f32 or all bf16 on the card, and lse (B, H, Sq) f32, (d, dv) one
    of ``BWD_WIDTHS[dtype]``; the gradients in the inputs' dtype. f32:
    three CUDA launches (delta, dk/dv, dq) and, where H > Hkv, a fourth
    that sums the query heads' dk and dv partials in head order; bf16:
    three (delta, dk/dv, dq), a dk/dv block walking its kv head's query
    heads in order. No atomics: the same inputs give the same bits."""
    differentiable(q, k, v, "attention_bwd")
    B, Sq, H, d = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    tensors = (q, k, v, o, lse, do)
    meta = q.is_meta
    if not all((t.is_cuda or meta) and t.device == q.device
               for t in tensors):
        raise ValueError(
            f"attention_bwd runs on one CUDA device: got "
            f"{[str(t.device) for t in tensors]}")
    if (k.shape != (B, Sk, Hkv, d) or v.shape != (B, Sk, Hkv, dv)
            or o.shape != (B, Sq, H, dv) or do.shape != o.shape
            or lse.shape != (B, H, Sq) or Hkv < 1 or H % Hkv):
        raise ValueError(
            f"attention_bwd needs q (B, Sq, H, d), k (B, Sk, Hkv, d), v "
            f"(B, Sk, Hkv, dv), o, do (B, Sq, H, dv) and lse (B, H, Sq): "
            f"got {[tuple(t.shape) for t in tensors]}")
    if meta:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if (q.dtype not in BWD_PROGRAMS or lse.dtype != torch.float32
            or any(t.dtype != q.dtype for t in (k, v, o, do))):
        raise TypeError(f"attention_bwd takes q, k, v, o and do in float32 "
                        f"or bfloat16 alike and lse in float32: got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attention_bwd needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("attention_bwd needs 16-byte aligned q, k, v, o "
                         "and do")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(
            f"attention_bwd launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), q is on {q.device}")
    if window < 0:
        raise ValueError(f"attention_bwd: a negative window {window}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    name, library, entry = BWD_PROGRAMS[q.dtype]
    lib = _build.library(library)
    dq, dk, dvg = (torch.empty_like(q), torch.empty_like(k),
                   torch.empty_like(v))
    delta = lse.new_empty((B, H, Sq))
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dvg.data_ptr(), delta.data_ptr()]
    part = None
    if q.dtype == torch.float32:
        # the query heads' dk partials (B, Sk, H, d), then their dv
        # partials, where H > Hkv; the bf16 program sums each group in its
        # registers and takes no scratch
        if H > Hkv:
            part = lse.new_empty((B * Sk * H * (d + dv),))
        ptrs.append(None if part is None else part.data_ptr())
    code = getattr(lib, entry)(
        d, dv, *ptrs, B, H, Hkv, Sq, Sk, int(causal), int(window),
        ctypes.c_float(scale), _build.current_stream(q.device.index))
    _build.check(lib, code, f"attention_bwd launch ({name})")
    return dq, dk, dvg


def work(q, k, v, window: int) -> tuple:
    """``kernel_work``'s (name, shape, dtype) of one causal forward call
    on the GQA layout, or on (B, S, d) (one head): the banded form where
    the window drops keys (Sq = Sk), else the full one."""
    if q.dim() == 3:
        B, Sq, d = q.shape
        Sk, dv = k.shape[1], v.shape[2]
        H = Hkv = 1
    else:
        B, Sq, H, d = q.shape
        Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if 0 < window < Sk and Sq == Sk and d == dv:
        return "swa_attention", (B, Sq, H, Hkv, d, window), q.dtype
    return "flash_attention", (B, Sq, Sk, H, Hkv, d, dv), q.dtype


def bwd_work(q, k, v, window: int) -> tuple:
    """``kernel_work``'s (name, shape, dtype) of one causal backward
    call."""
    B, Sq, H, d = q.shape
    return "attention_bwd", (B, Sq, k.shape[1], H, k.shape[2],
                             (d, v.shape[3]), window), q.dtype


def launch_forward(q, k, v, causal, window, scale):
    """The forward kernel with the log-sum-exp: (o, lse); ``AttentionFn``
    counts the launch under the kernel it was called as."""
    return attention(q, k, v, causal=causal, window=window, scale=scale,
                     what="flash_attention_gqa", with_lse=True)


def launch_backward(q, k, v, o, lse, do, causal, window, scale):
    """The backward kernel: (dq, dk, dv)."""
    _build.launched("attention_bwd", q.is_meta, bwd_work, q, k, v, window)
    return attention_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                         scale=scale)


class AttentionFn(torch.autograd.Function):
    """``attention`` with its gradient: ``apply(q, k, v, causal, window,
    scale[, kernel]) -> (o, lse)``, lse not differentiable; the launch is
    counted under ``kernel``, ``"flash_attention"`` or the banded route's
    ``"swa_attention"``. Composes with ``loss.backward()``,
    ``torch.func.grad`` and ``torch.func.vmap``; the ``vmap`` rule folds
    the vmapped axis into the batch axis, one launch a call whatever its
    size."""

    @staticmethod
    def forward(q, k, v, causal, window, scale, kernel="flash_attention"):
        _build.launched(kernel, q.is_meta, work, q, k, v, window)
        return launch_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal, window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale = inputs[:6]
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, scale)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = AttentionBwdFn.apply(q, k, v, o, lse, do, *ctx.mask)
        return dq, dk, dv, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale,
             kernel="flash_attention"):
        n = info.batch_size
        q, k, v = (_build.fold(_build.batch_first(x, d, n))
                   for x, d in zip((q, k, v), in_dims[:3]))
        _build.launched(kernel, q.is_meta, work, q, k, v, window)
        o, lse = launch_forward(q, k, v, causal, window, scale)
        return (_build.unfold(o, n), _build.unfold(lse, n)), (0, 0)


class AttentionBwdFn(torch.autograd.Function):
    """The backward kernel as a Function, so that it runs once per call
    under ``torch.func.vmap`` too: ``apply(q, k, v, o, lse, do, causal,
    window, scale) -> (dq, dk, dv)``. It has no gradient of its own."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, window, scale):
        return launch_backward(q.contiguous(), k.contiguous(),
                               v.contiguous(), o.contiguous(),
                               lse.contiguous(), do.contiguous(), causal,
                               window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "attention has no second derivative on the card")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, window, scale):
        n = info.batch_size
        args = [_build.fold(_build.batch_first(x, d, n))
                for x, d in zip((q, k, v, o, lse, do), in_dims[:6])]
        grads = launch_backward(*args, causal, window, scale)
        return tuple(_build.unfold(g, n) for g in grads), (0, 0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Sq, d), k/v (B, Sk, d) -> (B, Sq, d), on the card."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(
            f"flash_attention needs q (B, Sq, d) and k, v (B, Sk, d): got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return attention(q[:, :, None], k[:, :, None], v[:, :, None],
                     causal=causal, window=window, scale=scale)[:, :, 0]


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q (B, Sq, H, d), k (B, Sk, Hkv, d), v (B, Sk, Hkv, dv) ->
    (B, Sq, H, dv), on the card."""
    return attention(q, k, v, causal=causal, window=window, scale=scale,
                     what="flash_attention_gqa")
