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


def program(dtype: torch.dtype) -> str:
    """The name of the program that runs attention in ``dtype``."""
    return PROGRAMS[dtype][0]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int, scale: float | None,
              what: str = "flash_attention") -> torch.Tensor:
    """Launch the kernel on the GQA layout: q (B, Sq, H, d), k
    (B, Sk, Hkv, d), v (B, Sk, Hkv, dv) -> (B, Sq, H, dv)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
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
    lib = _build.library("attention")
    o = q.new_empty((B, Sq, H, dv))
    stream = _build.current_stream(q.device.index)
    name, entry = PROGRAMS[q.dtype]
    code = getattr(lib, entry)(
        d, dv, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Hkv,
        Sq, Sk, int(causal), int(window), ctypes.c_float(scale), stream)
    _build.check(lib, code, f"{what} launch ({name})")
    return o


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
