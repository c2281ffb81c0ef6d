"""The attention kernel on the card — the counterpart of
``repro.kernels.flash_attention`` and of the GQA front end
``repro.kernels.ops.flash_attention_gqa``.

Both launch one of two programs of the ``attention`` library, chosen
by dtype (``PROGRAMS``): bf16 runs ``csrc/attention_sm90.cu`` (TMA-fed
``wgmma`` on the tensor cores, p split into two bf16 terms so the
result keeps the bf16 tolerance), f32 runs ``csrc/attention.cu`` (f32
FMAs on the CUDA cores: the tensor cores take f32 only as TF32). A dtype
or head dim that neither takes raises. Both compute online-softmax
attention with the causal diagonal right-aligned (query row i at
position ``i + Sk - Sq``), an optional sliding ``window`` and ``scale``,
f32 statistics and accumulator, output in q's dtype. Both read the GQA
layout ``q (B, Sq, H, d)``, ``k/v (B, Sk, Hkv, d)`` in place: query head
h reads kv head ``h // (H // Hkv)``, so nothing is transposed or
repeated (the reference folds ``(B, Hkv, G)`` into its batch axis and
repeats k and v). ``flash_attention`` on ``(B, S, d)`` is the case H = Hkv = 1. Key
positions ``>= Sk`` are masked in the kernel, so a ragged non-causal
``Sk`` is right, unlike the Pallas kernel (ROADMAP C1).

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, allocate the output, launch on the current stream, and raise
on a launch error. ``repro_torch.kernels.ops`` picks them for CUDA
tensors and the plain versions for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# dtype -> (the program's name, its C entry point)
PROGRAMS = {torch.bfloat16: ("sm90_wgmma_tma", "repro_attention_sm90"),
            torch.float32: ("cuda_core_f32", "repro_attention")}
HEAD_DIMS = (32, 64, 128)
_MAX_BH = 65535        # the f32 program's grid.y; bf16's grid is 1-D


def program(dtype: torch.dtype) -> str:
    """The name of the program that runs attention in ``dtype``."""
    return PROGRAMS[dtype][0]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int, scale: float | None,
              what: str = "flash_attention") -> torch.Tensor:
    """Launch the kernel on the GQA layout: q (B, Sq, H, d), k/v
    (B, Sk, Hkv, d) -> (B, Sq, H, d)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"{what} runs on one CUDA device: q on {q.device}, k on "
            f"{k.device}, v on {v.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"{what} needs q (B, Sq, H, d) and k, v (B, Sk, Hkv, d): got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d or Hkv < 1 or H % Hkv:
        raise ValueError(
            f"{what}: k, v {tuple(k.shape)} do not match q {tuple(q.shape)} "
            f"(same batch and head dim, H a multiple of Hkv)")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what} takes head dims {HEAD_DIMS}, got {d}")
    if q.dtype not in PROGRAMS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{what} takes float32 or bfloat16, q, k and v alike: got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what} needs contiguous q, k and v")
    if min(B, Sq, Sk) < 1 or window < 0:
        raise ValueError(
            f"{what}: empty input or a negative window: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, window {window}")
    if q.dtype == torch.float32 and B * H > _MAX_BH:
        raise ValueError(
            f"{what}: the f32 program takes at most {_MAX_BH} (batch, head) "
            f"pairs, got {B * H}")
    # TMA reads the bf16 tensors from 16-byte aligned addresses
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what} needs 16-byte aligned q, k and v")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{what} launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), q is on {q.device}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    lib = _build.library("attention")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    name, entry = PROGRAMS[q.dtype]
    code = getattr(lib, entry)(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Hkv,
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
    """q (B, Sq, H, d), k/v (B, Sk, Hkv, d) -> (B, Sq, H, d), on the
    card."""
    return attention(q, k, v, causal=causal, window=window, scale=scale,
                     what="flash_attention_gqa")
