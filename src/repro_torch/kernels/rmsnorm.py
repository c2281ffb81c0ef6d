"""The RMS-norm kernel on the card — the counterpart of
``repro.kernels.rmsnorm``.

``rmsnorm`` launches ``csrc/rmsnorm.cu``: ``x (..., D) x scale (D,) ->
(..., D)`` in x's dtype, with the statistics in f32, 16-byte loads and
stores and the row read from device memory once (see the source's
header). ``plan(D, dtype)`` picks the kernel's form: one block a row
with 2 or 4 vectors of 16 bytes a thread, or, for rows longer than
4,096 vectors, one block that reads the row twice. The Pallas version
tiles rows in ``block_rows`` and pads the ragged tail; here every row is
its own block, so there is no padding.

The scale may be grouped: ``scale (g, D)`` norms the i-th of g equal
groups of consecutive rows with ``scale[i]`` (``sqdist_rows`` takes its
grouped references the same way), so m learners' norms under the
learners' vmap are one launch.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream, and
raises on a launch error. ``repro_torch.kernels.ops`` picks it for CUDA
tensors and the plain version for CPU tensors.

The gradient. The JAX package has no backward Pallas kernel, so
``rmsnorm_bwd`` replaces none: ``csrc/rmsnorm_bwd.cu`` computes dx and
the grouped dscale in f32 or bf16 (x, dy and the scale read into f32,
the math and the dscale partials f32, dx and dscale written in the
inputs' dtype once, as the reference's norm computes in f32 and casts;
bf16 rows in 16-byte vectors, read once, as the forward's), with no
atomics (``bwd_plan`` fixes its partition from the shapes and the dtype
alone); rows wider than ``MAX_BWD_D`` raise (``differentiable``).
``RMSNormFn`` is the autograd Function ``ops`` routes a CUDA call
through when a gradient is wanted; its backward calls ``RMSNormBwdFn``;
each has a ``vmap`` rule that folds the vmapped (learner) axis into the
rows with the scale as the group, one launch whatever the axis's size.
They launch through ``launch_forward`` and ``launch_backward``, which
the CPU tests replace with stand-ins.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PER_VECTOR = {torch.float32: 4, torch.bfloat16: 8}   # values in 16 bytes
FORMS = {"block": 0, "stream": 1}
BLOCK_VECTORS = (2, 4)  # vectors a thread keeps, block form
MAX_THREADS = 1024
MAX_D = 65_536          # the wrapper's limit (the stream form has none)
# the backward: threads a block at most, the blocks its partition aims at,
# and its widest row (a block keeps a D-float dscale partial in shared
# memory)
BWD_THREADS = 512
BWD_BLOCKS = 264
MAX_BWD_D = 16_384
BWD_VECTORS = (2, 4)     # bf16: 16-byte vectors a thread takes at most


class Plan(NamedTuple):
    form: str           # "block" or "stream"
    vectors: int        # 16-byte vectors a thread keeps in registers
    threads: int        # threads a block


@functools.lru_cache(maxsize=None)
def plan(D: int, dtype: torch.dtype) -> Plan:
    """The kernel's form for rows of D values of ``dtype``, with n = the
    row's whole 16-byte vectors (8 bf16 or 4 f32 values each): one block
    a row, 2 vectors a thread while 1,024 threads cover it (16,384 bf16
    or 8,192 f32 values), then 4, in as few warps as cover the row (one
    for n <= 64); a longer row goes to 1,024 threads that read it twice.
    Few vectors a thread keep the registers low and the SM full (PERF.md
    §6)."""
    n = D // _PER_VECTOR[dtype]
    for v in BLOCK_VECTORS:
        if n <= MAX_THREADS * v:
            return Plan("block", v, 32 * max(1, -(-n // (32 * v))))
    return Plan("stream", 1, MAX_THREADS)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * scale`` on the card; scale
    (D,), or (g, D) for g equal groups of x's rows. The checks read plain
    ints where they can: at (4, 2048, 1,600) bf16 the kernel takes ~19 µs
    on an H100 and the call's host time is about as long (PERF.md §6)."""
    dev = x.get_device()              # -1 for a CPU or a meta tensor
    if (dev < 0 or scale.get_device() != dev) and not (x.is_meta
                                                       and scale.is_meta):
        raise ValueError(
            f"rmsnorm runs on one CUDA device: x on {x.device}, scale on "
            f"{scale.device}")
    D = x.shape[-1] if x.dim() else 0
    g = scale.shape[0] if scale.dim() == 2 else 1
    rows = x.numel() // D if D else 0
    if (D == 0 or scale.dim() not in (1, 2) or scale.shape[-1] != D
            or rows % g):
        raise ValueError(
            f"rmsnorm needs x (..., D) and scale (D,) or (g, D) with g "
            f"dividing x's rows: got {tuple(x.shape)} and "
            f"{tuple(scale.shape)}")
    dtype = _DTYPES.get(x.dtype)
    if dtype is None or scale.dtype != x.dtype:
        raise TypeError(
            f"rmsnorm takes float32 or bfloat16, x and scale alike: got "
            f"{x.dtype} and {scale.dtype}")
    if dev < 0:                       # meta: the shapes checked
        return torch.empty_like(x)
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm needs contiguous x and scale")
    n = x.numel()
    if D > MAX_D or n == 0:
        raise ValueError(f"rmsnorm takes 1 <= D <= {MAX_D} and a non-empty "
                         f"x: got {tuple(x.shape)}")
    if dev != torch.cuda.current_device():
        raise ValueError(
            f"rmsnorm launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), x is on {x.device}")
    lib = _build.library("rmsnorm")
    y = torch.empty_like(x)
    form, vectors, threads = plan(D, x.dtype)
    code = lib.repro_rmsnorm(dtype, FORMS[form], vectors, threads,
                             x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                             rows, D, rows // g, eps,
                             _build.current_stream(dev))
    _build.check(lib, code, "rmsnorm launch")
    return y


class BwdPlan(NamedTuple):
    threads: int        # threads a block
    chunk_rows: int     # consecutive rows of one group a block takes
    chunks: int         # blocks a group


def bwd_plan(rows: int, D: int, g: int = 1,
             dtype: torch.dtype = torch.float32) -> BwdPlan:
    """The backward's partition, from the shapes and the dtype alone (so
    the same inputs give the same bits on every card): in f32 one thread
    per 4 columns up to ``BWD_THREADS``; in bf16 as few as take the
    row's whole 16-byte vectors (D // 8 of them) 2, then 4 a thread
    (``BWD_VECTORS``), within ``BWD_THREADS``; and chunks
    of rows that make about ``BWD_BLOCKS`` blocks, none across a group's
    edge."""
    if dtype == torch.bfloat16:
        n = D // _PER_VECTOR[dtype]
        v = next((v for v in BWD_VECTORS if n <= BWD_THREADS * v),
                 BWD_VECTORS[-1])
        threads = 32 * max(1, -(-n // (32 * v)))
    else:
        threads = min(BWD_THREADS, 32 * max(1, -(-D // 128)))
    chunk = min(max(1, -(-rows // BWD_BLOCKS)), rows // g)
    return BwdPlan(threads, chunk, -(-(rows // g) // chunk))


def differentiable(x: torch.Tensor, what: str = "rmsnorm") -> None:
    """Raise ``NotImplementedError`` where the backward kernel does not
    take x: rows wider than ``MAX_BWD_D``."""
    if x.shape[-1] > MAX_BWD_D:
        raise NotImplementedError(
            f"{what}'s backward kernel takes D <= {MAX_BWD_D}, got "
            f"{x.shape[-1]}")


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5):
    """The backward kernel: (dx (..., D), dscale shaped as scale) of
    ``rmsnorm(x, scale, eps)`` at the output gradient dy, all f32 or all
    bf16 on the card (the math f32); scale (D,) or grouped (g, D). Two
    CUDA launches (the rows with an f32 dscale partial a block, then each
    group's partials summed in order), no atomics."""
    differentiable(x, "rmsnorm_bwd")
    dev = x.get_device()              # -1 for a CPU or a meta tensor
    if (dev < 0 or scale.get_device() != dev or dy.get_device() != dev) \
            and not (x.is_meta and scale.is_meta and dy.is_meta):
        raise ValueError(
            f"rmsnorm_bwd runs on one CUDA device: x on {x.device}, scale "
            f"on {scale.device}, dy on {dy.device}")
    D = x.shape[-1]
    g = scale.shape[0] if scale.dim() == 2 else 1
    rows = x.numel() // D
    if (dy.shape != x.shape or scale.dim() not in (1, 2)
            or scale.shape[-1] != D or rows % g or rows == 0):
        raise ValueError(
            f"rmsnorm_bwd needs x and dy (..., D) and scale (D,) or (g, D) "
            f"with g dividing the rows: got {tuple(x.shape)}, "
            f"{tuple(dy.shape)}, {tuple(scale.shape)}")
    if dev < 0:                       # meta: the shapes checked
        return torch.empty_like(x), torch.empty_like(scale)
    dtype = _DTYPES.get(x.dtype)
    if dtype is None or scale.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(f"rmsnorm_bwd takes float32 or bfloat16, x, scale "
                        f"and dy alike: got {x.dtype}, {scale.dtype}, "
                        f"{dy.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()
            and dy.is_contiguous()):
        raise ValueError("rmsnorm_bwd needs contiguous x, scale and dy")
    if dev != torch.cuda.current_device():
        raise ValueError(
            f"rmsnorm_bwd launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), x is on {x.device}")
    threads, chunk, chunks = bwd_plan(rows, D, g, x.dtype)
    lib = _build.library("rmsnorm")
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    partial = x.new_empty((g * chunks, D), dtype=torch.float32)
    code = lib.repro_rmsnorm_bwd(
        dtype, x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), partial.data_ptr(), rows, D, rows // g, chunk,
        threads, eps, _build.current_stream(dev))
    _build.check(lib, code, "rmsnorm_bwd launch")
    return dx, dscale


def launch_forward(x, scale, eps):
    """The forward kernel (scale (D,) or grouped (g, D))."""
    _build.launched("rmsnorm", x.is_meta, work, x)
    return rmsnorm(x, scale, eps)


def work(x) -> tuple:
    """``kernel_work``'s (name, shape, dtype) of the forward."""
    return "rmsnorm", x.shape, x.dtype


def bwd_work(x, scale) -> tuple:
    """``kernel_work``'s (name, shape, dtype) of the backward; the
    shape (rows, D, g)."""
    D = x.shape[-1]
    return "rmsnorm_bwd", (x.numel() // D, D, scale.shape[0]
                           if scale.dim() == 2 else 1), x.dtype


def launch_backward(x, scale, dy, eps):
    """The backward kernel: (dx, dscale)."""
    _build.launched("rmsnorm_bwd", x.is_meta, bwd_work, x, scale)
    return rmsnorm_bwd(x, scale, dy, eps)


class RMSNormFn(torch.autograd.Function):
    """``rmsnorm`` with its gradient: ``apply(x, scale, eps) -> y`` for x
    (..., D) and scale (D,). Composes with ``loss.backward()``,
    ``torch.func.grad`` and ``torch.func.vmap``; the ``vmap`` rule norms
    the n vmapped rows-sets as one grouped launch, scale (n, D) (or the
    shared (D,) scale where only x is vmapped)."""

    @staticmethod
    def forward(x, scale, eps):
        return launch_forward(x.contiguous(), scale.contiguous(), eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, eps = inputs
        ctx.save_for_backward(x, scale)
        ctx.eps = eps

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = RMSNormBwdFn.apply(x, scale, dy, ctx.eps)
        return dx, dscale, None

    @staticmethod
    def vmap(info, in_dims, x, scale, eps):
        n = info.batch_size
        x = _build.batch_first(x, in_dims[0], n)
        if in_dims[1] is not None:
            scale = scale.movedim(in_dims[1], 0).contiguous()
        return launch_forward(x, scale.contiguous(), eps), 0


class RMSNormBwdFn(torch.autograd.Function):
    """The backward kernel as a Function, so that it runs once per call
    under ``torch.func.vmap`` too: ``apply(x, scale, dy, eps) -> (dx,
    dscale)``. It has no gradient of its own."""

    @staticmethod
    def forward(x, scale, dy, eps):
        return launch_backward(x.contiguous(), scale.contiguous(),
                               dy.contiguous(), eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "rmsnorm has no second derivative on the card")

    @staticmethod
    def vmap(info, in_dims, x, scale, dy, eps):
        n = info.batch_size
        x = _build.batch_first(x, in_dims[0], n)
        dy = _build.batch_first(dy, in_dims[2], n)
        # a dscale per vmapped entry: the scale as n groups even where it
        # is shared
        scale = _build.batch_first(scale, in_dims[1], n)
        return launch_backward(x, scale, dy, eps), (0, 0)
