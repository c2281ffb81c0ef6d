"""The chunked SSD scan on the card — the counterpart of
``repro.kernels.ssd_scan``.

``ssd_scan`` launches ``csrc/ssd_scan.cu``: x (BH, S, P), dt (BH, S),
a (BH,) and b, c (BH / R, S, N) -> y (BH, S, P) in x's dtype and the
final state h (BH, P, N) in f32, the chunked form of
``ref.ssd_scan_ref``'s recurrence. Head bh reads row ``bh // R`` of b
and c, R = BH / b.shape[0]: with H heads in G groups per batch,
R = H / G, so Mamba2's shared B and C are read in place where the
reference repeats them per head; b and c per head (R = 1) is the
reference's layout. Like the Pallas kernel it needs S to be a chunk
multiple (``repro_torch.kernels.ops.ssd_scan`` pads) and raises the
reference's ``ValueError`` otherwise.

The program is three launches on the current stream (see the source's
header): C B^T once per (group row, chunk), shared by the row's R heads,
with B^T split into the images the next pass reads; an ordered walk
over the chunks per (head, 64 state columns) that writes the state
entering each chunk; then every chunk's outputs in parallel. All
products run on the tensor cores (``wgmma`` in the last two passes,
``mma.sync`` in the first) in split TF32: each operand is hi + lo and
each product three TF32 products, which keeps f32 accuracy where one
TF32 product does not (``tests/test_torch_ssd_passes.py``). Its bound is
the function's bytes (x, dt, b, c read once, y and h written once); the
entering-state scratch is the design's own traffic on top.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the outputs and the scratch (C B^T, (BH / R, S / Q,
Q, Q) f32; the split B^T images, ``repro_ssd_scan_bt_bytes`` per row and
chunk; entering states, (BH, S / Q, P, N) f32), launches, and raises on
a launch error. ``repro_torch.kernels.ops``
picks it for CUDA tensors and the plain version for CPU tensors.

The gradient. The JAX package has no backward Pallas kernel (its
training differentiates the jnp SSD), so ``ssd_scan_bwd`` replaces none:
``csrc/ssd_scan_bwd.cu`` computes (dx, ddt, da, db, dc) in f32 on the
tensor cores, every product split TF32 on ``mma.sync`` (three TF32
products a product, each over at most 64 K values summed from zero and
added in f32), as an SSD run in reverse time: C B^T and the chunks'
decays once per (row of b and c, chunk); an ordered walk over the
chunks from the last that writes the gradient of the state leaving each
chunk, its rows split across blocks and its column tile sized to N
(``bwd_plan``); then every chunk in parallel from it and the state
entering the chunk, which the forward keeps when asked
(``keep_states``), the columns of N in slabs; db and dc
of the R heads that share a row of b and c, and da over the chunks, are
summed in a fixed order by further launches, no atomics (see the
source's header). ``SSDScanFn`` is the autograd Function that ``ops``
routes a CUDA call through when a gradient is wanted (an input requires
grad, or is a ``torch.func`` transform's tensor): its backward calls
``SSDScanBwdFn``, and each has a ``vmap`` rule that folds the vmapped
(learner) axis into BH and into b and c's rows, so m learners are one
launch. They launch through the module's ``launch_forward`` and
``launch_backward``, which the CPU tests replace with stand-ins. The
final state's gradient may be absent (the LM loss never reads it) and
counts as zero.

bf16 under a gradient takes a stated route, not a kernel of its own: the
forward is the bf16 forward kernel it runs without a gradient (its
entering states are f32), and ``SSDScanBwdFn`` casts x, dt, b, c, dy
and dh to f32, runs the f32 ``ssd_scan_bwd.cu`` (``launch_backward``),
and casts each gradient to its input's dtype (``backward_f32``). No
model reaches it: the SSM layers (``models/mamba.py``, as the
reference's ``models/mamba.py``) cast x, dt, B and C to f32 before
``ops.ssd_scan``, so a bf16 mamba2 or hymba step already runs the f32
backward; only a direct bf16 ``ops.ssd_scan`` call under a gradient
takes this route (ROADMAP A28).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (8, 16, 32, 64)
MAX_P, MAX_N = 64, 128
# the program, and the CUDA launches one call makes (C B^T, the state
# walk, the outputs); ops.LAUNCHES counts the call once
PROGRAM = "sm90_wgmma_tf32x3"
CUDA_LAUNCHES = 3
# the backward's program: split TF32 on mma.sync m16n8k8
BWD_PROGRAM = "sm90_mma_tf32x3"
# the walk's warps a block, widest first (each warp 16 rows of the state)
WALK_WARPS = (4, 2, 1)
# the walk's ring of chunk tiles: at most this deep, and within the shared
# memory of one of two blocks an SM
WALK_MAX_STAGES, WALK_SMEM = 8, 113 * 1024


class BwdPlan(NamedTuple):
    walk_cols: int      # the reverse walk's column tile: 8, 16, 32 or 64
    walk_warps: int     # the walk's warps a block: 4, 2 or 1
    walk_stages: int    # the walk's ring of chunk tiles: 2 to 8
    slab: int           # the chunk pass's column slab: 16, 32 or 64


def walk_stage_bytes(chunk: int, cols: int, warps: int) -> int:
    """Bytes of one stage of the walk's ring: C (chunk x cols, rows of
    cols + 8 floats), dY (chunk x 16 warps), the decays."""
    return 4 * (chunk * (max(cols + 8, 24) + 16 * warps + 8) + chunk + 4)


def bwd_plan(BH: int, P: int, N: int, chunk: int, sms: int) -> BwdPlan:
    """The backward's partition. The column tile of the walk and the
    slab of the chunk pass are N rounded up to a tile the kernel is built
    for (no padded column at N = 16), capped at 64. The walk's block is
    the most warps (each 16 rows of one head's state, sharing one staged
    tile of C) that still give each of ``sms`` SMs a block; its ring is as
    deep as two blocks' shared memory an SM allows. The column tile and
    the slab fix orders of sums and depend on N alone: the walk's split
    does not change any row's arithmetic, so the bits do not depend on
    BH or the card."""
    cols = next(c for c in (8, 16, 32, 64) if min(N, 64) <= c)
    tiles, ncol = -(-P // 16), -(-N // cols)
    warps = next((w for w in WALK_WARPS[:-1]
                  if w <= tiles and BH * ncol * -(-tiles // w) >= sms), 1)
    stages = WALK_SMEM // walk_stage_bytes(chunk, cols, warps)
    return BwdPlan(cols, warps, max(2, min(WALK_MAX_STAGES, stages)),
                   max(16, cols))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 64,
             keep_states: bool = False):
    """The chunked SSD on the card -> (y (BH, S, P), h (BH, P, N) f32);
    with ``keep_states`` also the states entering each chunk, (BH,
    S / chunk, P, N) f32, which the backward reads."""
    if x.dim() != 3:
        raise ValueError(f"ssd_scan needs x (BH, S, P): got {tuple(x.shape)}")
    BH, S, P = x.shape
    rows, N = (b.shape[0], b.shape[-1]) if b.dim() == 3 else (0, 0)
    if (dt.shape != (BH, S) or a.shape != (BH,) or rows < 1 or BH % rows
            or b.shape != (rows, S, N) or c.shape != b.shape):
        raise ValueError(
            f"ssd_scan needs x (BH, S, P), dt (BH, S), a (BH,) and b, c "
            f"(BH / R, S, N) with R heads per row: got {tuple(x.shape)}, "
            f"{tuple(dt.shape)}, {tuple(a.shape)}, {tuple(b.shape)}, "
            f"{tuple(c.shape)}")
    R = BH // rows
    if chunk < 1 or S % chunk != 0:          # ssd_scan.py:81-84
        raise ValueError(
            f"sequence length must be a chunk multiple (callers pad): "
            f"S={S}, chunk={chunk}")
    if chunk not in CHUNKS:
        raise ValueError(f"ssd_scan takes chunks {CHUNKS}, got {chunk}")
    if not (0 < P <= MAX_P and 0 < N <= MAX_N and S > 0):
        raise ValueError(
            f"ssd_scan takes 1 <= P <= {MAX_P}, 1 <= N <= {MAX_N} and "
            f"S > 0: got P={P}, N={N}, S={S}")
    tensors = (x, dt, a, b, c)
    meta = x.is_meta
    if not all((t.is_cuda or meta) and t.device == x.device
               for t in tensors):
        raise ValueError(
            f"ssd_scan runs on one CUDA device: got "
            f"{[str(t.device) for t in tensors]}")
    if meta:
        f32 = dict(dtype=torch.float32, device=x.device)
        out = (torch.empty_like(x), torch.empty((BH, P, N), **f32))
        return out + (torch.empty((BH, S // chunk, P, N), **f32),) \
            if keep_states else out
    if (x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, b, c))
            or a.dtype != torch.float32):
        raise TypeError(
            f"ssd_scan takes x, dt, b and c in float32 or bfloat16 alike and "
            f"a in float32: got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan needs contiguous x, dt, a, b and c")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"ssd_scan launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), x is on {x.device}")
    lib = _build.library("ssd_scan")
    nc = S // chunk
    y = torch.empty_like(x)
    h = torch.empty((BH, P, N), dtype=torch.float32, device=x.device)
    cbt = torch.empty((rows, nc, chunk, chunk), dtype=torch.float32,
                      device=x.device)
    bt = torch.empty((rows, nc, lib.repro_ssd_scan_bt_bytes(chunk)),
                     dtype=torch.uint8, device=x.device)
    states = torch.empty((BH, nc, P, N), dtype=torch.float32,
                         device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.repro_ssd_scan(
        _DTYPES[x.dtype], chunk, x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        b.data_ptr(), c.data_ptr(), y.data_ptr(), h.data_ptr(),
        cbt.data_ptr(), bt.data_ptr(), states.data_ptr(), BH, S, P, N, R,
        stream)
    _build.check(lib, code, "ssd_scan launch")
    return (y, h, states) if keep_states else (y, h)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, states: torch.Tensor,
                 dy: torch.Tensor, dh: torch.Tensor | None, *, chunk: int):
    """The backward kernel: (dx, ddt, da, db, dc) of ``ssd_scan`` at the
    forward's inputs, its entering states (``keep_states``), the output's
    gradient dy (BH, S, P) and the final state's dh (BH, P, N) or None
    (zero), all f32 on the card. Four CUDA launches (C B^T once per row
    and chunk, the reverse state walk, the chunks, da's chunk sum) and,
    where R > 1, a fifth that sums the R heads' db and dc partials of each
    row in head order; no atomics: the same inputs give the same bits."""
    BH, S, P = x.shape
    rows, N = b.shape[0], b.shape[-1]
    nc = S // chunk if chunk in CHUNKS else 0
    tensors = (x, dt, a, b, c, states, dy) + (() if dh is None else (dh,))
    if (dt.shape != (BH, S) or a.shape != (BH,) or b.dim() != 3
            or rows < 1 or BH % rows or b.shape != (rows, S, N)
            or c.shape != b.shape or dy.shape != x.shape
            or states.shape != (BH, nc, P, N)
            or (dh is not None and dh.shape != (BH, P, N))):
        raise ValueError(
            f"ssd_scan_bwd needs x, dy (BH, S, P), dt (BH, S), a (BH,), b, "
            f"c (BH / R, S, N), states (BH, S / chunk, P, N) and dh (BH, P, "
            f"N) or None: got {[tuple(t.shape) for t in tensors]}")
    if chunk not in CHUNKS or S % chunk or S < chunk:
        raise ValueError(f"ssd_scan_bwd takes chunks {CHUNKS} dividing S: "
                         f"S={S}, chunk={chunk}")
    if not (0 < P <= MAX_P and 0 < N <= MAX_N):
        raise ValueError(f"ssd_scan_bwd takes 1 <= P <= {MAX_P}, 1 <= N <= "
                         f"{MAX_N}: got P={P}, N={N}")
    meta = x.is_meta
    if not all((t.is_cuda or meta) and t.device == x.device
               for t in tensors):
        raise ValueError(
            f"ssd_scan_bwd runs on one CUDA device: got "
            f"{[str(t.device) for t in tensors]}")
    if meta:
        return tuple(torch.empty_like(t) for t in (x, dt, a, b, c))
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"ssd_scan_bwd takes float32: got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan_bwd needs contiguous inputs")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"ssd_scan_bwd launches on the current device "
            f"(cuda:{torch.cuda.current_device()}), x is on {x.device}")
    R = BH // rows
    lib = _build.library("ssd_scan_bwd")
    plan = bwd_plan(BH, P, N, chunk, torch.cuda.get_device_properties(
        x.device.index).multi_processor_count)
    dx, ddt, da, db, dc = (torch.empty_like(t) for t in (x, dt, a, b, c))
    gstates = torch.empty_like(states)
    cbt = x.new_empty((rows, nc, chunk, chunk))
    dec = x.new_empty((BH, nc, chunk + 4))
    part = x.new_empty((2, BH, S, N)) if R > 1 else None
    dapart = x.new_empty((BH, nc))
    code = lib.repro_ssd_scan_bwd(
        chunk, x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), states.data_ptr(), dy.data_ptr(),
        None if dh is None else dh.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
        gstates.data_ptr(), cbt.data_ptr(), dec.data_ptr(),
        None if part is None else part[0].data_ptr(),
        None if part is None else part[1].data_ptr(), dapart.data_ptr(),
        BH, S, P, N, R, *plan, _build.current_stream(x.device.index))
    _build.check(lib, code, "ssd_scan_bwd launch")
    return dx, ddt, da, db, dc


def work(x, b, chunk: int, name: str = "ssd_scan") -> tuple:
    """``kernel_work``'s (name, shape, dtype) of one call of ``name``;
    the shape (BH, S, P, N, chunk, R)."""
    BH, S, P = x.shape
    return name, (BH, S, P, b.shape[-1], chunk, BH // b.shape[0]), x.dtype


def launch_forward(x, dt, a, b, c, chunk):
    """The forward kernel with the entering states: (y, h, states)."""
    _build.launched("ssd_scan", x.is_meta, work, x, b, chunk)
    return ssd_scan(x, dt, a, b, c, chunk=chunk, keep_states=True)


def launch_backward(x, dt, a, b, c, states, dy, dh, chunk):
    """The backward kernel: (dx, ddt, da, db, dc)."""
    _build.launched("ssd_scan_bwd", x.is_meta, work, x, b, chunk,
                    "ssd_scan_bwd")
    return ssd_scan_bwd(x, dt, a, b, c, states, dy, dh, chunk=chunk)


def backward_f32(x, dt, a, b, c, states, dy, dh, chunk):
    """``launch_backward``, which is f32, at any input dtype: a bf16
    call's inputs reach it upcast and its gradients come back cast to
    each input's dtype (the module's docstring); an f32 call's pass as
    they are."""
    dtypes = [t.dtype for t in (x, dt, a, b, c)]
    grads = launch_backward(*(None if t is None else t.float() for t in (
        x, dt, a, b, c, states, dy, dh)), chunk)
    return tuple(g.to(t) for g, t in zip(grads, dtypes))


class SSDScanFn(torch.autograd.Function):
    """``ssd_scan`` with its gradient: ``apply(x, dt, a, b, c, chunk) ->
    (y, h, states)``, states not differentiable. Composes with
    ``loss.backward()``, ``torch.func.grad`` and ``torch.func.vmap``; the
    ``vmap`` rule folds the vmapped axis into BH and into b and c's rows
    (R is unchanged), one launch a call whatever its size."""

    @staticmethod
    def forward(x, dt, a, b, c, chunk):
        return launch_forward(x.contiguous(), dt.contiguous(), a.contiguous(),
                              b.contiguous(), c.contiguous(), chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, a, b, c, chunk = inputs
        ctx.mark_non_differentiable(output[2])
        ctx.save_for_backward(x, dt, a, b, c, output[2])
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dy, dh, _dstates):
        x, dt, a, b, c, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = SSDScanBwdFn.apply(x, dt, a, b, c, states, dy, dh, ctx.chunk)
        return (*grads, None)

    @staticmethod
    def vmap(info, in_dims, x, dt, a, b, c, chunk):
        n = info.batch_size
        args = [_build.fold(_build.batch_first(t, d, n))
                for t, d in zip((x, dt, a, b, c), in_dims[:5])]
        out = launch_forward(*args, chunk)
        return tuple(_build.unfold(t, n) for t in out), (0, 0, 0)


class SSDScanBwdFn(torch.autograd.Function):
    """The backward kernel as a Function, so that it runs once per call
    under ``torch.func.vmap`` too: ``apply(x, dt, a, b, c, states, dy, dh,
    chunk) -> (dx, ddt, da, db, dc)``, dh None for zero. It has no
    gradient of its own."""

    @staticmethod
    def forward(x, dt, a, b, c, states, dy, dh, chunk):
        return backward_f32(
            x.contiguous(), dt.contiguous(), a.contiguous(), b.contiguous(),
            c.contiguous(), states.contiguous(), dy.contiguous(),
            None if dh is None else dh.contiguous(), chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "ssd_scan has no second derivative on the card")

    @staticmethod
    def vmap(info, in_dims, x, dt, a, b, c, states, dy, dh, chunk):
        n = info.batch_size
        args = [None if t is None else _build.fold(_build.batch_first(t, d, n))
                for t, d in zip((x, dt, a, b, c, states, dy, dh),
                                in_dims[:8])]
        grads = backward_f32(*args, chunk)
        return tuple(_build.unfold(g, n) for g in grads), (0,) * 5
