"""Roofline model of a run on the card — the counterpart of
``repro.analysis.roofline``.

    compute term    = FLOPs / peak FLOP/s
    memory term     = bytes / device-memory bytes/s
    collective term = bytes the fleet's collectives move / link bytes/s

The reference costs a compiled XLA executable. The port runs eagerly, so
``analyze(name, fn, *args)`` RUNS ``fn`` once and observes it: the FLOPs
from ``torch.utils.flop_counter.FlopCounterMode`` (products and
convolutions, with a convolution's backward counted per group; the
elementwise work is not counted), the bytes from a dispatch mode that sums each
operator's tensor inputs and outputs (eager traffic: every intermediate
makes a round trip to memory, so this is an upper bound on what fused
kernels would move), and the collective bytes from the counters of
``repro_torch.core.shard`` (what this rank received in its gathers and
broadcasts). ``kernel_bound(name, shape)`` is the least time of each of
the port's kernels at a shape: the larger of its bytes (each input read
once, each output written once) over the memory rate and its operations
over the peak rate of their type — the ``bound_ms`` of ``chip_smoke.py``
and PERF.md §6.

``PEAKS`` holds the datasheet peaks (dense) of the cards the port runs
on; ``H100`` is the H100 SXM5, which ``nvidia-smi`` names "NVIDIA H100
80GB HBM3" at a 700 W power limit. A card set below 700 W runs slower
under load, so a measured time is compared with these peaks only beside
the card's name and power limit.

``WorkMode.flops`` is the first-order FLOP count of ``telemetry.costs``:
the products by ``FlopCounterMode``'s formulas (the grouped convolution's
backward corrected), reductions at one FLOP per input element and other
arithmetic at one per output element, views, copies and indexing free —
the rule of the reference's ``jaxpr_flops``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import (
    FlopCounterMode, conv_flop_count, flop_registry, shape_wrapper,
)


class Peaks(NamedTuple):
    """One card's datasheet peaks (dense)."""
    hbm: float        # device-memory bytes/s
    f32: float        # f32 FLOP/s outside the tensor cores
    bf16: float       # bf16 tensor-core FLOP/s
    tf32: float       # TF32 tensor-core FLOP/s
    link: float       # NVLink bytes/s, one direction


# NVIDIA data sheets. H100 = H100 SXM5 ("NVIDIA H100 80GB HBM3, 700 W"):
# bf16 989 TFLOP/s, TF32 495, f32 67, HBM3 3.35 TB/s, NVLink 4 450 GB/s
# each way
PEAKS: Dict[str, Peaks] = {
    "H100 PCIe": Peaks(2.0e12, 51e12, 756e12, 378e12, 300e9),
    "H100 NVL": Peaks(3.9e12, 60e12, 835e12, 418e12, 300e9),
    "H100": Peaks(3.35e12, 67e12, 989e12, 495e12, 450e9),
    "H200": Peaks(4.8e12, 67e12, 989e12, 495e12, 450e9),
}
H100 = PEAKS["H100"]


def peaks(name: str = "H100") -> Peaks:
    """The peaks of the card whose name (``torch.cuda.get_device_name``)
    holds every word of a ``PEAKS`` key, the longest key first."""
    for key in sorted(PEAKS, key=len, reverse=True):
        if all(part in name for part in key.split()):
            return PEAKS[key]
    raise ValueError(f"no published peaks for {name!r}")


@dataclass
class RooflineReport:
    name: str
    num_devices: int
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None          # 6*N*D (total, all chips)
    useful_fraction: Optional[float] = None      # model / (counted * chips)
    collectives: dict = field(default_factory=dict)
    memory_stats: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in (
            "name", "num_devices", "flops_per_chip", "bytes_per_chip",
            "wire_bytes_per_chip", "compute_s", "memory_s", "collective_s",
            "bottleneck", "model_flops", "useful_fraction", "collectives",
            "memory_stats")}


def model_flops_for(cfg, shape, mode: str) -> float:
    """6·N·D rule. Train counts fwd+bwd (6ND); prefill 2ND; decode 2N·B.
    N is ``cfg.active_param_count()``: for a mixture of experts the
    weights a token touches (the routed top-k and the shared experts),
    as the reference counts it."""
    n = cfg.active_param_count()
    if mode in ("train", "train_dynamic", "train_periodic"):
        return 6.0 * n * shape.global_batch * shape.seq_len
    if mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# observed work: bytes and first-order FLOPs of the operators a call runs
# ---------------------------------------------------------------------------

def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         _groups, output_mask, out_shape=None, **kwargs):
    """A convolution's backward: the input gradient and the weight
    gradient each cost what the forward costs. ``FlopCounterMode``'s own
    formula counts the weight gradient as a dense convolution over every
    channel, ignoring ``groups``: for the learners' vmapped convolution
    (one group per learner) that is m times too many."""
    fwd = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


# the products' formulas, the grouped convolution's backward corrected
FLOP_FORMULAS = {**flop_registry, torch.ops.aten.convolution_backward:
                 shape_wrapper(_conv_backward_flops)}

# operators that only view, move, make or index values: no arithmetic
_FREE = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "select", "slice", "as_strided", "alias",
    "detach", "clone", "copy_", "_to_copy", "contiguous", "cat", "stack",
    "index", "index_select", "gather", "index_put", "index_put_",
    "scatter", "masked_select", "nonzero", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "zeros", "zeros_like",
    "ones", "ones_like", "full", "full_like", "fill_", "zero_", "arange",
    "lift_fresh", "lift_fresh_copy", "scalar_tensor", "_local_scalar_dense",
    "split", "split_with_sizes", "unbind", "flip", "roll", "repeat",
    "constant_pad_nd", "resize_", "set_", "diagonal", "narrow",
    "_pin_memory", "pin_memory", "is_pinned",
    "split_with_sizes_copy", "unsqueeze_copy", "view_copy", "_reshape_alias",
})

_REDUCE = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "cumsum", "cumprod", "var", "std", "var_mean", "std_mean",
    "linalg_vector_norm", "norm", "logsumexp", "any", "all", "sort",
    "topk", "median", "kthvalue",
})


def _name(func) -> str:
    return str(func.overloadpacket).split(".")[-1]


def _tensors(x):
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


class WorkMode(TorchDispatchMode):
    """Sums the bytes each operator reads and writes (its tensor inputs
    and outputs, views excluded) and its first-order FLOPs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = _name(func)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if name not in _FREE:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        packet = func.overloadpacket
        if packet in FLOP_FORMULAS:
            self.flops += FLOP_FORMULAS[packet](*args, **kwargs,
                                                out_val=out)
        elif name in _REDUCE:
            self.flops += sum(t.numel() for t in ins[:1])
        elif name not in _FREE:
            self.flops += sum(t.numel() for t in outs)
        return out


def observers():
    """The FLOP counter and the work mode ``analyze`` observes a call
    with (enter both): products by ``FLOP_FORMULAS``, bytes and
    first-order FLOPs by ``WorkMode``. The launcher's dry run counts its
    programs on ``meta`` with the same two."""
    return (FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops}),
        WorkMode())


def analyze(name: str, fn, *args, num_devices: int = 1,
            model_flops: Optional[float] = None,
            card: Optional[Peaks] = None, peak_flops: Optional[float] = None,
            **kwargs) -> RooflineReport:
    """Run ``fn(*args, **kwargs)`` once and place it on the roofline of
    ``card`` (default: the card it ran on, else the H100). ``peak_flops``
    defaults to the card's f32 rate outside the tensor cores, the
    port's training arithmetic (f32, TF32 off)."""
    from repro_torch.core import shard
    if card is None:
        card = (peaks(torch.cuda.get_device_name(0))
                if torch.cuda.is_available() else H100)
    peak = card.f32 if peak_flops is None else peak_flops
    wire0 = dict(shard.COLLECTIVE_BYTES)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    counter, work = observers()
    with counter, work:
        fn(*args, **kwargs)
    mem = {}
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        mem = {"peak_bytes": int(torch.cuda.max_memory_allocated() - base)}
    flops = float(counter.get_total_flops())
    coll = {k: v - wire0.get(k, 0) for k, v in shard.COLLECTIVE_BYTES.items()
            if v - wire0.get(k, 0)}
    wire = float(sum(coll.values()))
    terms = {"compute": flops / peak, "memory": work.bytes / card.hbm,
             "collective": wire / card.link}
    useful = (model_flops / (flops * num_devices)
              if model_flops and flops else None)
    return RooflineReport(
        name=name, num_devices=num_devices, flops_per_chip=flops,
        bytes_per_chip=float(work.bytes), wire_bytes_per_chip=wire,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"],
        bottleneck=max(terms, key=terms.get), model_flops=model_flops,
        useful_fraction=useful, collectives=coll, memory_stats=mem)


def format_table(reports) -> str:
    hdr = (f"{'program':44s} {'chips':>5s} {'compute_s':>10s} "
           f"{'memory_s':>10s} {'coll_s':>10s} {'bneck':>10s} "
           f"{'useful':>7s} {'peak_GB':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in reports:
        peak = r.memory_stats.get("peak_bytes", 0) / 1e9
        uf = f"{r.useful_fraction:.3f}" if r.useful_fraction else "-"
        lines.append(
            f"{r.name:44s} {r.num_devices:5d} {r.compute_s:10.3e} "
            f"{r.memory_s:10.3e} {r.collective_s:10.3e} {r.bottleneck:>10s} "
            f"{uf:>7s} {peak:8.2f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the kernels' bounds
# ---------------------------------------------------------------------------

def attention_work(B, Sq, Sk, H, Hkv, d, causal, window, itemsize,
                   dv=None):
    """(bytes, flops) the attention function needs at these shapes: q, k,
    v read once and o written once; 2 (d + dv) flops per kept query-key
    pair and head (q.k over d, p.v over dv), counting the pairs this mask
    keeps. ``dv`` is the value width, d's unless given (MLA's queries and
    keys are wider than its values)."""
    dv = d if dv is None else dv
    pos = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(pos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(Sq)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    nbytes = (B * Sq * H * (d + dv) + B * Sk * Hkv * (d + dv)) * itemsize
    return nbytes, 2 * (d + dv) * pairs * B * H


def ssd_work(BH, S, P, N, bc_rows, chunk, itemsize):
    """(bytes, flops) of the SSD at these shapes: x, dt, b, c read once
    (b and c as the kernel reads them, ``bc_rows`` rows), a read, y and
    the f32 state written once; the flops are the fewer of the two forms
    that compute it. The chunked form needs, per chunk of Q steps, the
    causal triangle of C B^T once per row of b and c (the row's heads
    share it), Q (Q + 1) N, and per head the triangle of the diagonal
    product, Q (Q + 1) P, then 2 Q N P for C h^T and 2 Q P N for the
    state update; the sequential recurrence needs 5 P N per step (decay,
    the dt x b^T outer product and its add, then C h)."""
    nbytes = ((2 * BH * S * P + BH * S + 2 * bc_rows * S * N) * itemsize
              + 4 * BH + 4 * BH * P * N)
    nc = S // chunk
    chunked = (bc_rows * chunk * (chunk + 1) * N
               + BH * (chunk * (chunk + 1) * P + 4 * chunk * N * P)) * nc
    return nbytes, min(chunked, 5 * P * N * S * BH)


def ssd_bwd_work(BH, S, P, N, bc_rows, chunk, itemsize):
    """(bytes, flops) of the SSD's gradient at these shapes: x, dt, b, c
    and dy read once, dx, ddt, db, dc and da written once (and a read);
    the flops of the chunked form, per chunk of Q steps: the causal
    triangle of C B^T once per row of b and c, Q (Q + 1) N; per head the
    triangles of dY U^T and of the du, dc and db products, 2 Q (Q + 1)
    (P + N), and four full (Q, P, N) products, 8 Q P N (H_c^T dy,
    G_c b, G_c^T u, and the reverse walk's dy c^T)."""
    nbytes = ((3 * BH * S * P + 2 * BH * S + 4 * bc_rows * S * N)
              * itemsize + 8 * BH)
    Q = chunk
    flops = (bc_rows * Q * (Q + 1) * N
             + BH * (2 * Q * (Q + 1) * (P + N) + 8 * Q * P * N)) * (S // Q)
    return nbytes, flops


def kernel_work(name: str, shape, dtype=torch.float32):
    """(bytes, operations, FLOP/s attribute of ``Peaks``) of one call of
    the port's kernel ``name`` at ``shape``:

    * ``sqdist_rows`` (m, P) or (m, P, g): the plane, g reference rows
      and the (m,) distances; 3 operations per element (subtract,
      multiply, add) on the CUDA cores;
    * ``sqdist`` (P,): the rows form at m = 1;
    * ``rmsnorm`` (..., D): x read and written, the scale read; 4
      operations per element, f32 statistics;
    * ``flash_attention`` (B, Sq, Sk, H, Hkv, d) or (B, Sq, Sk, H, Hkv,
      d, dv), causal: bf16 on the tensor cores; f32 on them in split
      TF32 (``csrc/attention.cu``), three TF32 products for every
      product, so the operations are 3 x the flops at the TF32 rate;
    * ``swa_attention`` (B, S, H, Hkv, d, window), causal, the same
      programs;
    * ``ssd_scan`` (BH, S, P, N, chunk, R): R heads share a row of b and
      c; the products in TF32 on the tensor cores;
    * ``attention_bwd`` (B, Sq, Sk, H, Hkv, d[, window]), d the head
      width or the (query/key, value) widths (d, dv), causal: q, k, v, o,
      do (at the dtype's width) and the (B, H, Sq) f32 log-sum-exp read
      once, dq, dk and dv written once, each at its own width; 5 products
      per kept pair and head, each at its own width, 2 (3 d + 2 dv)
      flops (s again, dk and dq over d; dp and dv over dv), 2.5 times the
      forward's at d = dv; bf16 on the tensor cores at the bf16 rate
      (``csrc/attention_bwd_bf16.cu``, one bf16 product a product); f32
      as the f32 forward's rows, in split TF32 (3 x the flops at the
      TF32 rate), with the CUDA cores' f32 bound beside
      (``kernel_bound``), on which the kernel runs;
    * ``rmsnorm_bwd`` (rows, D) or (rows, D, g), f32 or bf16: x and dy
      read, dx written, the (g, D) scale read and dscale written, each at
      the dtype's width (2 bytes in bf16); 12 operations an element (the
      two row sums, dx and the dscale term), f32;
    * ``ssd_scan_bwd`` (BH, S, P, N, chunk, R), f32 (``ssd_bwd_work``):
      as the f32 attention rows, in split TF32 (3 x the flops at the
      TF32 rate), with the CUDA cores' f32 bound beside
      (``kernel_bound``), on which the kernel runs."""
    item = torch.empty((), dtype=dtype).element_size()
    # f32 attention: hi.hi + hi.lo + lo.hi, each a TF32 product
    split = 1 if dtype == torch.bfloat16 else 3
    tensor_rate = "bf16" if dtype == torch.bfloat16 else "tf32"
    if name in ("sqdist_rows", "sqdist"):
        m, P, g = ((1, shape[0], 1) if name == "sqdist"
                   else (tuple(shape) + (1,))[:3])
        return (m * P + g * P) * item + 4 * m, 3 * m * P, "f32"
    if name == "rmsnorm":
        n, D = math.prod(shape), shape[-1]
        return 2 * n * item + D * item, 4 * n, "f32"
    if name in ("flash_attention", "swa_attention"):
        if name == "flash_attention":
            B, Sq, Sk, H, Hkv, d, *dv = shape
            w = 0
        else:
            (B, Sq, H, Hkv, d, w), dv = shape, []
            Sk = Sq
        nbytes, flops = attention_work(B, Sq, Sk, H, Hkv, d, True, w, item,
                                       *dv)
        return nbytes, split * flops, tensor_rate
    if name == "ssd_scan":
        BH, S, P, N, Q, R = shape
        return (*ssd_work(BH, S, P, N, BH // R, Q, item), "tf32")
    if name == "attention_bwd":
        B, Sq, Sk, H, Hkv, d, *w = shape
        d, dv = (d, d) if isinstance(d, int) else d
        nbytes, flops = attention_work(B, Sq, Sk, H, Hkv, d, True,
                                       w[0] if w else 0, item, dv)
        # the forward's bytes (q, k, v in, o out) + o and do in again as
        # the backward reads o, do and lse and writes dq, dk, dv
        nbytes = 2 * nbytes + B * H * Sq * 4
        kept = flops // (2 * (d + dv))      # kept pairs x heads
        return nbytes, split * 2 * (3 * d + 2 * dv) * kept, tensor_rate
    if name == "ssd_scan_bwd":
        BH, S, P, N, Q, R = shape
        nbytes, flops = ssd_bwd_work(BH, S, P, N, BH // R, Q, item)
        return nbytes, 3 * flops, "tf32"
    if name == "rmsnorm_bwd":
        rows, D, g = (tuple(shape) + (1,))[:3]
        return 3 * rows * D * item + 2 * g * D * item, 12 * rows * D, "f32"
    raise KeyError(f"no bound for kernel {name!r}")


def kernel_bound(name: str, shape, dtype=torch.float32,
                 card: Peaks = H100) -> dict:
    """The least time of one call of kernel ``name`` at ``shape`` on
    ``card``: ``{"bytes", "ops", "bound_ms", "bound_by"}``; f32 attention,
    its backward and the SSD's add ``bound_ms_f32_cuda_cores``, its flops
    (a third of its TF32 operations) over the CUDA cores' f32 rate, the
    bound of plain f32 FMAs, which the split-TF32 bound sits below."""
    nbytes, ops, rate = kernel_work(name, shape, dtype)
    t_bytes = nbytes / card.hbm * 1e3
    t_ops = ops / getattr(card, rate) * 1e3
    out = {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if name.endswith(("attention", "attention_bwd", "ssd_scan_bwd")) and \
            dtype == torch.float32:
        out["bound_ms_f32_cuda_cores"] = ops / 3 / card.f32 * 1e3
    return out
