"""Kernel micro-benchmarks — the twin of ``benchmarks/kernel_bench.py``
on ``repro_torch``.

The reference's five rows at its shapes, each through the port's
hand-written kernel on the card (``repro_torch.kernels.ops``; on the CPU
the plain versions), held to the port's plain version on the same
inputs (``kernels/ref.py``):

* ``sqdist`` at P = 1,199,882 (the paper's CNN), f32;
* ``sqdist_rows`` over the (64, 1,199,882) fleet plane, f32;
* ``flash_attention`` at (B, S, d) = (1, 512, 64), bf16, causal;
* ``ssd_scan`` at (BH, S, P, N) = (8, 256, 64, 16), chunk 64, f32;
* ``rmsnorm`` at (4096, 1024), bf16, the scale in bf16 (the kernel takes
  x and scale alike; the reference's scale is f32).

Each row keeps the reference's keys: ``kernel``, ``size``,
``abs_err_vs_oracle`` (sqdist) or ``max_err_vs_oracle``, ``ref_us`` (the
plain version's time on the same device) and ``hbm_bytes_one_pass``. On
the card it adds ``kernel_ms`` (``kernels/_timing.py::cuda_ms``: 20
back-to-back calls between CUDA events, so where a call's host work
outlasts its device work, as at the small shapes, the host's time),
``graph_ms`` (``_timing.py::graph_ms``: 10 calls captured in one CUDA
graph and replayed, the device's time a call with no host time between
launches, the number to hold against the bound; inputs that fit in the
L2 stay there between calls, so a small row can read below its
device-memory bound), ``bound_ms`` and ``bound_by``
(``analysis/roofline.py::kernel_bound``,
the least time of the call on an H100) and ``launches`` (the kernel's
``_build.LAUNCHES`` count over one call: 1). A Pallas tile's
``vmem_tile_bytes`` has no meaning on the card; where the CUDA launcher
sets a block's dynamic shared memory (the bf16 attention program and the
three ``ssd_scan`` launches) the row gives ``smem_block_bytes`` by CUDA
kernel, from the launchers' formulas (``smem_block_bytes``); the
distance and norm launchers set none, and their rows leave the key out.

The check is the reference's: every error below 0.1. ``sqdist``'s
error is absolute, on a value near 2.4e6 at the reference's shape, where
one f32 step is 0.25: a kernel that sums in another order than the plain
version misses the check by a rounding, so its row also gives
``rel_err_vs_oracle``, the error over the value.
"""
from __future__ import annotations

import time

import torch

from benchmarks.torch_common import save_rows
from repro_torch.analysis.roofline import kernel_bound
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels._timing import cuda_ms, graph_ms

NAME = "kernel_bench"
PAPER_REF = "kernels/ (sqdist = the protocol's local-condition hot spot)"

SHAPES = dict(sqdist=1_199_882, sqdist_rows=(64, 1_199_882),
              flash_attention=(1, 512, 64), ssd_scan=(8, 256, 64, 16),
              rmsnorm=(4096, 1024))
CHUNK = 64

ARCH = None
# the cut rows that tests/test_torch_bench_cuts.py and chip_smoke.py's
# twins phase run through cut(): (shapes, 0, 0, {}), untimed
CUT = ((dict(sqdist=4099, sqdist_rows=(5, 4099),
             flash_attention=(1, 128, 64), ssd_scan=(2, 128, 64, 16),
             rmsnorm=(64, 1024)), 0, 0, {}),)

# the launchers' shared-memory constants: attention_sm90.cu's kBQ,
# Tile::BK and kStages; ssd_scan.cu's kMaxP, kMaxN and kBoxRow
ATTN_BQ, ATTN_BK, ATTN_STAGES = 128, 64, 2
SSD_MAX_P, SSD_MAX_N, SSD_BOX_ROW = 64, 128, 128


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def smem_block_bytes(kernel: str, shape):
    """Dynamic shared memory a block of each CUDA kernel of ``kernel`` at
    ``shape`` is launched with, as its launcher computes it; None where
    the launcher sets none."""
    if kernel == "flash_attention":                  # Tile<d, d>::SMEM
        d = shape[-1]
        tiles = ATTN_BQ * d * 2 + ATTN_STAGES * 2 * ATTN_BK * d * 2
        return {"attention_kernel_sm90":
                tiles + 8 * (1 + 4 * ATTN_STAGES) + 1024}
    if kernel == "ssd_scan":
        N, Q = shape[3], CHUNK
        boxes = lambda k: (k + 31) // 32            # noqa: E731
        half_box = 64 * SSD_BOX_ROW
        ld4 = _round_up(_round_up(N, 8), 32) + 4
        ld8 = _round_up(SSD_MAX_P, 32) + 8
        return {
            "ssd_scan_cbt_kernel": (_round_up(Q, 16) + Q) * ld4 * 4,
            "ssd_scan_state_kernel": (2 * boxes(Q) * half_box
                                      + (Q * ld8 + 3 * Q) * 4 + 1024),
            "ssd_scan_out_kernel": (2 * (boxes(Q) + boxes(SSD_MAX_N)) * 64
                                    * SSD_BOX_ROW + 2 * Q * 4 + 1024)}
    return None


def inputs(shapes, device, seed: int = 0) -> dict:
    """Each kernel's arguments at ``shapes``, drawn from a
    ``torch.Generator`` seeded ``seed`` on ``device``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    n = shapes["sqdist"]
    mm, nr = shapes["sqdist_rows"]
    B, S, d = shapes["flash_attention"]
    BH, S2, P, N = shapes["ssd_scan"]
    rows, D = shapes["rmsnorm"]
    bf16 = torch.bfloat16
    return {
        "sqdist": (randn(n), randn(n)),
        "sqdist_rows": (randn(mm, nr), randn(nr)),
        "flash_attention": tuple(randn(B, S, d, dtype=bf16)
                                 for _ in range(3)),
        "ssd_scan": (randn(BH, S2, P),
                     torch.nn.functional.softplus(randn(BH, S2)),
                     -torch.exp(randn(BH)), randn(BH, S2, N),
                     randn(BH, S2, N)),
        "rmsnorm": (randn(rows, D, dtype=bf16), randn(D, dtype=bf16)),
    }


KERNELS = {
    "sqdist": (ops.sqdist, ref.sqdist_ref),
    "sqdist_rows": (ops.sqdist_rows, ref.sqdist_rows_ref),
    "flash_attention": (ops.flash_attention, ref.flash_attention_ref),
    "ssd_scan": (lambda *a: ops.ssd_scan(*a, chunk=CHUNK)[0],
                 lambda *a: ref.ssd_scan_ref(*a, chunk=CHUNK)[0]),
    "rmsnorm": (ops.rmsnorm, ref.rmsnorm_ref),
}


def _bound_shape(name, shapes):
    if name == "sqdist":
        return (shapes["sqdist"],)
    if name == "flash_attention":
        B, S, d = shapes[name]
        return (B, S, S, 1, 1, d)
    if name == "ssd_scan":
        return (*shapes[name], CHUNK, 1)
    return shapes[name]


def _ms(fn, device) -> float:
    """Mean ms of ``fn()``: CUDA events on the card, the host clock on
    the CPU."""
    if device.type == "cuda":
        return cuda_ms(fn)
    fn()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    return (time.perf_counter() - t0) / 5 * 1e3


def outputs(shapes, device):
    """``{kernel: (args, kernel output, plain output)}`` at ``shapes``."""
    out = {}
    for name, args in inputs(shapes, device).items():
        kernel, plain = KERNELS[name]
        out[name] = (args, kernel(*args), plain(*args))
    return out


def _err(name, got, want) -> float:
    diff = (got.float() - want.float()).abs()
    if name == "sqdist_rows":                  # relative, floored at 1
        return float((diff / want.float().abs().clamp_min(1.0)).max())
    return float(diff.max())


def rows_at(shapes, device="cuda", timed: bool = True) -> list:
    """The benchmark's rows at ``shapes``."""
    dev = resolve_device(device)
    rows = []
    for name, (args, got, want) in outputs(shapes, dev).items():
        kernel, plain = KERNELS[name]
        shape = shapes[name]
        size = shape if isinstance(shape, int) else "x".join(map(str, shape))
        err_key = ("abs_err_vs_oracle" if name == "sqdist"
                   else "max_err_vs_oracle")
        row = {"kernel": name, "size": size, err_key: _err(name, got, want),
               "hbm_bytes_one_pass": _one_pass_bytes(name, args)}
        if name == "sqdist":
            row["rel_err_vs_oracle"] = row[err_key] / abs(float(want))
        smem = smem_block_bytes(name, shape) if dev.type == "cuda" else None
        if smem:
            row["smem_block_bytes"] = smem
        if timed:
            row["ref_us"] = round(_ms(lambda: plain(*args), dev) * 1e3, 1)
        if dev.type == "cuda":
            before = _build.LAUNCHES[name]
            kernel(*args)
            row["launches"] = _build.LAUNCHES[name] - before
            if timed:
                row["kernel_ms"] = _ms(lambda: kernel(*args), dev)
                row["graph_ms"] = graph_ms(lambda: kernel(*args))
                b = kernel_bound(name, _bound_shape(name, shapes),
                                 args[0].dtype)
                row["bound_ms"], row["bound_by"] = b["bound_ms"], b["bound_by"]
        rows.append(row)
    return rows


def _one_pass_bytes(name, args) -> int:
    """The reference's HBM bytes of one pass: each input read once (the
    rows' reference once; attention's q, k, v; ssd's x, dt, b, c; the
    norm's x read and written)."""
    if name == "sqdist":
        return 2 * args[0].numel() * 4
    if name == "sqdist_rows":
        return (args[0].numel() + args[1].numel()) * 4
    if name == "flash_attention":
        return sum(a.numel() for a in args) * 2
    if name == "ssd_scan":
        x, dt, _, b, c = args
        return (x.numel() + dt.numel() + b.numel() + c.numel()) * 4
    return args[0].numel() * 2 * 2


def cut(case, device="cuda", source=None, init_fn=None):
    """One case of ``CUT``: ``(None, {"rows": its untimed rows})``."""
    return None, {"rows": rows_at(case[0], device, timed=False)}


def run(quick: bool = True, device="cuda"):
    rows = rows_at(SHAPES, device)
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    ok = all(r.get("abs_err_vs_oracle", r.get("max_err_vs_oracle", 1)) < 0.1
             for r in rows)
    return "PASS" if ok else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
