"""The bf16 backward kernels on the card: ``attention_bwd`` in bf16
(``csrc/attention_bwd_bf16.cu``) and ``rmsnorm_bwd`` in bf16
(``csrc/rmsnorm_bwd.cu``), checked, then timed beside their parent
commit's programs in one process.

    python3 benchmarks/torch_attention_bwd_bf16.py [--quick] [--norm-sweep]
                                                    [--parent DIR]

Builds the ``attention``, ``attention_bwd_bf16`` and ``rmsnorm``
libraries (one ``nvcc`` each, started together) and prints the
registers and spills of their backward kernels (``-Xptxas=-v``). Then
holds the attention backward at small and ragged shapes (every width
pair, GQA, causal, a window, Sk != Sq) and the norm backward at ragged
widths and on views off 16 bytes against the f32 gradient of their plain
versions on the same bf16 inputs, and a second launch bit for bit;
``--quick`` stops there; ``--norm-sweep`` then times the norm at
(4096, 4096) under other partitions (threads by rows a chunk) and
stops. Otherwise it runs ``chip_smoke.py``'s bf16
backward checks and timings (``_bf16_attention_bwd``, ``_bf16_norm_bwd``:
every ``TRAIN_ATTN_BF16_CASES`` and ``TRAIN_NORM_BF16_CASES`` case held
to twice the library's error, medians of 7 beside SDPA's and
``F.rms_norm``'s backward) and each launch's device time at the four
timed attention shapes (``torch.profiler``). With ``--parent DIR`` (an
unpacked earlier commit) it builds that commit's two backward sources
too and times both programs in turns at the timed shapes: parent,
change, change, parent, 5 timings of 5 calls each a turn. One JSON line
a section, then the card's name and power limit as ``nvidia-smi``
reports them. Needs a CUDA device; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.analysis.roofline import peaks  # noqa: E402
from repro_torch.kernels import _build, flash_attention, ref, rmsnorm  # noqa: E402
from repro_torch.kernels._timing import cuda_ms, profile_calls  # noqa: E402

LIBS = ("attention", "attention_bwd_bf16", "rmsnorm")
# (B, Sq, Sk, H, Hkv, (d, dv), causal, window): the small checks
SMALL = [(2, 100, 100, 4, 4, (64, 64), True, 0),
         (1, 130, 130, 8, 2, (128, 128), True, 0),
         (1, 150, 150, 4, 1, (64, 64), True, 40),
         (2, 70, 100, 2, 2, (32, 32), False, 0),
         (1, 90, 200, 4, 1, (128, 128), True, 0),
         (1, 100, 100, 2, 2, (192, 128), True, 0),
         (2, 70, 100, 2, 2, (192, 128), False, 0),
         (1, 300, 300, 4, 2, (32, 32), True, 0),
         (1, 200, 333, 6, 3, (128, 128), False, 64)]
# each gradient's max |diff| over its max against the f32 yardstick
SMALL_REL = 2e-2
# (rows, D, groups, offset): rmsnorm_bwd in bf16, x and dy views that
# start `offset` values past a 16-byte boundary (dx is aligned: the
# kernel's scalar paths for a dx or dy off x's alignment)
NORM_SMALL = [(64, 768, 1, 0), (40, 1601, 1, 0), (24, 4096, 4, 0),
              (33, 4100, 1, 0), (12, 200, 3, 1), (5, 16384, 1, 0),
              (7, 8200, 1, 3), (9, 7, 1, 0)]
NORM_REL = 2.0 ** -7


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def build() -> None:
    built = _build.build_all(LIBS)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    for n, r in built.items():     # the whole compiler output, to read
        with open(os.path.join(out, f"ptxas_{n}.log"), "w") as f:
            f.write(r["log"])
    lines = [cs.ptxas_line(x) for r in built.values()
             for x in r["log"].splitlines()]
    emit({"built": {n: r["seconds"] for n, r in built.items()},
          "ptxas": {p: cs.kernel_resources(lines, p)
                    for p in ("attention_bwd_bf16_", "rmsnorm_bwd_")}})


def inputs(g, B, Sq, Sk, H, Hkv, d, dv):
    def randn(*s):
        return torch.randn(s, generator=g, device="cuda").bfloat16()
    return (randn(B, Sq, H, d), randn(B, Sk, Hkv, d), randn(B, Sk, Hkv, dv),
            randn(B, Sq, H, dv))


def small_checks(g) -> None:
    for B, Sq, Sk, H, Hkv, (d, dv), causal, w in SMALL:
        q, k, v, do = inputs(g, B, Sq, Sk, H, Hkv, d, dv)
        kw = dict(causal=causal, window=w, scale=None)
        o, lse = flash_attention.attention(q, k, v, with_lse=True, **kw)
        got = flash_attention.attention_bwd(q, k, v, o, lse, do, **kw)
        again = flash_attention.attention_bwd(q, k, v, o, lse, do, **kw)
        want = ref.flash_attention_gqa_bwd_ref(
            q.float(), k.float(), v.float(), do.float(), **kw)
        torch.cuda.synchronize()
        err = [cs._rel_max(a, x) for a, x in zip(got, want)]
        rec = {"case": [B, Sq, Sk, H, Hkv, d, dv, causal, w],
               "rel_err": err, "finite": all(bool(torch.isfinite(
                   a.float()).all()) for a in got),
               "bitwise_repeat": all(torch.equal(a, b)
                                     for a, b in zip(got, again))}
        rec["ok"] = rec["finite"] and rec["bitwise_repeat"] and \
            max(err) <= SMALL_REL
        emit(rec)
        if not rec["ok"]:
            raise SystemExit(f"the bf16 attention_bwd disagrees: {rec}")


def norm_small_checks(g) -> None:
    for rows, D, gr, off in NORM_SMALL:
        def view():
            buf = torch.randn(rows * D + off, generator=g,
                              device="cuda").bfloat16()
            return buf[off:].view(rows, D)
        x, dy = view(), view()
        s = (1 + 0.1 * torch.randn(*((gr, D) if gr > 1 else (D,)),
                                   generator=g, device="cuda")).bfloat16()
        got = rmsnorm.rmsnorm_bwd(x, s, dy, 1e-5)
        again = rmsnorm.rmsnorm_bwd(x, s, dy, 1e-5)
        want = ref.rmsnorm_bwd_ref(x.float(), s.float(), dy.float(), 1e-5)
        torch.cuda.synchronize()
        err = [cs._rel_max(a, w) for a, w in zip(got, want)]
        rec = {"norm_case": [rows, D, gr, off], "rel_err": err,
               "bitwise_repeat": all(torch.equal(a, b)
                                     for a, b in zip(got, again))}
        rec["ok"] = rec["bitwise_repeat"] and max(err) <= NORM_REL
        emit(rec)
        if not rec["ok"]:
            raise SystemExit(f"the bf16 rmsnorm_bwd disagrees: {rec}")


def timed_cases():
    return [c for c in cs.TRAIN_ATTN_BF16_CASES[:cs.TRAIN_ATTN_BF16_TIMED]]


def per_launch(g) -> None:
    """Each launch's device time at the timed shapes, by kernel."""
    for B, Sq, Sk, H, Hkv, d, causal, w, label in timed_cases():
        d, dv = (d, d) if isinstance(d, int) else d
        q, k, v, do = inputs(g, B, Sq, Sk, H, Hkv, d, dv)
        kw = dict(causal=causal, window=w, scale=None)
        o, lse = flash_attention.attention(q, k, v, with_lse=True, **kw)
        prof = profile_calls(lambda: flash_attention.attention_bwd(
            q, k, v, o, lse, do, **kw), 5)
        emit({"per_launch": label, **prof})
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    for R, D, gr, label in cs.TRAIN_NORM_BF16_CASES:
        x, dy = (torch.randn(R, D, generator=g, device="cuda").bfloat16()
                 for _ in range(2))
        s = (1 + 0.1 * torch.randn(*((gr, D) if gr > 1 else (D,)),
                                   generator=g, device="cuda")).bfloat16()
        prof = profile_calls(lambda: rmsnorm.rmsnorm_bwd(x, s, dy, 1e-5), 10)
        emit({"per_launch": "rmsnorm_bwd bf16 " + label, **prof})


def parent_library(parent: str) -> dict:
    """The parent's attention_bwd_bf16 and rmsnorm libraries, built from
    its sources with this build's flags: {name: CDLL}."""
    csrc = os.path.join(parent, "src", "repro_torch", "kernels", "csrc")
    srcs = {"attention_bwd_bf16": ["attention_bwd_bf16.cu"],
            "rmsnorm": ["rmsnorm.cu", "rmsnorm_bwd.cu"]}
    procs = {}
    for name, files in srcs.items():
        out = _build.BUILD_DIR / f"parent-{name}.so"
        procs[name] = out, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
             *(os.path.join(csrc, f) for f in files)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"the parent's {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
        err = libs[name].repro_cuda_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    P, I, LL, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    f = libs["attention_bwd_bf16"].repro_attention_bwd_bf16
    f.restype, f.argtypes = I, [I, I, *[P] * 11, *[I] * 7, F, P]
    f = libs["rmsnorm"].repro_rmsnorm_bwd
    f.restype, f.argtypes = I, [I, P, P, P, P, P, P, LL, I, LL, I, I, F, P]
    return libs


def parent_attention_bwd(lib, q, k, v, o, lse, do, causal, window):
    """PR 31's program (four launches, an f32 partial for the group)."""
    B, Sq, H, d = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dvg = (torch.empty_like(t) for t in (q, k, v))
    delta = lse.new_empty((B, H, Sq))
    part = lse.new_empty((B * Sk * H * (d + dv),))
    code = lib.repro_attention_bwd_bf16(
        d, dv, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dvg.data_ptr(), delta.data_ptr(), part.data_ptr(), B, H, Hkv, Sq, Sk,
        int(causal), int(window), ctypes.c_float(d ** -0.5),
        _build.current_stream(q.device.index))
    _build.check(lib, code, "the parent's attention_bwd_bf16")
    return dq, dk, dvg


def parent_norm_bwd(lib, x, s, dy):
    """PR 31's rmsnorm_bwd in bf16: one thread per 4 columns, scalar
    loads (the parent's plan)."""
    rows, D = x.shape
    g = s.shape[0] if s.dim() == 2 else 1
    threads = min(512, 32 * max(1, -(-D // 128)))
    chunk = min(max(1, -(-rows // 264)), rows // g)
    chunks = -(-(rows // g) // chunk)
    dx, ds = torch.empty_like(x), torch.empty_like(s)
    part = x.new_empty((g * chunks, D), dtype=torch.float32)
    code = lib.repro_rmsnorm_bwd(
        1, x.data_ptr(), s.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        ds.data_ptr(), part.data_ptr(), rows, D, rows // g, chunk, threads,
        1e-5, _build.current_stream(x.device.index))
    _build.check(lib, code, "the parent's rmsnorm_bwd")
    return dx, ds


def in_turns(label, parent_fn, new_fn) -> None:
    """parent, change, change, parent: 5 timings of 5 calls a turn."""
    times = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        fn = parent_fn if who == "parent" else new_fn
        times[who] += [cuda_ms(fn, 5, 1) for _ in range(5)]
    emit({"in_turns": label, **{
        f"{k}_median_ms": sorted(v)[len(v) // 2] for k, v in times.items()},
        **{f"{k}_ms": v for k, v in times.items()}})


def against_parent(g, parent: str) -> None:
    libs = parent_library(parent)
    for B, Sq, Sk, H, Hkv, d, causal, w, label in timed_cases():
        d, dv = (d, d) if isinstance(d, int) else d
        q, k, v, do = inputs(g, B, Sq, Sk, H, Hkv, d, dv)
        kw = dict(causal=causal, window=w, scale=None)
        o, lse = flash_attention.attention(q, k, v, with_lse=True, **kw)
        in_turns(label, lambda: parent_attention_bwd(
            libs["attention_bwd_bf16"], q, k, v, o, lse, do, causal, w),
            lambda: flash_attention.attention_bwd(q, k, v, o, lse, do, **kw))
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    for R, D, gr, label in [*cs.TRAIN_NORM_BF16_CASES,
                            (4096, 4096, 1, "f32 (4096, 4096)")]:
        dt = torch.float32 if label.startswith("f32") else torch.bfloat16
        x, dy = (torch.randn(R, D, generator=g, device="cuda").to(dt)
                 for _ in range(2))
        s = (1 + 0.1 * torch.randn(*((gr, D) if gr > 1 else (D,)),
                                   generator=g, device="cuda")).to(dt)
        if dt == torch.bfloat16:
            in_turns("rmsnorm_bwd bf16 " + label, lambda: parent_norm_bwd(
                libs["rmsnorm"], x, s, dy),
                lambda: rmsnorm.rmsnorm_bwd(x, s, dy, 1e-5))
        else:
            emit({"rmsnorm_bwd": label, "ms": sorted(
                cuda_ms(lambda: rmsnorm.rmsnorm_bwd(x, s, dy, 1e-5))
                for _ in range(7))[3]})


def norm_sweep(g) -> None:
    """rmsnorm_bwd in bf16 at (4096, 4096) under other partitions than
    ``bwd_plan``'s: threads a block (so vectors a thread) by rows a
    chunk, each the median of 7 timings of 20 calls."""
    x, dy = (torch.randn(4096, 4096, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    s = (1 + 0.1 * torch.randn(4096, generator=g, device="cuda")).bfloat16()
    stock = rmsnorm.bwd_plan
    try:
        for threads in (512, 256, 128):
            for chunk in (8, 16, 32):
                rmsnorm.bwd_plan = lambda rows, D, gr=1, dt=None: \
                    rmsnorm.BwdPlan(threads, chunk, -(-rows // chunk))
                ms = sorted(cuda_ms(lambda: rmsnorm.rmsnorm_bwd(
                    x, s, dy, 1e-5)) for _ in range(7))[3]
                emit({"norm_sweep": [threads, chunk], "ms": ms})
    finally:
        rmsnorm.bwd_plan = stock


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--norm-sweep", action="store_true")
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    build()
    g = torch.Generator(device="cuda").manual_seed(5)
    small_checks(g)
    norm_small_checks(g)
    if args.norm_sweep:
        norm_sweep(g)
        return
    if not args.quick:
        per_launch(g)
        checks = []
        card = peaks(torch.cuda.get_device_name(0))

        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda")
        emit({"attention_bwd_bf16": cs._bf16_attention_bwd(
            randn, checks, card)})
        emit({"rmsnorm_bwd_bf16": cs._bf16_norm_bwd(randn, checks, card)})
        emit({"checks": checks})
        if args.parent:
            against_parent(g, args.parent)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)


if __name__ == "__main__":
    main()
