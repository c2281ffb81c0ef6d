"""Warp pairs a block of ``attention_bwd.cu`` at MLA's widths: the 4 it
takes at (192, 128) against 5, which also fit the 232,448 bytes of
shared memory a block may have, on the card, in one process.

    python3 benchmarks/torch_attention_bwd_pairs.py

Builds the ``attention`` library twice, with ``-DREPRO_BWD_NARROW_PAIRS``
4 (the stock count) and 5, one ``nvcc`` each, started together; times
``flash_attention.attention_bwd`` at deepseek-v2-236b's (1, 4096, 128,
192/128) causal in the order 4, 5, 5, 4, 7 timings of 5 calls each by
CUDA events a turn (the median of a build's 14), and holds each
build's gradient against the plain f32 version's (max |diff|). One JSON
line a build, with the registers and spills of its kernels at (192, 128)
(``ptxas``), then the card's name and power limit as ``nvidia-smi``
reports them. Needs a CUDA device; it imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, flash_attention, ref  # noqa: E402
from repro_torch.kernels._timing import cuda_ms  # noqa: E402

SHAPE = (1, 4096, 128, 192, 128)   # B, S, H (= Hkv), d, dv
PAIRS = (4, 5)                     # the stock build's, the variant's


def build(pairs_list) -> dict:
    """The ``attention`` library once for each narrow pair count, one
    ``nvcc`` each, all started together: {pairs: (library, ptxas log)}."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for pairs in pairs_list:
        out = _build.BUILD_DIR / f"attention-pairs{pairs}.so"
        procs[pairs] = out, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS,
             f"-DREPRO_BWD_NARROW_PAIRS={pairs}", "-o", str(out),
             *(str(_build.CSRC / s) for s in _build.SOURCES["attention"])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for pairs, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed at {pairs} pairs:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, (restype, argtypes) in _build.SIGNATURES["attention"].items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = restype, argtypes
        built[pairs] = lib, log
    return built


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_attention_bwd_pairs.py needs a CUDA device")
    built = build(PAIRS)
    B, S, H, d, dv = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k = (torch.randn(B, S, H, d, generator=gen, device="cuda")
            for _ in range(2))
    v, do = (torch.randn(B, S, H, dv, generator=gen, device="cuda")
             for _ in range(2))
    kw = dict(causal=True, window=0, scale=None)
    _build._LOADED["attention"] = built[PAIRS[0]][0]
    o, lse = flash_attention.attention(q, k, v, with_lse=True, **kw)
    want = ref.flash_attention_gqa_bwd_ref(q, k, v, do, **kw)
    times, errs = {p: [] for p in PAIRS}, {}

    def bwd():
        return flash_attention.attention_bwd(q, k, v, o, lse, do, **kw)

    for pairs in (*PAIRS, *PAIRS[::-1]):
        _build._LOADED["attention"] = built[pairs][0]
        got = bwd()
        torch.cuda.synchronize()
        errs[pairs] = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
        del got
        times[pairs] += [cuda_ms(bwd, 5, 1) for _ in range(7)]
    for pairs in PAIRS:
        t = times[pairs]
        ptxas = [cs.ptxas_line(line) for line in built[pairs][1].splitlines()
                 if "ptxas" in line or "spill" in line]
        print(json.dumps({
            "shape": list(SHAPE), "causal": True, "pairs": pairs,
            "ms": float(np.median(t)), "ms_spread": [min(t), max(t)],
            "max_abs_err_vs_plain_f32": errs[pairs],
            "registers": {n: r for n, r in cs.kernel_resources(
                ptxas, "").items() if "ILi192ELi128E" in n}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
