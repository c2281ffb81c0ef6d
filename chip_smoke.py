"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all at once)
and drives both of the port's paths:

* training (slice 1): holds the ``sqdist_rows``/``sqdist`` kernels
  against their plain versions on the card, trains the paper's MNIST CNN
  at full width (m = 100 learners, B = 10) under periodic and dynamic
  averaging through ``run_protocol_training``, checks that the dynamic
  run went through ``sqdist_rows`` once per checked round, and that a
  small dynamic run on the card makes exactly the sync decisions of the
  same run on the CPU. The scalar ``sqdist`` kernel (behind
  ``divergence.sq_distance(use_kernel=True)``) is not on the training
  path, as in the reference: it is checked and timed, and its main-path
  count is 0.
* serving (slice 2): holds the ``rmsnorm``, ``flash_attention`` and
  ``swa_attention`` kernels against their plain versions on the card in
  f32 and bf16 (small and ragged shapes, then the serving path's own),
  checks that the llama3-8b and llama3-8b-swa smoke configs give the
  CPU's logits and greedy tokens on the card, then serves llama3-8b at
  full width and depth in bf16 (prefill at B = 4, S = 2,048; a batch-4
  ``ServeEngine`` feeding 32 prompt tokens and generating 32) and runs
  the llama3-8b-swa prefill at B = 1, S = 16,384 through the banded
  kernel, counting each kernel's launches on each path.
* attention on the tensor cores (slice 4): bf16 attention runs the
  TMA-fed ``wgmma`` program (``attention_sm90.cu``), f32 the CUDA-core
  one (``attention.cu``); the serving checks above cover both, with the
  bf16 program's edges (ragged tiles, Sq = 1, Sk = 129, a one-tile
  window, head dims 32 and 64, more (batch, head) pairs than SMs).
* Mamba2 serving (slice 3): holds the ``ssd_scan`` kernel against the
  sequential plain version on the card (small and ragged S, chunks 8 to
  64, f32 and bf16, strong decay, grouped B and C, bitwise repeats, then
  the serving tensor, timed), checks that the mamba2-2.7b smoke config
  gives the CPU's logits and greedy tokens on the card, then serves
  mamba2-2.7b at full width and depth in bf16 (prefill at B = 4,
  S = 2,048; a batch-4 ``ServeEngine`` feeding 32 prompt tokens and
  generating 32), counting launches, and holds the engine's logits from
  the O(1) recurrence against the prefill's from the chunked kernel.

Each phase prints one JSON line with its seconds. The last three lines
are the kernel table, the card's name and power limit as ``nvidia-smi``
reports them, and ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before those lines; without a CUDA device the script exits
non-zero at once. It imports nothing of JAX and nothing of the JAX
package.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device is visible "
             "(torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

from repro_torch.config import ProtocolConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.flatten import tree_leaves, tree_map  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.data.synthetic import SyntheticMNIST  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, flash_attention, ops, ref, rmsnorm, sqdist, ssd_scan,
    swa_attention,
)
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params  # noqa: E402
from repro_torch.models.model import init_lm_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine, make_prefill  # noqa: E402
from repro_torch.train.loop import run_protocol_training  # noqa: E402

P_MNIST = 1_199_882          # mnist_cnn's weights (Table 1)
M, B, ROUNDS, CHUNK, PERIOD, DELTA = 100, 10, 60, 20, 10, 0.7
TOL = dict(rtol=1e-5, atol=1e-6)

# published peaks (NVIDIA data sheets, dense): device-memory bytes/s,
# f32 flop/s outside the tensor cores, bf16 tensor-core flop/s
PEAKS = {"H100 PCIe": (2.0e12, 51e12, 756e12),
         "H100 NVL": (3.9e12, 60e12, 835e12),
         "H100": (3.35e12, 67e12, 989e12), "H200": (4.8e12, 67e12, 989e12)}

# the serving path (llama3-8b and its sliding-window variant, bf16)
SERVE_B, SERVE_S, PROMPT, GEN = 4, 2048, 32, 32
SWA_B, SWA_S = 1, 16_384
# kernel vs plain on the card: f32 differs only in summation order; bf16
# outputs may land one bf16 step apart (the same f32 value rounded once)
LM_TOL = {("rmsnorm", torch.float32): dict(rtol=1e-5, atol=1e-6),
          ("attention", torch.float32): dict(rtol=1e-4, atol=1e-5),
          ("rmsnorm", torch.bfloat16): dict(rtol=2 ** -7, atol=1e-5),
          ("attention", torch.bfloat16): dict(rtol=2 ** -7, atol=1e-5)}
# the smoke configs on the card against the CPU, in f32: matmuls, softmax
# and norm statistics summed in other orders through two layers
AGREE_TOL = dict(rtol=1e-4, atol=1e-5)
# full-width serving in bf16: the engine's prompt logits against the
# prefill's, and the band below the window against full attention, as
# max |diff| over max |logit| (bf16 keeps ~3 significant digits; 32 layers)
SERVE_REL_TOL = 5e-2
# the edges of the bf16 tensor-core attention program (128-row query tiles
# of two 64-row halves, 64-key tiles, TMA zero-fill past Sq and Sk, a 1-D
# grid): ragged Sq and Sk, Sq = 1, Sk = 129, a window of one key tile, head
# dims 32 and 64, B * H above the card's 132 SMs. (B, Sq, Sk, H, Hkv, d,
# causal, window), checked in f32 and bf16 like the cases before them
ATTN_EDGES = [(2, 100, 200, 4, 2, 128, True, 0),
              (1, 300, 300, 8, 2, 128, True, 0),
              (3, 1, 300, 8, 2, 128, True, 0), (2, 1, 77, 4, 4, 64, False, 0),
              (1, 129, 129, 4, 2, 128, True, 0),
              (2, 40, 129, 4, 1, 64, False, 0),
              (1, 256, 256, 4, 2, 128, True, 64),
              (2, 200, 200, 4, 2, 32, True, 0),
              (2, 200, 200, 4, 2, 64, True, 48),
              (5, 130, 130, 32, 8, 64, True, 0)]
# ssd_scan against the sequential plain version: the JAX package's own
# tolerances for this kernel (tests/test_kernels.py:181-182)
SSM_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-3),
           torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
# mamba2-2.7b at full width, the engine's prompt logits (the O(1)
# recurrence) against the prefill's (the chunked kernel), as max |diff|
# over max |logit|. In f32 the two paths differ only in summation order.
# In bf16 they also round products of other shapes (gemm in prefill, gemv
# in decode) differently, and random weights amplify that with depth: the
# JAX package's own bf16 prefill and decode, on the same weights at 64
# layers, differ by 7.36-8.68% over three draws
# (tests/test_torch_ssm.py::test_bf16_prompt_gap_tracks_the_reference).
# The port may differ as much as the reference does, and no more; the
# phase prints both gaps and each bf16 path's distance from the f32 logits.
SSM_F32_REL_TOL = 1e-4
SSM_SERVE_REL_TOL = 0.0868
# the SSM tree holds L * (H + d_inner - d) + d weights more than
# param_count() counts (see repro_torch.config.ModelConfig.param_count)
SSM_TREE_EXTRA = 171_520


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def peaks(name: str):
    for key in sorted(PEAKS, key=len, reverse=True):
        if all(part in name for part in key.split()):
            return PEAKS[key]
    raise ValueError(f"no published peaks for {name!r}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rec = {"phase": "env", "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "nvcc": _build.nvcc_path(),
           "ninja": shutil.which("ninja")}
    emit(rec)
    return rec


def ptxas_line(line: str) -> str:
    """A line of ``-Xptxas=-v``, a function's mangled name cut to the
    kernel's own name and its template arguments."""
    line = line.strip()
    mangled = re.search(r"_ZN?(\w+)", line)
    if "entry function" not in line or not mangled:
        return line
    name, at = mangled.group(1), 0     # a run of <length><identifier>
    while (size := re.match(r"\d+", name[at:])) is not None:
        at += len(size.group())
        ident, at = name[at:at + int(size.group())], at + int(size.group())
        if "kernel" in ident:
            args = re.match(r"I\w*?E", name[at:])
            return "entry " + ident + (args.group() if args else "")
    return line


def phase_build() -> dict:
    t0 = time.perf_counter()
    built = _build.build_all()
    rec = {"phase": "build", "seconds": time.perf_counter() - t0,
           "built": {n: r["seconds"] for n, r in built.items()},
           "ptxas": [ptxas_line(line) for r in built.values()
                     for line in r["log"].splitlines()
                     if "entry function" in line or "registers" in line
                     or "spill" in line or "Performance Loss" in line]}
    for name in _build.SOURCES:
        _build.library(name)
    emit(rec)
    return rec


def phase_kernels(gen) -> dict:
    """Each kernel against its plain version on the card, at rtol 1e-5 /
    atol 1e-6, and bitwise equal across two launches."""
    checks = []
    worst = {k: {"abs": 0.0, "rel": 0.0} for k in ("sqdist_rows", "sqdist")}

    def check(name, kernel, plain, args, label):
        a, b = kernel(*args), kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = float((a - want).abs().max())
        rel = float(((a - want).abs() / want.abs().clamp_min(1e-30)).max())
        worst[name]["abs"] = max(worst[name]["abs"], err)
        worst[name]["rel"] = max(worst[name]["rel"], rel)
        repeat = bool(torch.equal(a, b))
        ok = repeat and bool(torch.allclose(a, want, **TOL))
        checks.append({"kernel": name, "inputs": label,
                       "dtype": str(args[0].dtype).split(".")[1],
                       "max_abs_err": err, "max_rel_err": rel,
                       "bitwise_repeat": repeat, "ok": ok})
        if not ok:
            emit({"phase": "kernels", "failed": checks[-1]})
            raise SystemExit(f"kernel {name} disagrees: {checks[-1]}")

    # sqdist flattens its inputs: (1, P_MNIST) is one whole mnist_cnn model
    for m, n in [(1, 1), (17, 515), (1, P_MNIST), (7, P_MNIST),
                 (100, P_MNIST)]:
        for dt in (torch.float32, torch.bfloat16):
            X = torch.randn((m, n), generator=gen, device="cuda").to(dt)
            r = torch.randn((n,), generator=gen, device="cuda").to(dt)
            R = r.expand(m, n).contiguous()
            check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref,
                  (X, r), [m, n])
            check("sqdist", sqdist.sqdist, ref.sqdist_ref, (X, R), [m, n])
            del X, R

    mem_rate, f32_rate, _ = peaks(torch.cuda.get_device_name(0))
    X = torch.randn((M, P_MNIST), generator=gen, device="cuda")
    r = torch.randn((P_MNIST,), generator=gen, device="cuda")
    x0 = X[0]
    # the timed inputs themselves, checked as the shapes above
    check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref, (X, r),
          "timed X (100, P)")
    check("sqdist", sqdist.sqdist, ref.sqdist_ref, (x0, r),
          "timed x0 = X[0] (P,)")
    timed = {
        "sqdist_rows": (M, lambda: sqdist.sqdist_rows(X, r),
                        lambda: ref.sqdist_rows_ref(X, r),
                        lambda: torch.linalg.vector_norm(X - r, dim=1)
                        .square()),
        "sqdist": (1, lambda: sqdist.sqdist(x0, r),
                   lambda: ref.sqdist_ref(x0, r),
                   lambda: torch.linalg.vector_norm(x0 - r).square()),
    }
    table = {}
    for name, (m, kernel, plain, library) in timed.items():
        nbytes = (m * P_MNIST + P_MNIST) * 4 + 4 * m
        nops = 3 * m * P_MNIST
        t_bytes, t_ops = nbytes / mem_rate * 1e3, nops / f32_rate * 1e3
        table[name] = {
            "shape": [m, P_MNIST], "dtype": "float32",
            "max_abs_err": worst[name]["abs"],
            "max_rel_err": worst[name]["rel"], "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": nops}
    emit({"phase": "kernels", "checks": len(checks),
          "all_ok": all(c["ok"] for c in checks), "timed": table,
          "peaks": {"bytes_per_s": mem_rate, "f32_flops": f32_rate}})
    return table


def phase_train() -> dict:
    """The main path: full-width mnist_cnn, m = 100, through
    run_protocol_training, periodic then dynamic."""
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init_fn = lambda g: init_cnn_params(cfg, g)          # noqa: E731
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    test = src.sample(torch.Generator(device="cuda").manual_seed(10_000), 512)
    train = TrainConfig(optimizer="sgd", learning_rate=0.1)
    protos = {"periodic": ProtocolConfig(kind="periodic", b=PERIOD),
              "dynamic": ProtocolConfig(kind="dynamic", b=PERIOD,
                                        delta=DELTA)}
    # warm-up outside the counted window: cuDNN picks its algorithms
    run_protocol_training(loss_fn, init_fn, src, m=M, rounds=2,
                          protocol=protos["dynamic"], train=train, batch=B,
                          device="cuda")
    torch.cuda.synchronize()

    runs, launches = {}, {}
    ops.reset_launches()
    for name, proto in protos.items():
        before = dict(ops.LAUNCHES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        dl, traj = run_protocol_training(
            loss_fn, init_fn, src, m=M, rounds=ROUNDS, protocol=proto,
            train=train, batch=B, chunk_size=CHUNK, record_every=CHUNK,
            device="cuda")
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = {k: ops.LAUNCHES[k] - before[k] for k in before}
        acc = float(cnn_accuracy(cfg, dl.mean_model(), test))
        runs[name] = {
            "weights": dl.model_size, "rounds": dl.rounds,
            "syncs": dl.comm_totals["syncs"],
            "full_syncs": dl.comm_totals["full_syncs"],
            "comm_bytes": dl.comm_bytes(),
            "ledger_bytes": int(dl.per_link_bytes().sum()),
            "cumulative_loss": dl.cumulative_loss,
            "accuracy_512": acc,
            "ms_per_round": start.elapsed_time(end) / ROUNDS,
            "wall_s": wall, "launches": launches[name],
            "plane_device": str(dl.X.device),
            "trajectory_syncs": traj.syncs}
        if dl.model_size != P_MNIST:
            raise SystemExit(f"mnist_cnn has {dl.model_size} weights, "
                             f"not {P_MNIST}")
        if not (math.isfinite(dl.cumulative_loss)
                and np.isfinite(dl.cumulative_loss_per_learner).all()):
            raise SystemExit(f"{name}: non-finite loss")
        if runs[name]["ledger_bytes"] != dl.comm_bytes():
            raise SystemExit(f"{name}: ledger {runs[name]['ledger_bytes']} "
                             f"!= comm_bytes {dl.comm_bytes()}")
        if not dl.X.is_cuda:
            raise SystemExit(f"{name}: the parameter plane is on {dl.X.device}")
        del dl
    total = dict(ops.LAUNCHES)
    emit({"phase": "train", "m": M, "batch": B, "runs": runs})

    checked = ROUNDS // PERIOD
    if launches["periodic"]["sqdist_rows"] != 0:
        raise SystemExit(f"periodic launched sqdist_rows: {launches}")
    if launches["dynamic"]["sqdist_rows"] != checked:
        raise SystemExit(f"dynamic launched sqdist_rows "
                         f"{launches['dynamic']['sqdist_rows']} times, not "
                         f"once per checked round ({checked})")
    if runs["dynamic"]["syncs"] < 1:
        raise SystemExit(f"the dynamic run never synced, so the balancing "
                         f"path did not run: {runs['dynamic']}")
    if runs["dynamic"]["comm_bytes"] >= runs["periodic"]["comm_bytes"]:
        raise SystemExit("dynamic averaging communicated no less than "
                         "periodic")
    return total


def phase_agree() -> dict:
    """The same small dynamic run on the card and on the CPU, from the same
    initial model and batches: identical sync decisions and byte counts,
    losses and parameters to f32-reassociation tolerance."""
    cfg = get_arch("mnist_cnn", smoke=True)
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init = params_to_numpy(init_cnn_params(cfg, torch.Generator()
                                           .manual_seed(3)))
    src = SyntheticMNIST(seed=0, image_size=14, device="cpu")
    batches = src.sample(torch.Generator().manual_seed(4), 10, lead=(12, 4))
    out = {}
    for dev in ("cpu", "cuda"):
        dl = DecentralizedLearner(
            loss_fn, lambda g: params_from_numpy(init, g.device), 4,
            ProtocolConfig(kind="dynamic", b=2, delta=0.01),
            TrainConfig(optimizer="sgd", learning_rate=0.05), device=dev)
        dl.run_chunk({k: v.to(dev) for k, v in batches.items()})
        out[dev] = dl
    cpu, gpu = out["cpu"], out["cuda"]
    err = float((gpu.X.cpu() - cpu.X).abs().max())
    rec = {"phase": "agree", "comm_totals": gpu.comm_totals,
           "cpu_comm_totals": cpu.comm_totals,
           "loss": gpu.cumulative_loss, "cpu_loss": cpu.cumulative_loss,
           "param_max_abs_err": err}
    emit(rec)
    if (gpu.comm_totals != cpu.comm_totals
            or not np.array_equal(gpu.per_link_bytes(), cpu.per_link_bytes())
            or gpu.comm_totals["syncs"] < 1):
        raise SystemExit("the card's sync decisions differ from the CPU's")
    if not (math.isclose(gpu.cumulative_loss, cpu.cumulative_loss,
                         rel_tol=1e-5) and err <= 1e-5):
        raise SystemExit("the card's losses or parameters differ from the "
                         "CPU's beyond f32 reassociation")
    return rec

# ---------------------------------------------------------------------------
# serving (slice 2)
# ---------------------------------------------------------------------------
def attention_work(B, Sq, Sk, H, Hkv, d, causal, window, itemsize):
    """(bytes, flops) the attention function needs at these shapes: q, k,
    v read once and o written once; 4 flops per kept query-key pair per
    head dimension (q.k and p.v), counting the pairs this mask keeps."""
    pos = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(pos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(Sq)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    nbytes = (2 * B * Sq * H * d + 2 * B * Sk * Hkv * d) * itemsize
    return nbytes, 4 * d * pairs * B * H


def phase_lm_kernels(gen) -> dict:
    """rmsnorm, flash_attention(_gqa) and swa_attention against their plain
    versions on the card, f32 and bf16, bitwise equal across two
    launches, attention also at the edges of its bf16 program
    (``ATTN_EDGES``); then timed at the serving path's shapes in bf16,
    and flash_attention also in f32 (the CUDA-core program), beside the
    plain version and one PyTorch call that the port never makes. Each
    attention check and time names the program that ran."""
    checks = []
    # the largest error of each kernel, over both dtypes and by dtype
    worst = {k: 0.0 for k in ("rmsnorm", "flash_attention", "swa_attention",
                              "flash_attention f32")}

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def check(name, kind, kernel, plain, args, kw, label):
        a, b = kernel(*args, **kw), kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((a.float() - want.float()).abs().max())
        worst[name] = max(worst[name], err)
        if name == "flash_attention" and args[0].dtype == torch.float32:
            worst[name + " f32"] = max(worst[name + " f32"], err)
        repeat = bool(torch.equal(a, b))
        ok = repeat and bool(torch.allclose(
            a.float(), want.float(), **LM_TOL[kind, args[0].dtype]))
        checks.append({"kernel": name, "inputs": label,
                       "dtype": str(args[0].dtype).split(".")[1],
                       "max_abs_err": err, "bitwise_repeat": repeat,
                       "ok": ok})
        if kind == "attention":
            checks[-1]["program"] = flash_attention.program(args[0].dtype)
        if not ok:
            emit({"phase": "lm_kernels", "failed": checks[-1]})
            raise SystemExit(f"kernel {name} disagrees: {checks[-1]}")

    def norm(shape, dt, label=None):
        x, s = randn(shape, dt), randn(shape[-1:], dt)
        check("rmsnorm", "rmsnorm", rmsnorm.rmsnorm, ref.rmsnorm_ref,
              (x, s, 1e-5), {}, label or list(shape))
        return x, s

    def attn(B, Sq, Sk, H, Hkv, d, causal, window, dt, label=None):
        q, k, v = (randn((B, Sq, H, d), dt), randn((B, Sk, Hkv, d), dt),
                   randn((B, Sk, Hkv, d), dt))
        kw = dict(causal=causal, window=window)
        check("flash_attention", "attention",
              flash_attention.flash_attention_gqa,
              ref.flash_attention_gqa_ref, (q, k, v), kw,
              label or [B, Sq, Sk, H, Hkv, d, causal, window])
        return q, k, v

    def swa(B, S, H, Hkv, d, w, dt, label=None):
        q, k, v = (randn((B, S, H, d), dt), randn((B, S, Hkv, d), dt),
                   randn((B, S, Hkv, d), dt))
        check("swa_attention", "attention", swa_attention.swa_attention,
              ref.swa_attention_ref, (q, k, v), dict(window=w),
              label or [B, S, H, Hkv, d, w])
        if not torch.equal(
                swa_attention.swa_attention(q, k, v, window=w),
                flash_attention.flash_attention_gqa(q, k, v, causal=True,
                                                    window=w)):
            raise SystemExit("swa_attention differs from flash_attention "
                             "with the same window")
        return q, k, v

    for dt in (torch.float32, torch.bfloat16):
        for shape in [(1, 8), (130, 32), (3, 5, 256), (7, 4096),
                      (2, 7, 14_000)]:
            norm(shape, dt)
        for case in [(2, 64, 64, 1, 1, 32, True, 0),
                     (2, 100, 100, 4, 2, 64, True, 0),
                     (1, 24, 130, 8, 2, 128, True, 0),
                     (2, 96, 96, 4, 1, 128, True, 24),
                     (1, 40, 70, 2, 2, 32, False, 0),       # ROADMAP C1
                     (1, 70, 70, 2, 1, 64, False, 16),
                     *ATTN_EDGES]:
            attn(*case, dt)
        for case in [(2, 64, 1, 1, 32, 16), (1, 256, 4, 2, 128, 64),
                     (1, 1024, 8, 2, 128, 256)]:
            swa(*case, dt)

    # the serving path's own tensors, bf16: checked, then timed
    bf = torch.bfloat16
    mem_rate, f32_rate, bf16_rate = peaks(torch.cuda.get_device_name(0))
    D, H, Hkv, hd, w = 4096, 32, 8, 128, 8192
    x, s = norm((SERVE_B, SERVE_S, D), bf, "serve (4, 2048, 4096)")
    q, k, v = attn(SERVE_B, SERVE_S, SERVE_S, H, Hkv, hd, True, 0, bf,
                   "serve prefill (4, 2048, 32/8, 128)")
    qs, ks, vs = swa(SWA_B, SWA_S, H, Hkv, hd, w, bf,
                     "swa prefill (1, 16384, 32/8, 128), w 8192")
    f32 = torch.float32
    qf, kf, vf = attn(SERVE_B, SERVE_S, SERVE_S, H, Hkv, hd, True, 0, f32,
                      "serve prefill shape in f32 (4, 2048, 32/8, 128)")
    # one PyTorch call each, as yardsticks: (B, H, S, d) layouts and, for
    # the band, kv heads expanded and a boolean mask, made before timing
    qT, kT, vT = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    qsT = qs.transpose(1, 2).contiguous()
    ksT, vsT = (t.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                .contiguous() for t in (ks, vs))
    i = torch.arange(SWA_S, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)

    def swa_library():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qsT, ksT, vsT,
                                                  attn_mask=band)

    n_norm = x.numel()
    norm_bytes = 2 * n_norm * 2 + D * 2
    f_bytes, f_ops = attention_work(SERVE_B, SERVE_S, SERVE_S, H, Hkv, hd,
                                    True, 0, 2)
    s_bytes, s_ops = attention_work(SWA_B, SWA_S, SWA_S, H, Hkv, hd, True,
                                    w, 2)
    timed = {
        "rmsnorm": (
            [SERVE_B, SERVE_S, D], norm_bytes, 4 * n_norm, f32_rate, 20,
            lambda: rmsnorm.rmsnorm(x, s, 1e-5),
            lambda: ref.rmsnorm_ref(x, s, 1e-5),
            lambda: F.rms_norm(x, (D,), weight=s, eps=1e-5),
            "F.rms_norm"),
        "flash_attention": (
            [SERVE_B, SERVE_S, H, Hkv, hd], f_bytes, f_ops, bf16_rate, 5,
            lambda: flash_attention.flash_attention_gqa(q, k, v),
            lambda: ref.flash_attention_gqa_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(
                qT, kT, vT, is_causal=True, enable_gqa=True),
            "F.scaled_dot_product_attention(is_causal=True, "
            "enable_gqa=True)"),
        "swa_attention": (
            [SWA_B, SWA_S, H, Hkv, hd, w], s_bytes, s_ops, bf16_rate, 3,
            lambda: swa_attention.swa_attention(qs, ks, vs, window=w),
            lambda: ref.swa_attention_ref(qs, ks, vs, window=w),
            swa_library,
            "F.scaled_dot_product_attention(attn_mask=band), efficient "
            "backend, kv heads expanded"),
    }
    # the f32 program at the same shape: its bound is the f32 rate of the
    # CUDA cores (the tensor cores take f32 only as TF32)
    qfT, kfT, vfT = (t.transpose(1, 2).contiguous() for t in (qf, kf, vf))
    timed["flash_attention f32"] = (
        [SERVE_B, SERVE_S, H, Hkv, hd], 2 * f_bytes, f_ops, f32_rate, 3,
        lambda: flash_attention.flash_attention_gqa(qf, kf, vf),
        lambda: ref.flash_attention_gqa_ref(qf, kf, vf),
        lambda: F.scaled_dot_product_attention(
            qfT, kfT, vfT, is_causal=True, enable_gqa=True),
        "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True), "
        "f32")
    table = {}
    for name, (shape, nbytes, nops, rate, iters, kernel, plain, library,
               lib_name) in timed.items():
        t_bytes, t_ops = nbytes / mem_rate * 1e3, nops / rate * 1e3
        dt = f32 if name.endswith("f32") else bf
        table[name] = {
            "shape": shape, "dtype": str(dt).split(".")[1],
            "max_abs_err": worst[name],
            "ms": cuda_ms(kernel, iters, 1),
            "plain_ms": cuda_ms(plain, iters, 1),
            "library_ms": cuda_ms(library, iters, 1),
            "library": lib_name,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": nops}
        if name != "rmsnorm":
            table[name]["program"] = flash_attention.program(dt)
    table["flash_attention"]["f32"] = table.pop("flash_attention f32")
    emit({"phase": "lm_kernels", "checks": len(checks),
          "all_ok": all(c["ok"] for c in checks),
          "tolerances": {f"{k[0]} {str(k[1]).split('.')[1]}": v
                         for k, v in LM_TOL.items()},
          "timed": table,
          "peaks": {"bytes_per_s": mem_rate, "f32_flops": f32_rate,
                    "bf16_flops": bf16_rate}})
    return table


def phase_lm_agree() -> dict:
    """The llama3-8b and llama3-8b-swa smoke configs in f32, from the same
    numpy weights, on the CPU and on the card: prefill logits within
    AGREE_TOL, and a ServeEngine's 16 greedy tokens identical. The swa
    prompts take the banded path (S = 2w) and the masked one (S < 2w)."""
    out = {}
    for name, cases in (("llama3-8b", [(24, "flash_attention")]),
                        ("llama3-8b-swa", [(32, "swa_attention"),
                                           (24, "flash_attention")])):
        cfg = get_arch(name, smoke=True)
        weights = params_to_numpy(init_lm_params(cfg, seed=5, device="cpu"))
        params = {dev: params_from_numpy(weights, device=dev)
                  for dev in ("cpu", "cuda")}
        rng = np.random.default_rng(6)
        rec = {}
        for S, path in cases:
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
            want = make_prefill(cfg)(params["cpu"], toks)
            ops.reset_launches()
            got = make_prefill(cfg)(params["cuda"], toks.cuda())
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            err = float((got.cpu() - want).abs().max())
            rec[f"prefill S={S}"] = {"max_abs_err": err,
                                     "launches": launches}
            if launches[path] != cfg.num_layers or launches["rmsnorm"] != (
                    2 * cfg.num_layers + 1):
                raise SystemExit(f"{name} S={S}: the card's prefill did not "
                                 f"take the {path} path: {launches}")
            if not torch.allclose(got.cpu(), want, **AGREE_TOL):
                raise SystemExit(f"{name} S={S}: the card's prefill logits "
                                 f"differ from the CPU's by {err}")
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 5)))
        tokens = {}
        for dev in ("cpu", "cuda"):
            eng = ServeEngine(cfg, params[dev], max_seq=32, batch=2,
                              device=dev)
            logits = eng.feed(prompt)
            tokens[dev] = eng.generate(16, first_logits=logits).cpu()
        rec["greedy_tokens_equal"] = bool(torch.equal(tokens["cpu"],
                                                      tokens["cuda"]))
        out[name] = rec
        if not rec["greedy_tokens_equal"]:
            raise SystemExit(f"{name}: greedy tokens differ on the card: "
                             f"{tokens}")
    emit({"phase": "lm_agree", "tolerance": AGREE_TOL, "configs": out})
    return out


def _timed(fn):
    """(result, ms by CUDA events, wall s) of ``fn()``, synchronized."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), time.perf_counter() - t0


def _prompt_gap(engine_logits, prefill_logits):
    """max |diff| / max |logit|, and whether every greedy pick agrees or
    is a near tie (the engine's pick within twice that difference of the
    prefill's maximum)."""
    e, p = engine_logits.float(), prefill_logits.float()
    diff = (e - p).abs().max()
    pick_e, pick_p = e.argmax(-1), p.argmax(-1)
    gap = p.max(-1).values - p.gather(1, pick_e[:, None])[:, 0]
    return {"rel": float(diff / p.abs().max()), "max_abs_diff": float(diff),
            "argmax_agree": f"{int((pick_e == pick_p).sum())}/{len(p)}",
            "picks_ok": bool((gap <= 2 * diff).all()),
            "pick_gaps": gap.tolist()}


def phase_serve() -> dict:
    """The serving path at full width and depth, bf16, weights drawn on the
    card: llama3-8b prefill at (4, 2048), a batch-4 engine feeding 32
    prompt tokens and generating 32, then the llama3-8b-swa prefill at
    (1, 16384) over the same weights (the same backbone)."""
    cfg, cfg_swa = get_arch("llama3-8b"), get_arch("llama3-8b-swa")
    L, bf = cfg.num_layers, torch.bfloat16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms, _ = _timed(lambda: init_lm_params(cfg, seed=0, dtype=bf,
                                                       device="cuda"))
    n_params = sum(t.numel() for t in tree_leaves(params))
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    if n_params != cfg.param_count() + cfg.d_model:     # + final_norm
        raise SystemExit(f"llama3-8b has {n_params} weights, not "
                         f"{cfg.param_count() + cfg.d_model}")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                           generator=g, device="cuda")
    prefill = make_prefill(cfg)
    prefill(params, tokens[:, :128])                    # warm-up
    launches = {}

    ops.reset_launches()
    logits, prefill_ms, _ = _timed(lambda: prefill(params, tokens))
    launches["prefill"] = dict(ops.LAUNCHES)
    if tuple(logits.shape) != (SERVE_B, SERVE_S, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise SystemExit(f"prefill logits {tuple(logits.shape)} are not "
                         f"finite or not of the expected shape")
    at_prompt = logits[:, PROMPT - 1].float()
    head_2k = logits[0].clone()
    del logits
    torch.cuda.synchronize()

    eng = ServeEngine(cfg, params, max_seq=PROMPT + GEN + 1, batch=SERVE_B,
                      dtype=bf, device="cuda")
    ops.reset_launches()
    first, feed_ms, _ = _timed(lambda: eng.feed(tokens[:, :PROMPT]))
    launches["feed"] = dict(ops.LAUNCHES)
    ops.reset_launches()
    generated, gen_ms, gen_wall = _timed(
        lambda: eng.generate(GEN, first_logits=first))
    launches["generate"] = dict(ops.LAUNCHES)
    main_launches = {k: launches["prefill"][k] + launches["feed"][k]
                     + launches["generate"][k] for k in ops.LAUNCHES}

    # the engine's logits at the last prompt position against the
    # prefill's: bf16 through 32 layers, and the decode attention (plain
    # _sdpa) rounds scores and probabilities to bf16 where the prefill
    # kernel keeps them in f32
    gap = _prompt_gap(first, at_prompt)
    del eng, first

    if (launches["prefill"]["flash_attention"] != L
            or launches["prefill"]["rmsnorm"] != 2 * L + 1
            or launches["feed"]["rmsnorm"] != PROMPT * (2 * L + 1)
            or launches["generate"]["rmsnorm"] != GEN * (2 * L + 1)
            or launches["feed"]["flash_attention"]
            or launches["generate"]["flash_attention"]):
        raise SystemExit(f"serving launches: {launches}")
    if gap["rel"] > SERVE_REL_TOL or not gap["picks_ok"]:
        raise SystemExit(f"the engine's prompt logits differ from the "
                         f"prefill's: {gap}")
    if tuple(generated.shape) != (SERVE_B, GEN) or not bool(
            ((generated >= 0) & (generated < cfg.vocab_size)).all()):
        raise SystemExit(f"generated {tuple(generated.shape)} tokens out of "
                         f"range")

    # the sliding-window variant over the same weights, through the band
    swa_tokens = torch.randint(0, cfg.vocab_size, (SWA_B, SWA_S),
                               generator=g, device="cuda")
    swa_tokens[0, :SERVE_S] = tokens[0]
    ops.reset_launches()
    swa_logits, swa_ms, _ = _timed(
        lambda: make_prefill(cfg_swa)(params, swa_tokens))
    launches["swa_prefill"] = dict(ops.LAUNCHES)
    if (launches["swa_prefill"]["swa_attention"] != L
            or launches["swa_prefill"]["flash_attention"]
            or launches["swa_prefill"]["rmsnorm"] != 2 * L + 1):
        raise SystemExit(f"swa prefill launches: {launches['swa_prefill']}")
    if tuple(swa_logits.shape) != (SWA_B, SWA_S, cfg.vocab_size) or not bool(
            torch.isfinite(swa_logits).all()):
        raise SystemExit("swa prefill logits are not finite or not of the "
                         "expected shape")
    # below the window the band keeps every earlier key, so the first
    # 2,048 positions must repeat the full-attention prefill of the same
    # tokens (bf16, other matmul shapes)
    swa_rel = float((swa_logits[0, :SERVE_S].float() - head_2k.float())
                    .abs().max() / head_2k.float().abs().max())
    if swa_rel > SERVE_REL_TOL:
        raise SystemExit(f"swa prefill below the window differs from the "
                         f"full prefill: rel {swa_rel}")
    del swa_logits, head_2k
    peak = torch.cuda.max_memory_allocated()
    rec = {"phase": "serve", "arch": cfg.name, "layers": L, "cut": None,
           "dtype": "bfloat16",
           "params": n_params, "weights_bytes": weight_bytes,
           "init_ms": init_ms,
           "prefill": {"batch": SERVE_B, "seq": SERVE_S, "ms": prefill_ms,
                       "tokens_per_s": SERVE_B * SERVE_S / prefill_ms * 1e3},
           "engine": {"batch": SERVE_B, "prompt": PROMPT, "generated": GEN,
                      "feed_ms_per_step": feed_ms / PROMPT,
                      "decode_ms_per_step": gen_ms / GEN,
                      "decode_wall_s": gen_wall,
                      "step_bytes_bound_ms": weight_bytes / peaks(
                          torch.cuda.get_device_name(0))[0] * 1e3,
                      "prompt_logits": {**gap,
                                        "tolerance_rel": SERVE_REL_TOL}},
           "swa_prefill": {"arch": cfg_swa.name, "batch": SWA_B,
                           "seq": SWA_S, "window": cfg_swa.sliding_window,
                           "ms": swa_ms,
                           "tokens_per_s": SWA_B * SWA_S / swa_ms * 1e3,
                           "below_window_rel_err": swa_rel},
           "peak_memory_bytes": peak, "launches": launches}
    emit(rec)
    del params
    torch.cuda.empty_cache()
    return {"main": main_launches, "swa": launches["swa_prefill"]}


# ---------------------------------------------------------------------------
# Mamba2 serving (slice 3)
# ---------------------------------------------------------------------------
def ssd_work(BH, S, P, N, bc_rows, chunk, itemsize):
    """(bytes, flops) of the SSD at these shapes: x, dt, b, c read once
    (b and c as the kernel reads them, ``bc_rows`` rows), a read, y and
    the f32 state written once; the flops are the fewer of the two forms
    that compute it. The chunked form needs, per chunk of Q steps, the
    causal triangle of C B^T and of the diagonal product, Q (Q + 1) N and
    Q (Q + 1) P, then 2 Q N P for C h^T and 2 Q P N for the state update;
    the sequential recurrence needs 5 P N per step (decay, the dt x b^T
    outer product and its add, then C h)."""
    nbytes = ((2 * BH * S * P + BH * S + 2 * bc_rows * S * N) * itemsize
              + 4 * BH + 4 * BH * P * N)
    chunked = (chunk * (chunk + 1) * (N + P) + 4 * chunk * N * P) * (
        S // chunk)
    return nbytes, min(chunked, 5 * P * N * S) * BH


def phase_ssm_kernels(gen) -> tuple:
    """ssd_scan against the sequential plain version on the card, in f32
    and bf16, bitwise equal across two launches; then the serving path's
    own tensor (B = 4, H = 80, S = 2,048, P = 64, N = 128, chunk 64, f32,
    one group), checked and timed beside its bound and the plain
    version. No single PyTorch call computes the SSD, so there is no
    library yardstick. Also rmsnorm against its plain version at the
    shapes mamba2-2.7b gives it (rows of d_model 2560 and d_inner 5120,
    in prefill and in decode)."""
    checks = []
    worst = 0.0
    norm_worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in [(SERVE_B, SERVE_S, 2560), (SERVE_B, SERVE_S, 5120),
                      (SERVE_B, 2560), (SERVE_B, 5120)]:
            xn = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            sn = torch.randn(shape[-1:], generator=gen,
                             device="cuda").to(dtype)
            n1 = rmsnorm.rmsnorm(xn, sn, 1e-5)
            n2 = rmsnorm.rmsnorm(xn, sn, 1e-5)
            want = ref.rmsnorm_ref(xn, sn, 1e-5)
            torch.cuda.synchronize()
            err = float((n1.float() - want.float()).abs().max())
            norm_worst = max(norm_worst, err)
            repeat = bool(torch.equal(n1, n2))
            ok = repeat and bool(torch.allclose(
                n1.float(), want.float(), **LM_TOL["rmsnorm", dtype]))
            checks.append({"kernel": "rmsnorm", "inputs": list(shape),
                           "dtype": str(dtype).split(".")[1],
                           "max_abs_err": err, "max_abs_ref": float(
                               want.float().abs().max()),
                           "bitwise_repeat": repeat, "finite": True,
                           "ok": ok})
            if not ok:
                emit({"phase": "ssm_kernels", "failed": checks[-1]})
                raise SystemExit(f"kernel rmsnorm disagrees: {checks[-1]}")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def check(BH, S, P, N, chunk, dtype, R=1, strong=False, label=None):
        nonlocal worst
        x, dt, a = randn(BH, S, P), F.softplus(randn(BH, S)), -torch.exp(
            randn(BH))
        if strong:      # dt * |a| in the hundreds: the decays underflow,
            dt, a = dt * 30 + 5, a * 20     # exp above the diagonal overflows
        b, c = randn(BH // R, S, N), randn(BH // R, S, N)
        x, dt, b, c = (t.to(dtype) for t in (x, dt, b, c))
        y1, h1 = ops.ssd_scan(x, dt, a, b, c, chunk=chunk)
        y2, h2 = ops.ssd_scan(x, dt, a, b, c, chunk=chunk)
        yr, hr = ref.ssd_scan_ref(x, dt, a, b.repeat_interleave(R, 0),
                                  c.repeat_interleave(R, 0))
        torch.cuda.synchronize()
        err = max(float((y1.float() - yr.float()).abs().max()),
                  float((h1 - hr).abs().max()))
        worst = max(worst, err)
        repeat = bool(torch.equal(y1, y2) and torch.equal(h1, h2))
        finite = bool(torch.isfinite(y1.float()).all()
                      and torch.isfinite(h1).all())
        ok = repeat and finite and bool(
            torch.allclose(y1.float(), yr.float(), **SSM_TOL[dtype])
            and torch.allclose(h1, hr, **SSM_TOL[dtype]))
        checks.append({"kernel": "ssd_scan",
                       "inputs": label or [BH, S, P, N, chunk, R, strong],
                       "dtype": str(dtype).split(".")[1],
                       "max_abs_err": err, "max_abs_ref": float(
                           yr.float().abs().max()),
                       "bitwise_repeat": repeat, "finite": finite, "ok": ok})
        if not ok:
            emit({"phase": "ssm_kernels", "failed": checks[-1]})
            raise SystemExit(f"kernel ssd_scan disagrees: {checks[-1]}")
        return x, dt, a, b, c

    for dtype in (torch.float32, torch.bfloat16):
        for S, chunk in [(64, 16), (96, 32), (100, 32), (8, 8), (130, 64),
                         (37, 8)]:              # tests/test_kernels.py:167
            check(3, S, 8, 4, chunk, dtype)
        check(4, 200, 64, 128, 64, dtype)
        check(6, 77, 64, 32, 16, dtype)         # the smoke config's N, chunk
        check(16, 96, 64, 128, 64, dtype, R=8)  # grouped B and C
        check(5, 128, 64, 128, 64, dtype, strong=True)
        check(4, 100, 64, 128, 32, dtype, R=2, strong=True)

    # the serving path's own tensor, as mamba_forward hands it over
    BH, S, P, N, Q, R = SERVE_B * 80, SERVE_S, 64, 128, 64, 80
    x, dt, a, b, c = check(BH, S, P, N, Q, torch.float32, R=R,
                           label="serve (320, 2048, 64, 128), chunk 64, "
                                 "80 heads per group")
    br, cr = b.repeat_interleave(R, 0), c.repeat_interleave(R, 0)
    mem_rate, f32_rate, _ = peaks(torch.cuda.get_device_name(0))
    nbytes, nops = ssd_work(BH, S, P, N, BH // R, Q, 4)
    t_bytes, t_ops = nbytes / mem_rate * 1e3, nops / f32_rate * 1e3
    table = {"ssd_scan": {
        "shape": [BH, S, P, N, Q, R], "dtype": "float32",
        "max_abs_err": worst,
        "ms": cuda_ms(lambda: ssd_scan.ssd_scan(x, dt, a, b, c, chunk=Q),
                      10, 2),
        "plain_ms": cuda_ms(lambda: ref.ssd_scan_ref(x, dt, a, br, cr), 2, 1),
        "library_ms": None,
        "library": "none: no single PyTorch call computes the chunked SSD",
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "ops": nops}}
    emit({"phase": "ssm_kernels", "checks": len(checks),
          "rmsnorm_max_abs_err": norm_worst,
          "rmsnorm_tolerances": {str(k[1]).split(".")[1]: v
                                 for k, v in LM_TOL.items()
                                 if k[0] == "rmsnorm"},
          "all_ok": all(c["ok"] for c in checks),
          "tolerances": {str(k).split(".")[1]: v for k, v in SSM_TOL.items()},
          "worst": [{k: c[k] for k in ("kernel", "inputs", "dtype",
                                       "max_abs_err", "max_abs_ref")}
                    for c in sorted(checks, key=lambda c: -c["max_abs_err"])
                    [:3]],
          "timed": table,
          "peaks": {"bytes_per_s": mem_rate, "f32_flops": f32_rate}})
    return table, norm_worst


def phase_ssm_agree() -> dict:
    """The mamba2-2.7b smoke config in f32, from the same numpy weights, on
    the CPU (the sequential plain SSD) and on the card (the chunked
    kernel): prefill logits within AGREE_TOL at a ragged and a whole-chunk
    S, and a ServeEngine's 16 greedy tokens identical."""
    cfg = get_arch("mamba2-2.7b", smoke=True)
    L = cfg.num_layers
    weights = params_to_numpy(init_lm_params(cfg, seed=5, device="cpu"))
    params = {dev: params_from_numpy(weights, device=dev)
              for dev in ("cpu", "cuda")}
    rng = np.random.default_rng(7)
    rec = {}
    for S in (40, 64):                  # 40 % 16 != 0: ops.ssd_scan pads
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
        want = make_prefill(cfg)(params["cpu"], toks)
        ops.reset_launches()
        got = make_prefill(cfg)(params["cuda"], toks.cuda())
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        err = float((got.cpu() - want).abs().max())
        rec[f"prefill S={S}"] = {"max_abs_err": err, "launches": launches}
        if launches["ssd_scan"] != L or launches["rmsnorm"] != 2 * L + 1:
            raise SystemExit(f"mamba S={S}: the card's prefill did not take "
                             f"the ssd_scan path: {launches}")
        if not torch.allclose(got.cpu(), want, **AGREE_TOL):
            raise SystemExit(f"mamba S={S}: the card's prefill logits differ "
                             f"from the CPU's by {err}")
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 5)))
    tokens = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params[dev], max_seq=32, batch=2, device=dev)
        logits = eng.feed(prompt)
        tokens[dev] = eng.generate(16, first_logits=logits).cpu()
    rec["greedy_tokens_equal"] = bool(torch.equal(tokens["cpu"],
                                                  tokens["cuda"]))
    emit({"phase": "ssm_agree", "arch": cfg.name, "tolerance": AGREE_TOL,
          **rec})
    if not rec["greedy_tokens_equal"]:
        raise SystemExit(f"mamba: greedy tokens differ on the card: {tokens}")
    return rec


def phase_ssm_serve() -> dict:
    """mamba2-2.7b at full width and depth, weights drawn on the card in
    bf16: first, the same weights in f32, the engine's logits after a
    32-token prompt (the O(1) recurrence) against the prefill's at that
    position (the chunked kernel); then, in bf16, the prefill at
    (4, 2048), a batch-4 engine feeding the 32 prompt tokens and
    generating 32, and the same comparison."""
    cfg = get_arch("mamba2-2.7b")
    L, bf = cfg.num_layers, torch.bfloat16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms, _ = _timed(lambda: init_lm_params(cfg, seed=0, dtype=bf,
                                                       device="cuda"))
    n_params = sum(t.numel() for t in tree_leaves(params))
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    if n_params != cfg.param_count() + SSM_TREE_EXTRA:
        raise SystemExit(f"mamba2-2.7b has {n_params} weights, not "
                         f"{cfg.param_count() + SSM_TREE_EXTRA}")
    g = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                           generator=g, device="cuda")
    prefill = make_prefill(cfg)

    # f32 at full width: the recurrence against the kernel, and the f32
    # logits that the bf16 paths are then measured against
    params32 = tree_map(lambda t: t.float(), params)
    want32 = prefill(params32, tokens[:, :PROMPT])[:, -1]
    eng32 = ServeEngine(cfg, params32, max_seq=PROMPT, batch=SERVE_B,
                        device="cuda")
    f32_gap = _prompt_gap(eng32.feed(tokens[:, :PROMPT]), want32)
    del params32, eng32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()    # the peak of bf16 serving alone
    if f32_gap["rel"] > SSM_F32_REL_TOL or not f32_gap["picks_ok"]:
        raise SystemExit(f"f32 mamba2-2.7b: the engine's prompt logits differ "
                         f"from the prefill's: {f32_gap}")

    prefill(params, tokens[:, :128])                    # warm-up
    launches = {}

    ops.reset_launches()
    logits, prefill_ms, _ = _timed(lambda: prefill(params, tokens))
    launches["prefill"] = dict(ops.LAUNCHES)
    if tuple(logits.shape) != (SERVE_B, SERVE_S, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise SystemExit(f"mamba prefill logits {tuple(logits.shape)} are not "
                         f"finite or not of the expected shape")
    at_prompt = logits[:, PROMPT - 1].float()
    del logits
    torch.cuda.synchronize()

    eng = ServeEngine(cfg, params, max_seq=PROMPT + GEN + 1, batch=SERVE_B,
                      dtype=bf, device="cuda")
    ops.reset_launches()
    first, feed_ms, _ = _timed(lambda: eng.feed(tokens[:, :PROMPT]))
    launches["feed"] = dict(ops.LAUNCHES)
    ops.reset_launches()
    generated, gen_ms, gen_wall = _timed(
        lambda: eng.generate(GEN, first_logits=first))
    launches["generate"] = dict(ops.LAUNCHES)
    main_launches = {k: launches["prefill"][k] + launches["feed"][k]
                     + launches["generate"][k] for k in ops.LAUNCHES}
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(eng.cache))

    # the engine's logits after the prompt (recurrence) against the
    # prefill's at the same position (chunked kernel), and each against f32
    bf16_gap = _prompt_gap(first, at_prompt)
    vs_f32 = {"prefill": _prompt_gap(at_prompt, want32)["rel"],
              "engine": _prompt_gap(first, want32)["rel"]}
    del eng, first
    peak = torch.cuda.max_memory_allocated()
    mem_rate = peaks(torch.cuda.get_device_name(0))[0]
    rec = {"phase": "ssm_serve", "arch": cfg.name, "layers": L,
           "d_model": cfg.d_model, "cut": None, "dtype": "bfloat16",
           "params": n_params, "param_count": cfg.param_count(),
           "weights_bytes": weight_bytes, "init_ms": init_ms,
           "f32_prompt_logits": {**f32_gap, "tolerance_rel": SSM_F32_REL_TOL},
           "prefill": {"batch": SERVE_B, "seq": SERVE_S, "ms": prefill_ms,
                       "tokens_per_s": SERVE_B * SERVE_S / prefill_ms * 1e3},
           "engine": {"batch": SERVE_B, "prompt": PROMPT, "generated": GEN,
                      "feed_ms_per_step": feed_ms / PROMPT,
                      "decode_ms_per_step": gen_ms / GEN,
                      "decode_wall_s": gen_wall,
                      "state_bytes": state_bytes,
                      "step_bytes_bound_ms": (weight_bytes + 2 * state_bytes)
                      / mem_rate * 1e3,
                      "prompt_logits": {**bf16_gap,
                                        "tolerance_rel": SSM_SERVE_REL_TOL},
                      "rel_to_f32_logits": vs_f32},
           "peak_memory_bytes": peak, "launches": launches}
    emit(rec)

    if (launches["prefill"]["ssd_scan"] != L
            or launches["prefill"]["rmsnorm"] != 2 * L + 1
            or launches["feed"]["ssd_scan"]
            or launches["generate"]["ssd_scan"]
            or launches["feed"]["rmsnorm"] != PROMPT * (2 * L + 1)
            or launches["generate"]["rmsnorm"] != GEN * (2 * L + 1)):
        raise SystemExit(f"mamba serving launches: {launches}")
    if bf16_gap["rel"] > SSM_SERVE_REL_TOL or not bf16_gap["picks_ok"]:
        raise SystemExit(f"the mamba engine's prompt logits differ from the "
                         f"prefill's: {bf16_gap}")
    if tuple(generated.shape) != (SERVE_B, GEN) or not bool(
            ((generated >= 0) & (generated < cfg.vocab_size)).all()):
        raise SystemExit(f"mamba generated {tuple(generated.shape)} tokens "
                         f"out of range")
    del params
    torch.cuda.empty_cache()
    return main_launches


def main() -> None:
    seconds = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    env = run("env", phase_env)
    run("build", phase_build)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    table = run("kernels", phase_kernels, gen)
    run("agree", phase_agree)
    launches = run("train", phase_train)
    torch.cuda.empty_cache()
    lm_table = run("lm_kernels", phase_lm_kernels, gen)
    run("lm_agree", phase_lm_agree)
    serve = run("serve", phase_serve)
    ssm_table, ssm_norm_err = run("ssm_kernels", phase_ssm_kernels, gen)
    run("ssm_agree", phase_ssm_agree)
    ssm = run("ssm_serve", phase_ssm_serve)
    emit({"phase_seconds": seconds, "total_seconds": sum(seconds.values())})
    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        {"name": "sqdist_rows", "route": "cuda", "source": csrc + "sqdist.cu",
         "replaces": "src/repro/kernels/sqdist.py:81",
         "launches": launches["sqdist_rows"], **table["sqdist_rows"]},
        {"name": "sqdist", "route": "cuda", "source": csrc + "sqdist.cu",
         "replaces": "src/repro/kernels/sqdist.py:41",
         "launches": launches["sqdist"], **table["sqdist"]},
        {"name": "rmsnorm", "route": "cuda", "source": csrc + "rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:25",
         "launches": serve["main"]["rmsnorm"] + ssm["rmsnorm"],
         "launches_by_path": {"llama3-8b serve": serve["main"]["rmsnorm"],
                              "mamba2-2.7b serve": ssm["rmsnorm"]},
         **lm_table["rmsnorm"], "max_abs_err": max(
             lm_table["rmsnorm"]["max_abs_err"], ssm_norm_err)},
        {"name": "flash_attention", "route": "cuda",
         "source": csrc + "attention_sm90.cu",
         "sources_by_dtype": {"bfloat16": csrc + "attention_sm90.cu",
                              "float32": csrc + "attention.cu"},
         "replaces": "src/repro/kernels/flash_attention.py:77",
         "launches": serve["main"]["flash_attention"],
         **lm_table["flash_attention"]},
        {"name": "swa_attention", "route": "cuda",
         "source": csrc + "attention_sm90.cu",
         "sources_by_dtype": {"bfloat16": csrc + "attention_sm90.cu",
                              "float32": csrc + "attention.cu"},
         "replaces": "src/repro/kernels/swa_attention.py:64",
         "launches": serve["swa"]["swa_attention"],
         **lm_table["swa_attention"]},
        {"name": "ssd_scan", "route": "cuda", "source": csrc + "ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:74",
         "launches": ssm["ssd_scan"], **ssm_table["ssd_scan"]},
    ]
    emit({"kernels": kernels})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
