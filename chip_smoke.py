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
  count is 0. Both are one CUDA launch per call (slice 5), which the
  profiler checks, and each is timed for the device alone beside the
  host-bound back-to-back time.
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
* Mamba2 serving (slice 3; the ``ssd_scan`` program redesigned for the
  tensor cores in slice 5, three launches per call): holds the
  ``ssd_scan`` kernel against the
  sequential plain version on the card (small and ragged S, chunks 8 to
  64, f32 and bf16, strong decay, grouped B and C, odd P and N, bitwise
  repeats, then the serving tensor, timed beside the bytes / TF32 bound,
  with its launches per call and each launch's device time from the
  profiler), checks that the mamba2-2.7b smoke config
  gives the CPU's logits and greedy tokens on the card, then serves
  mamba2-2.7b at full width and depth in bf16 (prefill at B = 4,
  S = 2,048; a batch-4 ``ServeEngine`` feeding 32 prompt tokens and
  generating 32), counting launches, and holds the engine's logits from
  the O(1) recurrence against the prefill's from the chunked kernel.

* the paper's other experiments (slice 6): trains the deep-driving
  PilotNet at full width (348,219 weights, 68x320x3 frames drawn on the
  card, m = 100, B = 10) through ``run_drift_segments`` with drifts at
  rounds 20 and 40, under periodic and dynamic averaging, then FedAvg,
  the random balancing augmentation from a heterogeneous init and the
  serial baseline on the MNIST CNN; each run's ``sqdist_rows`` count is
  exact (30 for the deep-driving dynamic run, 6 for the random one, 0
  otherwise), and ``kernels`` holds ``sqdist_rows`` at (100, 348,219),
  odd P, against its plain version. ``paper_agree`` runs FedAvg, the
  random augmentation, a heterogeneous init and drift=True on the card
  and on the CPU from the same model and batches (identical comm, ledger,
  keys and drift rounds) and holds ``repro_torch.prng`` on the card to
  the CPU, bit for bit.
* the network environment (slice 7): ``net_train`` trains the MNIST CNN
  at full width (m = 100, B = 10) inside the simulated network through
  ``run_protocol_training(network=...)``: dynamic averaging and gossip on
  a mobile geometric overlay at 70% availability, FedAvg and periodic
  averaging on a ring at 60%, dynamic averaging under stragglers and
  outages, and dynamic averaging at full availability, which must equal
  the ``network=None`` run bit for bit; ``sqdist_rows`` runs exactly
  once per checked round of each dynamic run (6) and never otherwise.
  ``net_agree`` runs the network golden cases, a mobile gossip case and
  bounded staleness on the card and on the CPU from the same model and
  batches: comm, ledger, per-round masks, transfers and network times
  identical, parameters within 1e-5.
* checkpoints, the hierarchy and the async timeline (slice 8):
  ``kernels`` also holds the grouped ``sqdist_rows`` (every row against
  its cluster's reference row, one launch) against its plain version and
  checks that one group is the ungrouped call bit for bit; ``tier_train``
  trains the MNIST CNN at full width (m = 100, B = 10) under the
  hierarchy of 10 clusters (on an ideal network, and in the ring at 60%
  with a 2-byte backhaul) and on the event-driven timeline (dynamic
  averaging with lte exchanges 2 rounds in flight; periodic averaging at
  k = 0, which must equal the synchronous run bit for bit; aircomp),
  each with its ``sqdist_rows`` launches split by shape and matched to
  the prediction (6 grouped and 6 inter-tier launches for the
  hierarchy's dynamic run, one per gated round for the async one), then
  saves the hierarchy and the async run after round 20, restores each
  into a fresh learner and runs it on: bit for bit the uninterrupted
  run. ``tier_agree`` runs the hierarchy sweep's and the async bench's
  settings on the card and on the CPU (integers identical, parameters
  within 1e-5) and continues a card checkpoint on the CPU.
* the fault plane, robust sync and telemetry (slice 9): ``kernels`` also
  holds ``sqdist_rows`` at (100, 1,199,882) on planes with a NaN row, an
  Inf row, a -Inf row and a zeroed row (finite rows bit for bit on
  values in {-1, 0, 1}, within rtol 1e-5 on normal values; non-finite
  ones alike in kind); ``fault_train`` trains the MNIST CNN at full width
  (m = 100, B = 10) under the fault plane: dynamic (F1) and
  robust_dynamic (F2, streamed through the telemetry plane with per-link
  bytes, profiling and the divergence series) under the crash and
  sign-flip schedule of examples/faulty_fleet.py, robust_periodic (F3)
  and the median pipeline (F4) under NaN/Inf corruption, crashes,
  adversaries and bursts, and dynamic at ``FaultConfig()`` (F5), which
  must be the ``faults=None`` run bit for bit; ``sqdist_rows`` runs
  exactly 6 times a run (66 for F2: one divergence pass a round); F2's
  stream validates, holds 60 round records with the run's own fault
  counts and ends on the live counters; one trimmed mean and one median
  at (100, P) are timed against their bytes bound. ``fault_agree`` runs
  those settings, an async run and a hierarchy at the test width on the
  card and on the CPU: integers identical, finite parameters within 1e-5.

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

from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import io  # noqa: E402
from repro_torch.config import (  # noqa: E402
    AsyncConfig, FaultConfig, HierarchyConfig, NetworkConfig, ProtocolConfig,
    TelemetryConfig, TrainConfig, get_arch,
)
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.flatten import tree_leaves, tree_map  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner, SerialLearner  # noqa: E402
from repro_torch.core.sync import stages  # noqa: E402
from repro_torch.core.sync.robust import flat_median, flat_trimmed_mean  # noqa: E402
from repro_torch.core.sync.spec import ProtocolSpec, resolve_spec  # noqa: E402
from repro_torch.data.pipeline import LearnerStreams  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    DeepDriveStream, GraphicalModelStream, SyntheticMNIST,
)
from repro_torch.kernels import (  # noqa: E402
    _build, flash_attention, ops, ref, rmsnorm, sqdist, ssd_scan,
    swa_attention,
)
from repro_torch.kernels._timing import cuda_ms, profile_calls  # noqa: E402
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params  # noqa: E402
from repro_torch.models.model import init_lm_params  # noqa: E402
from repro_torch.network import availability, faults, topology  # noqa: E402
from repro_torch.serve.engine import ServeEngine, make_prefill  # noqa: E402
from repro_torch.telemetry.observatory import load_run, summarize  # noqa: E402
from repro_torch.train.loop import (  # noqa: E402
    run_drift_segments, run_protocol_training,
)

P_MNIST = 1_199_882          # mnist_cnn's weights (Table 1)
P_DEEPDRIVE = 348_219        # deepdrive_cnn's weights (Table 5, PilotNet)
M, B, ROUNDS, CHUNK, PERIOD, DELTA = 100, 10, 60, 20, 10, 0.7
TIER_G = 10                  # tier_train's clusters of 10 learners
TOL = dict(rtol=1e-5, atol=1e-6)

# published peaks (NVIDIA data sheets, dense): device-memory bytes/s,
# f32 flop/s outside the tensor cores, bf16 and TF32 tensor-core flop/s
PEAKS = {"H100 PCIe": (2.0e12, 51e12, 756e12, 378e12),
         "H100 NVL": (3.9e12, 60e12, 835e12, 418e12),
         "H100": (3.35e12, 67e12, 989e12, 495e12),
         "H200": (4.8e12, 67e12, 989e12, 495e12)}

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

    # sqdist flattens its inputs: (1, P_MNIST) is one whole mnist_cnn model;
    # P_DEEPDRIVE is odd, so every odd row of that plane starts 4 bytes off
    # an 8-byte boundary
    for m, n in [(1, 1), (17, 515), (1, P_MNIST), (7, P_MNIST),
                 (100, P_MNIST), (3, P_DEEPDRIVE), (100, P_DEEPDRIVE)]:
        for dt in (torch.float32, torch.bfloat16):
            X = torch.randn((m, n), generator=gen, device="cuda").to(dt)
            r = torch.randn((n,), generator=gen, device="cuda").to(dt)
            R = r.expand(m, n).contiguous()
            check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref,
                  (X, r), [m, n])
            check("sqdist", sqdist.sqdist, ref.sqdist_ref, (X, R), [m, n])
            del X, R

    # the grouped form (a hierarchy's intra tier): row i against its
    # cluster's reference R[i // k], g clusters of k rows, odd P included
    for g, k, n in [(2, 3, 7), (10, 10, 515), (10, 10, P_DEEPDRIVE),
                    (10, 1, P_MNIST), (4, 25, P_MNIST)]:
        for dt in (torch.float32, torch.bfloat16):
            X = torch.randn((g * k, n), generator=gen, device="cuda").to(dt)
            R = torch.randn((g, n), generator=gen, device="cuda").to(dt)
            check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref,
                  (X, R), [g * k, n, f"g={g}"])
            del X, R

    nonfinite = check_non_finite_rows(gen)

    mem_rate, f32_rate = peaks(torch.cuda.get_device_name(0))[:2]
    X = torch.randn((M, P_MNIST), generator=gen, device="cuda")
    r = torch.randn((P_MNIST,), generator=gen, device="cuda")
    x0 = X[0]
    # g = 1 is today's call, bit for bit
    if not torch.equal(sqdist.sqdist_rows(X, r[None]),
                       sqdist.sqdist_rows(X, r)):
        raise SystemExit("grouped sqdist_rows with g = 1 is not the "
                         "ungrouped call bit for bit")
    G = TIER_G
    Rg = torch.randn((G, P_MNIST), generator=gen, device="cuda")
    check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref, (X, Rg),
          f"timed X (100, P), R ({G}, P)")
    # the timed inputs themselves, checked as the shapes above
    check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref, (X, r),
          "timed X (100, P)")
    check("sqdist", sqdist.sqdist, ref.sqdist_ref, (x0, r),
          "timed x0 = X[0] (P,)")
    Xd = torch.randn((M, P_DEEPDRIVE), generator=gen, device="cuda")
    rd = torch.randn((P_DEEPDRIVE,), generator=gen, device="cuda")
    check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref, (Xd, rd),
          "timed X (100, P_DEEPDRIVE)")
    row_starts = sorted({(i * P_DEEPDRIVE * 4) % 16 for i in range(M)})
    timed = {
        "sqdist_rows": (M, P_MNIST, lambda: sqdist.sqdist_rows(X, r),
                        lambda: ref.sqdist_rows_ref(X, r),
                        lambda: torch.linalg.vector_norm(X - r, dim=1)
                        .square()),
        "sqdist": (1, P_MNIST, lambda: sqdist.sqdist(x0, r),
                   lambda: ref.sqdist_ref(x0, r),
                   lambda: torch.linalg.vector_norm(x0 - r).square()),
        "sqdist_rows_deepdrive": (
            M, P_DEEPDRIVE, lambda: sqdist.sqdist_rows(Xd, rd),
            lambda: ref.sqdist_rows_ref(Xd, rd),
            lambda: torch.linalg.vector_norm(Xd - rd, dim=1).square()),
        "sqdist_rows_grouped": (
            M, P_MNIST, lambda: sqdist.sqdist_rows(X, Rg),
            lambda: ref.sqdist_rows_ref(X, Rg),
            lambda: torch.linalg.vector_norm(
                X.view(G, M // G, P_MNIST) - Rg[:, None], dim=2).square()),
    }
    table = {}
    for name, (m, P, kernel, plain, library) in timed.items():
        refs = G if name.endswith("grouped") else 1
        nbytes = (m * P + refs * P) * 4 + 4 * m
        nops = 3 * m * P
        t_bytes, t_ops = nbytes / mem_rate * 1e3, nops / f32_rate * 1e3
        # the device alone: one launch per call (the last block of a row,
        # chosen by a ticket, sums its partials), against vector_norm's
        dev, dev_library = profile_calls(kernel), profile_calls(library)
        kernel_name = name.split("_deepdrive")[0].split("_grouped")[0]
        table[name] = {
            "shape": [m, P], "dtype": "float32",
            "max_abs_err": worst[kernel_name]["abs"],
            "max_rel_err": worst[kernel_name]["rel"], "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": nops,
            "device_ms": dev["device_ms"],
            "cuda_launches_per_call": dev["cuda_launches_per_call"],
            "library_device_ms": dev_library["device_ms"],
            "library_cuda_launches_per_call":
                dev_library["cuda_launches_per_call"]}
        if dev["cuda_launches_per_call"] != 1:
            raise SystemExit(f"{name} made {dev['cuda_launches_per_call']} "
                             f"CUDA launches per call, not 1: {dev}")
    table["sqdist_rows_deepdrive"]["row_start_bytes_mod_16"] = row_starts
    table["sqdist_rows_grouped"]["groups"] = G
    table["sqdist_rows"]["non_finite_rows"] = nonfinite
    emit({"phase": "kernels", "checks": len(checks),
          "all_ok": all(c["ok"] for c in checks), "timed": table,
          "peaks": {"bytes_per_s": mem_rate, "f32_flops": f32_rate}})
    return table


def check_non_finite_rows(gen) -> dict:
    """``sqdist_rows`` at (100, P_MNIST) on the planes a faulty fleet
    syncs: a NaN row, an Inf row, a -Inf row and a row zeroed by a cold
    restart, against its plain version. On values in {-1, 0, 1} every
    partial sum is an integer below 2**24, exact in f32 in any order, so
    the finite rows must be bit for bit; on normal values they must be
    within TOL. The non-finite rows must agree in kind (NaN with NaN,
    +Inf with +Inf)."""
    out = {}
    for label, make in (
            ("values in {-1, 0, 1}", lambda shape: torch.randint(
                -1, 2, shape, generator=gen, device="cuda").float()),
            ("normal values", lambda shape: torch.randn(
                shape, generator=gen, device="cuda"))):
        X, r = make((M, P_MNIST)), make((P_MNIST,))
        X[1], X[2], X[3], X[4] = math.nan, math.inf, -math.inf, 0.0
        got, want = sqdist.sqdist_rows(X, r), ref.sqdist_rows_ref(X, r)
        torch.cuda.synchronize()
        kind = (torch.equal(torch.isnan(got), torch.isnan(want))
                and torch.equal(torch.isposinf(got), torch.isposinf(want))
                and bool(torch.isnan(got[1])) and bool(torch.isposinf(
                    got[2])) and bool(torch.isposinf(got[3])))
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max())
        exact = bool(torch.equal(got[fin], want[fin]))
        ok = kind and (exact if label.startswith("values") else bool(
            torch.allclose(got[fin], want[fin], **TOL)))
        out[label] = {"shape": [M, P_MNIST], "finite_rows": int(fin.sum()),
                      "finite_max_abs_err": err, "finite_bitwise": exact,
                      "non_finite_agree_in_kind": kind, "ok": ok}
        if not ok:
            emit({"phase": "kernels", "failed": {"non_finite": out}})
            raise SystemExit(f"sqdist_rows on non-finite rows disagrees "
                             f"with its plain version: {out[label]}")
        del X, r
    return out


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
    mem_rate, f32_rate, bf16_rate = peaks(torch.cuda.get_device_name(0))[:3]
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


def phase_ssm_kernels(gen) -> tuple:
    """ssd_scan against the sequential plain version on the card, in f32
    and bf16, bitwise equal across two launches; then the serving path's
    own tensor (B = 4, H = 80, S = 2,048, P = 64, N = 128, chunk 64, f32,
    one group), checked and timed beside its bound and the plain
    version, with its CUDA launches per call and each launch's device
    time from the profiler. The program (``PROGRAM``) runs its products on
    the tensor cores in split TF32, so the bound is the larger of its
    bytes over the memory rate and its flops over the TF32 rate; the
    flops over the CUDA cores' f32 rate stand beside it. No single
    PyTorch call computes the SSD, so there is no library yardstick. Also
    rmsnorm against its plain version at the shapes mamba2-2.7b gives it
    (rows of d_model 2560 and d_inner 5120, in prefill and in decode)."""
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
        check(3, 64, 37, 20, 16, dtype)         # zero-padded tiles
        check(2, 64, 5, 3, 8, dtype)

    # the serving path's own tensor, as mamba_forward hands it over
    BH, S, P, N, Q, R = SERVE_B * 80, SERVE_S, 64, 128, 64, 80
    x, dt, a, b, c = check(BH, S, P, N, Q, torch.float32, R=R,
                           label="serve (320, 2048, 64, 128), chunk 64, "
                                 "80 heads per group")
    br, cr = b.repeat_interleave(R, 0), c.repeat_interleave(R, 0)
    mem_rate, f32_rate, _, tf32_rate = peaks(torch.cuda.get_device_name(0))
    nbytes, nops = ssd_work(BH, S, P, N, BH // R, Q, 4)
    t_bytes, t_ops = nbytes / mem_rate * 1e3, nops / tf32_rate * 1e3
    run = lambda: ssd_scan.ssd_scan(x, dt, a, b, c, chunk=Q)  # noqa: E731
    dev = profile_calls(run, 5)
    if dev["cuda_launches_per_call"] != ssd_scan.CUDA_LAUNCHES:
        raise SystemExit(f"ssd_scan made {dev['cuda_launches_per_call']} "
                         f"CUDA launches per call: {dev}")
    table = {"ssd_scan": {
        "shape": [BH, S, P, N, Q, R], "dtype": "float32",
        "program": ssd_scan.PROGRAM,
        "max_abs_err": worst,
        "ms": cuda_ms(run, 10, 2),
        "plain_ms": cuda_ms(lambda: ref.ssd_scan_ref(x, dt, a, br, cr), 2, 1),
        "library_ms": None,
        "library": "none: no single PyTorch call computes the chunked SSD",
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "ops": nops,
        "bound_ms_f32_cuda_cores": nops / f32_rate * 1e3,
        "device_ms": dev["device_ms"],
        "cuda_launches_per_call": dev["cuda_launches_per_call"],
        "launch_device_us": dev["kernels_us"]}}
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
          "peaks": {"bytes_per_s": mem_rate, "f32_flops": f32_rate,
                    "tf32_flops": tf32_rate}})
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
    # the first full-size call above, like llama's in `serve`, pays the
    # allocator's first requests (the kernel's scratch, the activations);
    # a second call gives the steady cost beside it
    _, steady_ms, _ = _timed(lambda: prefill(params, tokens))

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
                       "steady_ms": steady_ms,
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


# ---------------------------------------------------------------------------
# the paper's other experiments (slice 6)
# ---------------------------------------------------------------------------
PAPER_ROUNDS, PAPER_CHUNK, DRIFTS = 60, 20, (20, 40)


def _timed_run(fn):
    """``fn()`` between CUDA events, with the peak memory it allocated:
    ``(result, ms, peak_bytes)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), torch.cuda.max_memory_allocated()


def _check_fleet_run(name, dl, P):
    if dl.model_size != P:
        raise SystemExit(f"{name}: {dl.model_size} weights, not {P}")
    if not (math.isfinite(dl.cumulative_loss)
            and np.isfinite(dl.cumulative_loss_per_learner).all()):
        raise SystemExit(f"{name}: non-finite loss")
    if int(dl.per_link_bytes().sum()) != dl.comm_bytes():
        raise SystemExit(f"{name}: ledger {int(dl.per_link_bytes().sum())} "
                         f"!= comm_bytes {dl.comm_bytes()}")
    if not dl.X.is_cuda:
        raise SystemExit(f"{name}: the parameter plane is on {dl.X.device}")


def _fleet_record(dl, ms, peak, launches):
    return {"weights": dl.model_size, "rounds": dl.rounds,
            "ms_per_round": ms / dl.rounds, "syncs": dl.comm_totals["syncs"],
            "full_syncs": dl.comm_totals["full_syncs"],
            "model_up": dl.comm_totals["model_up"],
            "comm_bytes": dl.comm_bytes(),
            "ledger_bytes": int(dl.per_link_bytes().sum()),
            "cumulative_loss": dl.cumulative_loss,
            "peak_memory_bytes": peak, "sqdist_rows": launches,
            "plane_device": str(dl.X.device)}


def phase_paper_train() -> dict:
    """The paper's other experiments at full width on the card: the
    deep-driving PilotNet (deepdrive_cnn, 348,219 weights, 68x320x3
    frames) under known drifts through run_drift_segments, FedAvg, the
    random augmentation from a heterogeneous init, and the serial
    baseline, each on mnist_cnn at m = 100. The sqdist_rows counts are
    set to 0 just before each run and read just after."""
    train = TrainConfig(optimizer="sgd", learning_rate=0.05)
    runs, launches = {}, {}

    # deep driving under drift: m = 100, B = 10, drifts at rounds 20, 40
    dd = get_arch("deepdrive_cnn")
    dd_loss = lambda p, b: cnn_loss(dd, p, b)           # noqa: E731
    dd_init = lambda g: init_cnn_params(dd, g)           # noqa: E731
    warm = DecentralizedLearner(dd_loss, dd_init, M,
                                ProtocolConfig(kind="nosync"), train,
                                device="cuda")           # cuDNN's choices
    warm.run_chunk(LearnerStreams(DeepDriveStream(seed=1, device="cuda"), M,
                                  batch=B).next_chunk(2))
    del warm
    dynamic = ProtocolConfig(kind="dynamic", b=2, delta=0.3)
    for name, proto, want in (
            ("deepdrive periodic", ProtocolConfig(kind="periodic", b=10), 0),
            ("deepdrive drift", dynamic, PAPER_ROUNDS // 2),
            # the same run again: its decisions must repeat to the bit
            ("deepdrive drift repeat", dynamic, PAPER_ROUNDS // 2)):
        src = DeepDriveStream(seed=1, device="cuda")
        streams = LearnerStreams(src, M, batch=B, seed=0)
        dl = DecentralizedLearner(dd_loss, dd_init, M, proto, train,
                                  device="cuda")
        ops.reset_launches()
        (sync_curve, _), ms, peak = _timed_run(
            lambda: run_drift_segments(dl, streams, src, PAPER_ROUNDS,
                                       DRIFTS))
        launches[name] = ops.LAUNCHES["sqdist_rows"]
        _check_fleet_run(name, dl, P_DEEPDRIVE)
        runs[name] = _fleet_record(dl, ms, peak, launches[name])
        runs[name]["curvature_scale"] = src.curvature_scale
        runs[name]["syncs_by_segment"] = [
            int(sync_curve[e - 1] - (sync_curve[s - 1] if s else 0))
            for s, e in zip((0,) + DRIFTS, DRIFTS + (PAPER_ROUNDS,))]
        runs[name]["per_link_bytes"] = dl.per_link_bytes().tolist()
        if launches[name] != want:
            raise SystemExit(f"{name} launched sqdist_rows "
                             f"{launches[name]} times, not {want}")
        del dl, streams
        torch.cuda.empty_cache()
    if runs["deepdrive drift"]["syncs"] < 1:
        raise SystemExit("the deepdrive dynamic run never synced")
    again = runs.pop("deepdrive drift repeat")
    launches.pop("deepdrive drift repeat")
    first = runs["deepdrive drift"]
    runs["deepdrive drift"]["repeat_ms_per_round"] = again["ms_per_round"]
    same = ("syncs", "model_up", "comm_bytes", "cumulative_loss",
            "per_link_bytes")
    if any(again[k] != first[k] for k in same):
        raise SystemExit(f"the deepdrive dynamic run did not repeat: "
                         f"{ {k: (first[k], again[k]) for k in same} }")
    for rec in runs.values():
        rec.pop("per_link_bytes")

    # mnist_cnn at m = 100: FedAvg, then the random augmentation from a
    # heterogeneous init (Fig. 6.2's eps = 2; the noisy learners start at
    # ~4x the homogeneous loss, so at half the step size)
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init_fn = lambda g: init_cnn_params(cfg, g)          # noqa: E731
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    mtrain = TrainConfig(optimizer="sgd", learning_rate=0.1)
    for name, proto, eps, lr, want in (
            ("mnist fedavg", ProtocolConfig(kind="fedavg", b=PERIOD,
                                            fedavg_c=0.3), 0.0, 0.1, 0),
            ("random augmentation", ProtocolConfig(
                kind="dynamic", b=PERIOD, delta=DELTA,
                augmentation="random"), 2.0, 0.05, PAPER_ROUNDS // PERIOD)):
        ops.reset_launches()
        (dl, traj), ms, peak = _timed_run(lambda: run_protocol_training(
            loss_fn, init_fn, src, m=M, rounds=PAPER_ROUNDS, protocol=proto,
            train=TrainConfig(optimizer="sgd", learning_rate=lr), batch=B,
            chunk_size=PAPER_CHUNK,
            record_every=PAPER_CHUNK, init_heterogeneity=eps,
            device="cuda"))
        launches[name] = ops.LAUNCHES["sqdist_rows"]
        _check_fleet_run(name, dl, P_MNIST)
        runs[name] = _fleet_record(dl, ms, peak, launches[name])
        runs[name].update(init_heterogeneity=eps, learning_rate=lr)
        if launches[name] != want:
            raise SystemExit(f"{name} launched sqdist_rows "
                             f"{launches[name]} times, not {want}")
        del dl
    fed = runs["mnist fedavg"]
    if (fed["syncs"], fed["model_up"], fed["full_syncs"]) != (6, 180, 0):
        raise SystemExit(f"fedavg C=0.3 at m = 100 made {fed['syncs']} "
                         f"syncs moving {fed['model_up']} models up, not "
                         f"6 and 180")
    if runs["random augmentation"]["syncs"] < 1:
        raise SystemExit("the random-augmentation run never synced")

    # the serial baseline: one model sees all m * B samples of a round
    serial = SerialLearner(loss_fn, init_fn, mtrain, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(123)
    ops.reset_launches()

    def serial_run():
        for _ in range(PAPER_ROUNDS // PAPER_CHUNK):
            serial.run_chunk(src.sample(gen, M * B, lead=(PAPER_CHUNK,)))

    _, ms, peak = _timed_run(serial_run)
    launches["serial"] = ops.LAUNCHES["sqdist_rows"]
    if not math.isfinite(serial.cumulative_loss) or not serial.x.is_cuda:
        raise SystemExit(f"serial: loss {serial.cumulative_loss} on "
                         f"{serial.x.device}")
    runs["serial"] = {"weights": serial.adapter.P, "rounds": PAPER_ROUNDS,
                      "batch": M * B, "ms_per_round": ms / PAPER_ROUNDS,
                      "cumulative_loss": serial.cumulative_loss,
                      "peak_memory_bytes": peak, "sqdist_rows": 0}
    if launches["serial"]:
        raise SystemExit(f"serial launched sqdist_rows: {launches}")
    emit({"phase": "paper_train", "m": M, "batch": B, "runs": runs})
    return launches


class HostDrawn:
    """A data source drawn on the CPU from its own generator and moved to
    ``device``, so that a run on the card and one on the CPU see the same
    batches; drifts are the wrapped source's (its numpy stream)."""

    def __init__(self, source, device, seed):
        self.source, self.device = source, torch.device(device)
        self.gen = torch.Generator().manual_seed(seed)

    def maybe_drift(self):
        return self.source.maybe_drift()

    def sample(self, generator, batch, lead=()):
        out = self.source.sample(self.gen, batch, lead)
        return {k: v.to(self.device) for k, v in out.items()}


def phase_paper_agree() -> dict:
    """Small runs on the card and on the CPU from the same initial model
    and batches: FedAvg, the random augmentation, a heterogeneous init
    and drift=True. Comm totals, the ledger and the drift rounds must be
    identical; losses and parameters agree as in ``agree``, widened for
    the heterogeneous init by ``prng.NORMAL_TOL``. Then ``prng`` on the
    card against the CPU, bit for bit."""
    cfg = get_arch("drift_mlp")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init = params_to_numpy(init_cnn_params(cfg, torch.Generator()
                                           .manual_seed(5)))
    train = TrainConfig(optimizer="sgd", learning_rate=0.05)
    cases = {
        "fedavg": (ProtocolConfig(kind="fedavg", b=2, fedavg_c=0.5), 0.0,
                   0.0),
        "random augmentation": (ProtocolConfig(
            kind="dynamic", b=2, delta=0.5, augmentation="random"), 0.0,
            0.0),
        "init_heterogeneity": (ProtocolConfig(kind="dynamic", b=2,
                                              delta=0.5), 2.0, 0.0),
        "drift": (ProtocolConfig(kind="dynamic", b=2, delta=0.5), 0.0,
                  0.05),
    }
    report = {}
    for name, (proto, eps, p_drift) in cases.items():
        out = {}
        for dev in ("cpu", "cuda"):
            src = HostDrawn(GraphicalModelStream(
                seed=1, drift_prob=p_drift, device="cpu"), dev, seed=7)
            dl, traj = run_protocol_training(
                loss_fn, lambda g: params_from_numpy(init, g.device), src,
                m=6, rounds=40, protocol=proto, train=train, batch=10,
                seed=3, drift=p_drift > 0, init_heterogeneity=eps,
                chunk_size=15, device=dev)
            out[dev] = (dl, traj)
        (cpu, ctraj), (gpu, gtraj) = out["cpu"], out["cuda"]
        err = float((gpu.X.cpu() - cpu.X).abs().max())
        tol = 1e-5
        if eps:
            # the init noise may differ by NORMAL_TOL per unit of |z|
            base = cpu.adapter.ravel_model(params_from_numpy(init, "cpu"))
            scale = max(float(torch.std(x, correction=0)) for x in
                        tree_leaves(params_from_numpy(init, "cpu")))
            zmax = float((cpu.X - base).abs().max()) / (eps * scale)
            tol += eps * scale * prng.NORMAL_TOL * max(1.0, zmax)
        report[name] = {"comm_totals": gpu.comm_totals,
                        "cpu_comm_totals": cpu.comm_totals,
                        "drift_rounds": gtraj.drift_rounds,
                        "cpu_drift_rounds": ctraj.drift_rounds,
                        "loss": gpu.cumulative_loss,
                        "cpu_loss": cpu.cumulative_loss,
                        "param_max_abs_err": err, "param_tol": tol}
        if (gpu.comm_totals != cpu.comm_totals
                or not np.array_equal(gpu.per_link_bytes(),
                                      cpu.per_link_bytes())
                or gtraj.drift_rounds != ctraj.drift_rounds
                or not torch.equal(gpu.sync_state.key,
                                   cpu.sync_state.key)
                or gpu.comm_totals["syncs"] < 1):
            emit({"phase": "paper_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's comm or drift rounds "
                             f"differ from the CPU's")
        if not (math.isclose(gpu.cumulative_loss, cpu.cumulative_loss,
                             rel_tol=1e-5) and err <= tol):
            emit({"phase": "paper_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's losses or parameters "
                             f"differ from the CPU's")
    if not report["drift"]["drift_rounds"]:
        raise SystemExit("the drift case drew no drift")

    # prng on the card against the CPU
    k = prng.key(2024, device="cpu")
    keys = prng.split(k, 100, device="cpu")
    same = {
        "split": lambda d: prng.split(keys, 7, device=d),
        "fold_in": lambda d: prng.fold_in(keys, 11, device=d),
        "random_bits": lambda d: prng.random_bits(k, (8, P_DEEPDRIVE),
                                                  device=d),
        "uniform": lambda d: prng.uniform(keys, (1000,), -1.5, 2.0,
                                          device=d),
        "permutation": lambda d: torch.cat([
            prng.permutation(keys[i], n, device=d)
            for i, n in ((0, 100), (1, 1625), (2, 2000))]),
    }
    bits = {}
    for name, fn in same.items():
        a, b = fn("cuda"), fn("cpu")
        bits[name] = bool(a.is_cuda and torch.equal(a.cpu(), b))
    zc = prng.normal(keys, (P_DEEPDRIVE // 100,), device="cuda").cpu()
    z = prng.normal(keys, (P_DEEPDRIVE // 100,), device="cpu")
    normal_err = float(((zc - z).abs() / z.abs().clamp_min(1.0)).max())
    rec = {"phase": "paper_agree", "cases": report, "prng_bitwise": bits,
           "normal_max_err_per_unit": normal_err,
           "normal_tol": prng.NORMAL_TOL}
    emit(rec)
    if not all(bits.values()):
        raise SystemExit(f"prng on the card differs from the CPU: {bits}")
    if normal_err > prng.NORMAL_TOL:
        raise SystemExit(f"prng.normal on the card is {normal_err} from "
                         f"the CPU's, beyond {prng.NORMAL_TOL}")
    return rec


# ---------------------------------------------------------------------------
# the network environment (slice 7)
# ---------------------------------------------------------------------------
# the regimes sweep's settings (benchmarks/fig_network_regimes.py:65-68)
# and the golden cases' ring (tests/golden_pr2_capture.py)
NET_GEO = dict(topology="geometric", act_prob=0.7, geo_radius=0.6,
               redraw_every=20, link_classes=("wifi", "lte"))
NET_RING = dict(topology="ring", act_prob=0.6, link_classes=("wifi", "lte"))
NET_OUTAGES = dict(straggler_frac=0.25, outage_every=10)


def phase_net_train() -> dict:
    """mnist_cnn at full width, m = 100, inside the simulated network,
    through run_protocol_training(network=...), 60 rounds in chunks of
    20. The sqdist_rows count is set to 0 just before each run and read
    just after: one launch per checked round of a dynamic run, whatever
    the masks; none under periodic, fedavg and gossip."""
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init_fn = lambda g: init_cnn_params(cfg, g)          # noqa: E731
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    dynamic = ProtocolConfig(kind="dynamic", b=PERIOD, delta=DELTA)
    checked = ROUNDS // PERIOD
    plan = (
        ("dynamic geometric", dynamic, NetworkConfig(**NET_GEO), checked),
        ("gossip geometric", ProtocolConfig(kind="gossip", b=PERIOD),
         NetworkConfig(**NET_GEO), 0),
        ("fedavg ring", ProtocolConfig(kind="fedavg", b=PERIOD,
                                       fedavg_c=0.3),
         NetworkConfig(**NET_RING), 0),
        ("periodic ring", ProtocolConfig(kind="periodic", b=PERIOD),
         NetworkConfig(**NET_RING), 0),
        ("dynamic outages", dynamic, NetworkConfig(**NET_OUTAGES), checked),
        ("dynamic ideal", dynamic, None, checked),
        ("dynamic full availability", dynamic, NetworkConfig(), checked))
    runs, launches, planes = {}, {}, {}
    for name, proto, net, want in plan:
        ops.reset_launches()
        (dl, traj), ms, peak = _timed_run(lambda: run_protocol_training(
            loss_fn, init_fn, src, m=M, rounds=ROUNDS, protocol=proto,
            train=TrainConfig(optimizer="sgd", learning_rate=0.1), batch=B,
            chunk_size=CHUNK, record_every=CHUNK, network=net,
            device="cuda"))
        launches[name] = ops.LAUNCHES["sqdist_rows"]
        if dl.model_size != P_MNIST or not dl.X.is_cuda:
            raise SystemExit(f"{name}: {dl.model_size} weights on "
                             f"{dl.X.device}")
        if not (math.isfinite(dl.cumulative_loss)
                and np.isfinite(dl.cumulative_loss_per_learner).all()):
            raise SystemExit(f"{name}: non-finite loss")
        ledger = int(dl.per_link_bytes().sum())
        if ledger != (2 if dl.spec.uses_overlay else 1) * dl.comm_bytes():
            raise SystemExit(f"{name}: ledger {ledger} against comm_bytes "
                             f"{dl.comm_bytes()}")
        runs[name] = {
            "network": None if net is None else {
                k: v for k, v in vars(net).items()
                if v != getattr(NetworkConfig(), k)},
            "ms_per_round": ms / ROUNDS, "peak_memory_bytes": peak,
            "syncs": dl.comm_totals["syncs"],
            "full_syncs": dl.comm_totals["full_syncs"],
            "model_up": dl.comm_totals["model_up"],
            "comm_bytes": dl.comm_bytes(), "ledger_bytes": ledger,
            "network_time": dl.network_time,
            "mean_active": dl.mean_active(),
            "cumulative_loss": dl.cumulative_loss,
            "sqdist_rows": launches[name],
            "trajectory_network_time": traj.network_time}
        if launches[name] != want:
            raise SystemExit(f"{name} launched sqdist_rows "
                             f"{launches[name]} times, not {want}")
        if net is not None and not net.full_availability \
                and not dl.mean_active() < 1.0:
            raise SystemExit(f"{name}: every learner was always reachable")
        if name in ("dynamic ideal", "dynamic full availability"):
            planes[name] = (dl.X, dl.per_link_bytes(), dl.comm_totals,
                            dl.cumulative_loss)
        del dl
    ideal, full = planes["dynamic ideal"], planes["dynamic full availability"]
    bitwise = (torch.equal(ideal[0], full[0])
               and np.array_equal(ideal[1], full[1])
               and ideal[2] == full[2] and ideal[3] == full[3])
    # the network's own costs a chunk: drawing its masks on the host, and
    # gossip's mixing product W @ X on the card (cuBLAS SGEMM, TF32 off)
    geo = NetworkConfig(**NET_GEO)
    t0 = time.perf_counter()
    for _ in range(10):
        active = availability.sample_rounds(geo, M, range(CHUNK))[0]
    masks_ms = (time.perf_counter() - t0) * 1e2
    _, W = stages.cohort_neighborhood(M, active,
                                      topology.adjacency(geo, M, 0))
    W = torch.from_numpy(W).cuda()
    mix_ms = cuda_ms(lambda: W @ ideal[0])
    emit({"phase": "net_train", "m": M, "batch": B, "runs": runs,
          "full_availability_bitwise": bitwise,
          "masks_host_ms_per_chunk": masks_ms, "chunk": CHUNK,
          "gossip_mix_ms": mix_ms,
          "gossip_mix_gflop": 2 * M * M * P_MNIST / 1e9})
    if not bitwise:
        raise SystemExit("the dynamic run at full availability is not the "
                         "network=None run bit for bit")
    for name, rec in runs.items():
        if rec["syncs"] < 1:
            raise SystemExit(f"{name} never synced")
    return launches


def phase_net_agree() -> dict:
    """The network golden cases (drift_mlp smoke, m = 6, 40 rounds), a
    mobile gossip case and bounded staleness on the card and on the CPU,
    from the same model and batches: comm, ledger, per-round masks,
    per-link counts and network times identical; losses and parameters
    within paper_agree's tolerances."""
    cfg = get_arch("drift_mlp")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init = params_to_numpy(init_cnn_params(cfg, torch.Generator()
                                           .manual_seed(5)))
    src = GraphicalModelStream(seed=1, drift_prob=0.0, device="cpu")
    batches = src.sample(torch.Generator().manual_seed(7), 10, lead=(40, 6))
    mobile = dict(topology="geometric", act_prob=0.7, geo_radius=0.6,
                  redraw_every=7, link_classes=("wifi", "lte"), seed=3)
    cases = {
        "periodic_net": (ProtocolConfig(kind="periodic", b=3), NET_RING),
        "fedavg_net": (ProtocolConfig(kind="fedavg", b=2, fedavg_c=0.5),
                       NET_RING),
        "dynamic_net": (ProtocolConfig(kind="dynamic", b=2, delta=0.5),
                        NET_RING),
        "gossip_net": (ProtocolConfig(kind="gossip", b=2),
                       dict(NET_RING, act_prob=0.8)),
        "gossip_star_fallback": (ProtocolConfig(kind="gossip", b=2), None),
        "gossip_mobile": (ProtocolConfig(kind="gossip", b=2), mobile),
        "stale": (ProtocolConfig(kind="stale"), NET_RING),
    }
    report = {}
    for name, (proto, net) in cases.items():
        out = {}
        for dev in ("cpu", "cuda"):
            dl = DecentralizedLearner(
                loss_fn, lambda g: params_from_numpy(init, g.device), 6,
                proto, TrainConfig(optimizer="sgd", learning_rate=0.05),
                network=None if net is None else NetworkConfig(**net),
                device=dev)
            metrics = [dl.run_chunk({k: v[i:i + 20].to(dev)
                                     for k, v in batches.items()})
                       for i in (0, 20)]
            out[dev] = (dl, metrics)
        (cpu, cm), (gpu, gm) = out["cpu"], out["cuda"]
        err = float((gpu.X.cpu() - cpu.X).abs().max())
        same = (gpu.comm_totals == cpu.comm_totals
                and np.array_equal(gpu.per_link_bytes(),
                                   cpu.per_link_bytes())
                and gpu.network_time == cpu.network_time
                and gpu.mean_active() == cpu.mean_active()
                and all(np.array_equal(a.num_active, b.num_active)
                        and np.array_equal(a.link_counts, b.link_counts)
                        and np.array_equal(a.net_time, b.net_time)
                        for a, b in zip(gm, cm)))
        report[name] = {"comm_totals": gpu.comm_totals,
                        "cpu_comm_totals": cpu.comm_totals,
                        "network_time": gpu.network_time,
                        "cpu_network_time": cpu.network_time,
                        "mean_active": gpu.mean_active(),
                        "loss": gpu.cumulative_loss,
                        "cpu_loss": cpu.cumulative_loss,
                        "param_max_abs_err": err, "identical": same}
        if not same or gpu.comm_totals["syncs"] < 1:
            emit({"phase": "net_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's comm, masks or network "
                             f"time differ from the CPU's")
        if not (math.isclose(gpu.cumulative_loss, cpu.cumulative_loss,
                             rel_tol=1e-5) and err <= 1e-5):
            emit({"phase": "net_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's losses or parameters "
                             f"differ from the CPU's")
    rec = {"phase": "net_agree", "cases": report}
    emit(rec)
    return rec



# the hierarchy and async cells: fig_hierarchy's 2x ratio of inter to
# intra Delta (benchmarks/fig_hierarchy.py), the net phases' ring at 60%,
# and a wifi/lte fleet whose lte exchanges of mnist_cnn's 4,799,528-byte
# payload fly 2 rounds at a 1 s budget (0 at 3 s)
ASYNC_NET = dict(link_classes=("wifi", "lte"))
TIER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "tier_ckpt")


def _tiers(intra: dict, inter: dict, link_class="wired") -> ProtocolConfig:
    return ProtocolConfig(**intra, tiers=HierarchyConfig(
        num_clusters=TIER_G, inter=ProtocolConfig(**inter),
        link_class=link_class))


def _ledger_balance(dl) -> dict:
    """The ledger against the paper's c(f), as the reference's tests hold
    it (tests/test_sync_kernel.py:367-420, tests/test_async.py): the
    per-link sums are comm_bytes(); under a periodic inter tier the
    aggregator rows are whole models at the inter payload (the quantized
    backhaul's case); under aircomp every member link
    carries one frame a sync, so the ledger is its transfers priced."""
    ledger = dl.per_link_bytes()
    out = {"ledger_bytes": int(ledger.sum()), "comm_bytes": dl.comm_bytes()}
    if dl.spec.commit == "aircomp":
        out["balanced"] = (
            out["ledger_bytes"] == int(dl.link_xfer_totals.sum())
            * dl.model_bytes and dl.comm_bytes()
            == 2 * dl.comm_totals["syncs"] * dl.model_bytes)
    else:
        out["balanced"] = out["ledger_bytes"] == dl.comm_bytes()
    if dl.tiers is not None:
        out["uplink_bytes"] = int(ledger[dl.m:].sum())
        if dl.tiers.inter.kind == "periodic":   # no control messages:
            # the uplinks carry whole models at the inter payload
            out["balanced"] &= out["uplink_bytes"] % dl.inter_model_bytes == 0
    return out


def _run_chunks(dl, streams, chunks):
    """Drive ``dl`` over ``chunks`` chunk lengths of ``streams``; returns
    the per-round (in flight, gate fired) series."""
    inflight, checked = [], []
    for n in chunks:
        metrics = dl.run_chunk(streams.next_chunk(n))
        inflight += metrics.num_inflight.tolist()
        checked += metrics.checked.tolist()
    return inflight, checked


def _state_equal(a, b) -> bool:
    """Two sync states (flat or hierarchical) equal to the bit: reference
    rows, counters, steps, keys and every carried array."""
    if hasattr(a, "intra"):
        return _state_equal(a.intra, b.intra) and _state_equal(a.inter,
                                                               b.inter)
    return (torch.equal(a.ref, b.ref) and np.array_equal(a.v, b.v)
            and a.step == b.step and torch.equal(a.key, b.key)
            and sorted(a.extra) == sorted(b.extra)
            and all(np.array_equal(a.extra[k], b.extra[k]) for k in a.extra))


def _same_run(a, b) -> bool:
    return (torch.equal(a.X, b.X) and a.opt_state.step == b.opt_state.step
            and _state_equal(a.sync_state, b.sync_state)
            and a.comm_totals == b.comm_totals
            and np.array_equal(a.per_link_bytes(), b.per_link_bytes())
            and a.network_time == b.network_time
            and a.cumulative_loss == b.cumulative_loss)


def phase_tier_train() -> dict:
    """mnist_cnn at full width, m = 100, B = 10, sgd lr 0.1, 60 rounds in
    chunks of 20, seed 0, under the hierarchy (H1 on an ideal network,
    H2 in the ring at 60% with a quantized backhaul) and the async
    timeline (A1 with flights, A2 and A3 at k = 0, A3 over the air).
    The sqdist_rows counts are zeroed before each run and read after it,
    split by shape; H1 and A1 are also saved after chunk 1, restored into
    a fresh engine and run on, and must equal their uninterrupted runs
    bit for bit."""
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init_fn = lambda g: init_cnn_params(cfg, g)          # noqa: E731
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    train = TrainConfig(optimizer="sgd", learning_rate=0.1)
    dyn = dict(kind="dynamic", b=PERIOD, delta=DELTA)
    per = dict(kind="periodic", b=PERIOD)
    checked = ROUNDS // PERIOD
    grouped, inter_shape = (M, P_MNIST, TIER_G), (TIER_G, P_MNIST, 1)
    flat_shape = (M, P_MNIST, 1)
    plan = {   # name -> (protocol, network, AsyncConfig, predicted launches)
        "H1": (_tiers(dyn, dict(kind="dynamic", b=PERIOD, delta=2 * DELTA)),
               None, None, {grouped: checked, inter_shape: checked}),
        "H2": (_tiers(per, dict(kind="periodic", b=2 * PERIOD,
                                bytes_per_param=2)),
               NetworkConfig(**NET_RING), None, {}),
        "A1": (ProtocolConfig(**dyn), NetworkConfig(**ASYNC_NET),
               AsyncConfig(round_budget=1.0, max_delay=8), None),
        "A2 sync": (ProtocolConfig(**per), NetworkConfig(**ASYNC_NET), None,
                    {}),
        "A2": (ProtocolConfig(**per), NetworkConfig(**ASYNC_NET),
               AsyncConfig(round_budget=3.0), {}),
        "A3": (ProtocolConfig(**per), NetworkConfig(**ASYNC_NET),
               AsyncConfig(round_budget=3.0, aircomp=True, snr_db=20.0), {}),
    }

    def engine(proto, net, an):
        streams = LearnerStreams(src, M, batch=B, seed=0)
        return DecentralizedLearner(loss_fn, init_fn, M, proto, train,
                                    seed=0, network=net, async_net=an,
                                    device="cuda"), streams

    runs, done, counts = {}, {}, {}
    for name, (proto, net, an, want) in plan.items():
        held = torch.cuda.memory_allocated()     # earlier runs kept alive
        ops.reset_launches()
        if name == "A1":     # per-round timeline: the chunks by hand
            dl, streams = engine(proto, net, an)
            (series, ms, peak) = _timed_run(lambda: _run_chunks(
                dl, streams, [CHUNK] * (ROUNDS // CHUNK)))
            inflight, gated = series
            want = {flat_shape: int(sum(gated))}
        else:
            (dl, _), ms, peak = _timed_run(lambda: run_protocol_training(
                loss_fn, init_fn, src, m=M, rounds=ROUNDS, protocol=proto,
                train=train, batch=B, chunk_size=CHUNK, record_every=CHUNK,
                network=net, async_net=an, device="cuda"))
        counts[name] = {str(k): v for k, v in ops.ROWS_LAUNCHES.items()}
        if dict(ops.ROWS_LAUNCHES) != want:
            raise SystemExit(f"{name}: sqdist_rows launches "
                             f"{counts[name]}, predicted "
                             f"{ {str(k): v for k, v in want.items()} }")
        if dl.model_size != P_MNIST or not dl.X.is_cuda:
            raise SystemExit(f"{name}: {dl.model_size} weights on "
                             f"{dl.X.device}")
        if not (math.isfinite(dl.cumulative_loss)
                and np.isfinite(dl.cumulative_loss_per_learner).all()):
            raise SystemExit(f"{name}: non-finite loss")
        balance = _ledger_balance(dl)
        if not balance["balanced"]:
            raise SystemExit(f"{name}: the ledger does not balance: "
                             f"{balance}")
        runs[name] = {
            "ms_per_round": ms / ROUNDS, "peak_memory_bytes": peak - held,
            "held_before_bytes": held, "syncs": dl.comm_totals["syncs"],
            "full_syncs": dl.comm_totals["full_syncs"],
            "model_up": dl.comm_totals["model_up"], **balance,
            "network_time": dl.network_time,
            "mean_active": dl.mean_active(),
            "cumulative_loss": dl.cumulative_loss,
            "sqdist_rows": counts[name], "links": dl.num_links}
        if name == "A1":
            runs[name]["mean_inflight"] = float(np.mean(inflight))
            runs[name]["inflight_per_round"] = inflight
            runs[name]["gated_rounds"] = [i + 1 for i, g in enumerate(gated)
                                          if g]
        if name in ("H1", "A1", "A2 sync", "A2"):
            done[name] = dl
        else:
            del dl
    a2, a2s = done.pop("A2"), done.pop("A2 sync")
    a2_bitwise = (torch.equal(a2.X, a2s.X) and a2.comm_totals
                  == a2s.comm_totals and np.array_equal(
                      a2.per_link_bytes(), a2s.per_link_bytes())
                  and a2.network_time == a2s.network_time
                  and a2.cumulative_loss == a2s.cumulative_loss)
    del a2, a2s
    # every learner ticks at rounds 10, 20, ..., 60 unless in flight, and
    # the wifi half never flies
    if not set(range(PERIOD, ROUNDS + 1, PERIOD)) <= set(
            runs["A1"]["gated_rounds"]):
        raise SystemExit(f"A1's gate missed a cadence round: "
                         f"{runs['A1']['gated_rounds']}")

    # resume: chunk 1, save, a fresh engine restores and runs to round 60
    resumed = {}
    for name in ("H1", "A1"):
        proto, net, an, _ = plan[name]
        first, streams = engine(proto, net, an)
        first.run_chunk(streams.next_chunk(CHUNK))
        path = os.path.join(TIER_DIR, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        io.save_protocol_state(path, first.params, first.opt_state,
                               first.sync_state, protocol=proto,
                               counters=first.counters_state())
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(f"{path}.{part}")
                     for part in ("params.npz", "opt.npz", "sync.npz",
                                  "spec.json", "counters.json"))
        del first
        second, streams = engine(proto, net, an)
        t0 = time.perf_counter()
        loaded = io.load_protocol_state(path, device="cuda")
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        second.restore_state(*loaded)
        second.restore_counters(io.load_counters(path))
        del loaded
        streams.next_chunk(CHUNK)            # replay the consumed data
        _run_chunks(second, streams, [CHUNK] * (ROUNDS // CHUNK - 1))
        same = _same_run(second, done[name])
        resumed[name] = {"write_s": write_s, "read_s": read_s,
                         "bytes": nbytes, "bitwise": same,
                         "spec_restored": io.load_protocol_spec(path)
                         == resolve_spec(proto)}
        del second, done[name]
    rec = {"phase": "tier_train", "m": M, "batch": B, "clusters": TIER_G,
           "runs": runs, "a2_equals_sync_bitwise": a2_bitwise,
           "resume": resumed}
    emit(rec)
    if not a2_bitwise:
        raise SystemExit("A2 (k = 0 everywhere) is not the synchronous "
                         "periodic run bit for bit")
    for name, r in resumed.items():
        if not (r["bitwise"] and r["spec_restored"]):
            raise SystemExit(f"{name}: the resumed run is not the "
                             f"uninterrupted one bit for bit: {r}")
    for name, r in runs.items():
        if r["syncs"] < 1:
            raise SystemExit(f"{name} never synced")
    if not runs["A1"]["mean_inflight"] > 0:
        raise SystemExit("A1: no exchange was ever in flight")
    return {k: sum(v.values()) for k, v in counts.items()}


def phase_tier_agree() -> dict:
    """The hierarchy sweep's settings (benchmarks/fig_hierarchy.py:
    drift_mlp smoke, m = 12, g in {3, 4}, intra dynamic b = 2 Delta =
    0.3, inter Delta in {0.3, 0.6}; one in the ring at 60%) and the async
    bench's presets (benchmarks/async_bench.py: m = 8 on lte/edge links,
    async periodic and dynamic, aircomp at 20 dB) on the card and on the
    CPU from the same model and batches: comm, ledger, per-round link
    counts, in-flight counts and network time identical, parameters
    within 1e-5. Then a checkpoint written on the card after chunk 1
    is continued on the CPU: the same integers as the card's own run."""
    cfg = get_arch("drift_mlp", smoke=True)
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init = params_to_numpy(init_cnn_params(cfg, torch.Generator()
                                           .manual_seed(5)))
    src = GraphicalModelStream(seed=1, drift_prob=0.0, device="cpu")
    edge = dict(link_classes=("lte", "edge"))
    sweep = dict(kind="dynamic", b=2, delta=0.3)

    def hier(g, inter_delta):
        return ProtocolConfig(**sweep, tiers=HierarchyConfig(
            num_clusters=g, inter=ProtocolConfig(kind="dynamic", b=2,
                                                 delta=inter_delta)))

    cases = {   # name -> (m, protocol, network, AsyncConfig)
        "hier g3 inter 0.3": (12, hier(3, 0.3), None, None),
        "hier g3 inter 0.6": (12, hier(3, 0.6), None, None),
        "hier g4 inter 0.3": (12, hier(4, 0.3), None, None),
        "hier g4 inter 0.6": (12, hier(4, 0.6), None, None),
        "hier g3 ring": (12, hier(3, 0.6), NET_RING, None),
        "async periodic": (8, ProtocolConfig(kind="periodic", b=2), edge,
                           AsyncConfig(round_budget=1.0,
                                       payload_bytes=100_000)),
        "async dynamic": (8, ProtocolConfig(kind="dynamic", b=2, delta=0.5),
                          edge, AsyncConfig(round_budget=0.25,
                                            payload_bytes=100_000)),
        "aircomp": (8, ProtocolConfig(kind="periodic", b=2), edge,
                    AsyncConfig(round_budget=60.0, aircomp=True,
                                snr_db=20.0)),
    }
    report = {}
    for name, (m, proto, net, an) in cases.items():
        batches = src.sample(torch.Generator().manual_seed(7), 10,
                             lead=(40, m))
        out = {}
        for dev in ("cpu", "cuda"):
            dl = DecentralizedLearner(
                loss_fn, lambda g: params_from_numpy(init, g.device), m,
                proto, TrainConfig(optimizer="sgd", learning_rate=0.05),
                network=None if net is None else NetworkConfig(**net),
                async_net=an, device=dev)
            metrics = [dl.run_chunk({k: v[i:i + 20].to(dev)
                                     for k, v in batches.items()})
                       for i in (0, 20)]
            out[dev] = (dl, metrics)
            if name == "hier g3 ring" and dev == "cuda":
                ckpt = os.path.join(TIER_DIR, "agree")
                resume = DecentralizedLearner(
                    loss_fn, lambda g: params_from_numpy(init, g.device), m,
                    proto, TrainConfig(optimizer="sgd", learning_rate=0.05),
                    network=NetworkConfig(**net), device="cuda")
                resume.run_chunk({k: v[:20].to("cuda")
                                  for k, v in batches.items()})
                io.save_protocol_state(ckpt, resume.params, resume.opt_state,
                                       resume.sync_state, protocol=proto,
                                       counters=resume.counters_state())
        (cpu, cm), (gpu, gm) = out["cpu"], out["cuda"]
        err = float((gpu.X.cpu() - cpu.X).abs().max())
        same = (gpu.comm_totals == cpu.comm_totals
                and np.array_equal(gpu.per_link_bytes(),
                                   cpu.per_link_bytes())
                and gpu.network_time == cpu.network_time
                and all(np.array_equal(a.link_counts, b.link_counts)
                        and np.array_equal(a.num_inflight, b.num_inflight)
                        and np.array_equal(a.net_time, b.net_time)
                        for a, b in zip(gm, cm)))
        report[name] = {"comm_totals": gpu.comm_totals,
                        "cpu_comm_totals": cpu.comm_totals,
                        "links": gpu.num_links,
                        "network_time": gpu.network_time,
                        "inflight": np.concatenate(
                            [x.num_inflight for x in gm]).tolist(),
                        "param_max_abs_err": err, "identical": same}
        if not same or gpu.comm_totals["syncs"] < 1:
            emit({"phase": "tier_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's comm, ledger, flights or "
                             f"network time differ from the CPU's")
        if err > 1e-5:
            emit({"phase": "tier_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's parameters differ from "
                             f"the CPU's by {err}")
        if name == "hier g3 ring":
            # the card's checkpoint, continued on the CPU port
            cont = DecentralizedLearner(
                loss_fn, lambda g: params_from_numpy(init, g.device), m,
                proto, TrainConfig(optimizer="sgd", learning_rate=0.05),
                network=NetworkConfig(**net), device="cpu")
            cont.restore_state(*io.load_protocol_state(ckpt, device="cpu"))
            cont.restore_counters(io.load_counters(ckpt))
            cont.run_chunk({k: v[20:40] for k, v in batches.items()})
            cross = (cont.comm_totals == gpu.comm_totals
                     and np.array_equal(cont.per_link_bytes(),
                                        gpu.per_link_bytes())
                     and cont.network_time == gpu.network_time
                     and float((cont.X - gpu.X.cpu()).abs().max()) <= 1e-5)
            report["card checkpoint on the cpu"] = {"identical": cross}
            if not cross:
                raise SystemExit("a checkpoint written on the card does "
                                 "not continue on the CPU with the card's "
                                 "integers")
    rec = {"phase": "tier_agree", "cases": report}
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# the fault plane, robust sync and telemetry (slice 9)
# ---------------------------------------------------------------------------

# examples/faulty_fleet.py:47: 20% sign-flippers, 2-4 round crashes
FAULTS = dict(fault_seed=11, byzantine_frac=0.2, byzantine_mode="sign_flip",
              crash_prob=0.15, crash_every=16, outage_min=2, outage_max=4)
# tests/test_faults.py:112: crashes, NaN/Inf corruption, adversaries, bursts
HEAVY = dict(fault_seed=7, crash_prob=0.3, byzantine_frac=0.25,
             corrupt_prob=0.05, straggler_prob=0.3)
# benchmarks/robust_bench.py's median pipeline
MEDIAN = dict(name="robust_median", trigger="robust_divergence",
              cohort="all_reachable", aggregate="median", commit="quarantine")
FAULT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "fault_telemetry")


def _finite_class_close(got: torch.Tensor, want: torch.Tensor,
                        tol: float) -> tuple:
    """(the same entries finite, max |diff| over them): NaN and Inf are
    one class, since what a local step makes of a poisoned row depends
    on how the device's kernels carry non-finite values."""
    same = bool(torch.equal(torch.isfinite(got), torch.isfinite(want)))
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    return same and err <= tol, err


def phase_fault_train() -> dict:
    """mnist_cnn at full width, m = 100, B = 10, sgd lr 0.1, 60 rounds in
    chunks of 20, seed 0, under the fault plane: F1 dynamic and F2
    robust_dynamic (streamed to build/fault_telemetry/ with per-link
    bytes, profiling and the divergence series) under FAULTS, F3
    robust_periodic and F4 the median pipeline under HEAVY (NaN/Inf rows),
    F5 dynamic at FaultConfig(), which must be the faults=None run bit
    for bit. The sqdist_rows count is zeroed before each run and read
    after it: one launch per checked round (6), plus one divergence pass
    a round for F2 (60). Then one trimmed mean and one median at (100, P)
    are timed against their bytes bound."""
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init_fn = lambda g: init_cnn_params(cfg, g)          # noqa: E731
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    train = TrainConfig(optimizer="sgd", learning_rate=0.1)
    dyn = ProtocolConfig(kind="dynamic", b=PERIOD, delta=DELTA)
    checked = ROUNDS // PERIOD
    stream = os.path.join(FAULT_DIR, "F2.jsonl")
    plan = {   # name -> (protocol, faults, predicted launches, extra)
        "F1": (dyn, FAULTS, checked, {}),
        "F2": (ProtocolConfig(kind="robust_dynamic", b=PERIOD, delta=DELTA),
               FAULTS, checked + ROUNDS, dict(
                   track_divergence=True, telemetry=TelemetryConfig(
                       path=stream, per_link=True, profile=True))),
        "F3": (ProtocolConfig(kind="robust_periodic", b=PERIOD), HEAVY,
               checked, {}),
        "F4": (ProtocolSpec(**MEDIAN).with_params(b=PERIOD, delta=DELTA),
               HEAVY, checked, {}),
        "F5": (dyn, {}, checked, {}),
        "F5 faults=None": (dyn, None, checked, {}),
    }
    runs, counts, done = {}, {}, {}
    for name, (proto, fkw, want, extra) in plan.items():
        fcfg = None if fkw is None else FaultConfig(**fkw)

        def run():
            dl = DecentralizedLearner(loss_fn, init_fn, M, proto, train,
                                      seed=0, faults=fcfg, device="cuda",
                                      **extra)
            streams = LearnerStreams(src, M, batch=B, seed=0)
            metrics = [dl.run_chunk(streams.next_chunk(CHUNK))
                       for _ in range(ROUNDS // CHUNK)]
            return dl, metrics

        held = torch.cuda.memory_allocated()
        ops.reset_launches()
        (dl, metrics), ms, peak = _timed_run(run)
        counts[name] = ops.LAUNCHES["sqdist_rows"]
        if counts[name] != want:
            raise SystemExit(f"{name} launched sqdist_rows {counts[name]} "
                             f"times, predicted {want}")
        if dl.model_size != P_MNIST or not dl.X.is_cuda:
            raise SystemExit(f"{name}: {dl.model_size} weights on "
                             f"{dl.X.device}")
        series = {f: np.concatenate([np.asarray(getattr(x, f))
                                     for x in metrics]).tolist()
                  for f in ("num_faulty", "num_active", "num_quarantined",
                            "num_recovered")}
        if fcfg is not None:
            want_faulty = faults.sample_rounds(fcfg, M, range(ROUNDS)) \
                .num_faulty().tolist()
            if series["num_faulty"] != want_faulty:
                raise SystemExit(f"{name}: num_faulty {series['num_faulty']}"
                                 f" is not the schedule's {want_faulty}")
        # the learners the fault plane left honest and reachable at the
        # last round hold finite rows, and the reference row is finite
        # (the plain mean under FAULTS: no corruption, so all of it)
        if fcfg is not None and fkw:
            sched = faults.sample_rounds(fcfg, M, [ROUNDS - 1])
            ok = ~(sched.down()[0] | sched.byzantine | sched.corrupt[0])
        else:
            ok = np.ones(M, bool)
        finite_rows = torch.isfinite(dl.X).all(dim=1).cpu().numpy()
        if not (finite_rows[ok].all()
                and bool(torch.isfinite(dl.sync_state.ref).all())):
            raise SystemExit(f"{name}: an honest reachable row or the "
                             f"reference is not finite")
        runs[name] = {
            "faults": fkw, "ms_per_round": ms / ROUNDS,
            "peak_memory_bytes": peak - held, "held_before_bytes": held,
            "syncs": dl.comm_totals["syncs"],
            "full_syncs": dl.comm_totals["full_syncs"],
            "model_up": dl.comm_totals["model_up"],
            "comm_bytes": dl.comm_bytes(),
            "ledger_bytes": int(dl.per_link_bytes().sum()),
            "quarantined_learner_rounds": int(sum(series["num_quarantined"])),
            "recovered_total": int(sum(series["num_recovered"])),
            "cumulative_loss": dl.cumulative_loss,
            "honest_rows_finite": int(finite_rows[ok].sum()),
            "sqdist_rows": counts[name], **series}
        if runs[name]["ledger_bytes"] != dl.comm_bytes():
            raise SystemExit(f"{name}: the ledger does not balance")
        if name == "F2":
            dl.recorder.close()
            runs[name]["stream"] = check_fault_stream(dl, stream, series)
            runs[name]["divergence_last"] = float(metrics[-1].divergence[-1])
        if name.startswith("F5"):
            done[name] = dl
        else:
            del dl
    a, b = done["F5"], done["F5 faults=None"]
    f5_bitwise = (torch.equal(a.X, b.X) and a.comm_totals == b.comm_totals
                  and np.array_equal(a.per_link_bytes(), b.per_link_bytes())
                  and a.cumulative_loss == b.cumulative_loss
                  and torch.equal(a.sync_state.ref, b.sync_state.ref))
    plane = a.X
    del done, a, b
    aggregates = time_robust_aggregates(plane)
    del plane
    rec = {"phase": "fault_train", "m": M, "batch": B, "runs": runs,
           "f5_equals_faults_none_bitwise": f5_bitwise,
           "aggregates": aggregates}
    emit(rec)
    if not f5_bitwise:
        raise SystemExit("F5 (FaultConfig()) is not the faults=None run bit "
                         "for bit")
    for name in ("F2", "F3", "F4"):
        if runs[name]["quarantined_learner_rounds"] < 1:
            raise SystemExit(f"{name}: the quarantine never flagged a row")
    for name, r in runs.items():
        if r["syncs"] < 1:
            raise SystemExit(f"{name} never synced")
    return {k: v for k, v in counts.items() if k != "F5 faults=None"}


def check_fault_stream(dl, path: str, series: dict) -> dict:
    """F2's telemetry stream: it validates (``load_run``), holds 60 round
    records whose ``num_faulty`` / ``num_quarantined`` / ``num_recovered``
    are the run's own series, and its last ``cum_*`` are the live
    counters bit for bit."""
    run = load_run(path)
    rounds = run.rounds
    last = rounds[-1] if rounds else {}
    card = summarize(run)
    out = {"path": os.path.relpath(path, os.path.dirname(FAULT_DIR)),
           "round_records": len(rounds), "chunk_records": len(run.chunks),
           "fault_card": {k: v for k, v in card.get("faults", {}).items()
                          if not isinstance(v, list)},
           "profile": card.get("profile")}
    checks = {
        "60 round records": len(rounds) == ROUNDS,
        "num_faulty": [r.get("num_faulty") for r in rounds]
        == series["num_faulty"],
        "num_quarantined": [r.get("num_quarantined") for r in rounds]
        == series["num_quarantined"],
        "num_recovered": [r.get("num_recovered") for r in rounds]
        == series["num_recovered"],
        "cum_loss": last.get("cum_loss") == dl.cumulative_loss,
        "cum_net_time": last.get("cum_net_time") == dl.network_time,
        "cum_syncs": last.get("cum_syncs") == dl.comm_totals["syncs"],
        "cum_bytes": last.get("cum_bytes") == dl.comm_bytes(),
        "link_bytes_cum": run.chunks[-1]["link_bytes_cum"]
        == dl.per_link_bytes().tolist(),
        "per_link": all(sum(r["link_bytes"]) == r["round_bytes"]
                        for r in rounds),
        "divergence": all(math.isfinite(r["divergence"])
                          and r["divergence"] >= 0 for r in rounds)
        and any(r["divergence"] > 0 for r in rounds)}
    out["checks"] = checks
    if not all(checks.values()):
        emit({"phase": "fault_train", "failed": {"stream": out}})
        raise SystemExit(f"F2's telemetry stream is wrong: {checks}")
    return out


def time_robust_aggregates(X: torch.Tensor) -> dict:
    """One trimmed mean and one median over a (100, P) plane on the card,
    with its peak memory, beside the bytes bound (the plane read once,
    the row written once) and the sort alone."""
    mem_rate = peaks(torch.cuda.get_device_name(0))[0]
    m, P = X.shape
    mask = np.ones(m, bool)
    nbytes = (m * P + P) * 4
    bound = nbytes / mem_rate * 1e3
    out = {"shape": [m, P], "bytes": nbytes, "bound_ms": bound,
           "bound_by": "bytes"}
    for name, fn in (
            ("trimmed_mean", lambda: flat_trimmed_mean(X, mask, 0.2)),
            ("median", lambda: flat_median(X, mask)),
            ("sort", lambda: torch.sort(X, dim=0))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = cuda_ms(fn, iters=5, warmup=1)
        out[name] = {"ms": ms, "peak_bytes": peak,
                     "of_bound": bound / ms}
    return out


def phase_fault_agree() -> dict:
    """F1-F4's settings at the test width (drift_mlp smoke, m = 8, 32
    rounds in chunks of 16), plus async periodic and a hierarchy under
    HEAVY, on the card and on the CPU from the same model and batches:
    comm, ledger, every round's fault / active / quarantine / recovery
    counts and the health state identical; parameters finite alike and
    the finite ones within 1e-5."""
    cfg = get_arch("drift_mlp", smoke=True)
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init = params_to_numpy(init_cnn_params(cfg, torch.Generator()
                                           .manual_seed(5)))
    src = GraphicalModelStream(seed=1, drift_prob=0.0, device="cpu")
    edge = dict(link_classes=("lte", "edge"))
    cases = {   # name -> (protocol, faults, network, AsyncConfig)
        "F1 dynamic": (ProtocolConfig(kind="dynamic", b=2, delta=0.5),
                       FAULTS, None, None),
        "F2 robust_dynamic": (ProtocolConfig(kind="robust_dynamic", b=2,
                                             delta=0.5), FAULTS, None, None),
        "F3 robust_periodic": (ProtocolConfig(kind="robust_periodic", b=2),
                               HEAVY, None, None),
        "F4 median": (ProtocolSpec(**MEDIAN).with_params(b=2, delta=0.5),
                      HEAVY, None, None),
        "async periodic": (ProtocolConfig(kind="periodic", b=2), HEAVY, edge,
                           AsyncConfig(round_budget=1.0,
                                       payload_bytes=100_000)),
        "hierarchy": (ProtocolConfig(
            kind="dynamic", b=2, delta=0.3, tiers=HierarchyConfig(
                num_clusters=2, inter=ProtocolConfig(kind="dynamic", b=2,
                                                     delta=0.6))),
            HEAVY, None, None),
    }
    batches = src.sample(torch.Generator().manual_seed(7), 10, lead=(32, 8))
    report = {}
    fields = ("num_faulty", "num_active", "num_quarantined", "num_recovered",
              "num_inflight", "link_counts")
    for name, (proto, fkw, net, an) in cases.items():
        out = {}
        for dev in ("cpu", "cuda"):
            dl = DecentralizedLearner(
                loss_fn, lambda g: params_from_numpy(init, g.device), 8,
                proto, TrainConfig(optimizer="sgd", learning_rate=0.05),
                network=None if net is None else NetworkConfig(**net),
                async_net=an, faults=FaultConfig(**fkw), device=dev)
            metrics = [dl.run_chunk({k: v[i:i + 16].to(dev)
                                     for k, v in batches.items()})
                       for i in (0, 16)]
            out[dev] = (dl, {f: np.concatenate([np.asarray(getattr(x, f))
                                                for x in metrics])
                             for f in fields})
        (cpu, cs), (gpu, gs) = out["cpu"], out["cuda"]
        ecpu = (cpu.sync_state.extra if cpu.tiers is None
                else cpu.sync_state.intra.extra)
        egpu = (gpu.sync_state.extra if gpu.tiers is None
                else gpu.sync_state.intra.extra)
        close, err = _finite_class_close(gpu.X.cpu(), cpu.X, 1e-5)
        same = (gpu.comm_totals == cpu.comm_totals
                and np.array_equal(gpu.per_link_bytes(),
                                   cpu.per_link_bytes())
                and gpu.network_time == cpu.network_time
                and all(np.array_equal(gs[f], cs[f]) for f in fields)
                and sorted(egpu) == sorted(ecpu)
                and all(np.array_equal(egpu[k], ecpu[k]) for k in ecpu))
        report[name] = {"comm_totals": gpu.comm_totals,
                        "cpu_comm_totals": cpu.comm_totals,
                        "faulty_learner_rounds": int(gs["num_faulty"].sum()),
                        "quarantined_learner_rounds":
                            int(gs["num_quarantined"].sum()),
                        "param_max_abs_err_finite": err,
                        "identical": same, "params_close": close}
        if not same or gpu.comm_totals["syncs"] < 1:
            emit({"phase": "fault_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's integers differ from the "
                             f"CPU's")
        if not close:
            emit({"phase": "fault_agree", "failed": name, **report[name]})
            raise SystemExit(f"{name}: the card's parameters differ from "
                             f"the CPU's by {err}")
    rec = {"phase": "fault_agree", "cases": report}
    emit(rec)
    return rec


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
    torch.cuda.empty_cache()
    paper = run("paper_train", phase_paper_train)
    run("paper_agree", phase_paper_agree)
    net = run("net_train", phase_net_train)
    run("net_agree", phase_net_agree)
    tier = run("tier_train", phase_tier_train)
    run("tier_agree", phase_tier_agree)
    fault = run("fault_train", phase_fault_train)
    run("fault_agree", phase_fault_agree)
    emit({"phase_seconds": seconds, "total_seconds": sum(seconds.values())})
    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        {"name": "sqdist_rows", "route": "cuda", "source": csrc + "sqdist.cu",
         "replaces": "src/repro/kernels/sqdist.py:81",
         "launches": (launches["sqdist_rows"] + sum(paper.values())
                      + sum(net.values()) + sum(tier.values())
                      + sum(fault.values())),
         "launches_by_path": {"mnist dynamic": launches["sqdist_rows"],
                              **{k: v for k, v in paper.items()
                                 if k in ("deepdrive drift",
                                          "random augmentation")},
                              **{"network " + k: v for k, v in net.items()
                                 if v},
                              **{"tier " + k: v for k, v in tier.items()
                                 if v},
                              **{"fault " + k: v for k, v in fault.items()}},
         **table["sqdist_rows"],
         "at_deepdrive_width": table["sqdist_rows_deepdrive"],
         "grouped": table["sqdist_rows_grouped"]},
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
