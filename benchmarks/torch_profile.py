"""Where the PyTorch port spends its time on the card.

    python3 benchmarks/torch_profile.py

Training: runs the configuration ``chip_smoke.py`` trains — the paper's
MNIST CNN at full width (1,199,882 weights), m = 100 learners, B = 10,
sgd lr 0.1 — under ``periodic b=10`` and ``dynamic b=10 Δ=0.7``, warms
each up for 20 rounds, then traces 20 rounds with ``torch.profiler``
(CPU and CUDA). For each protocol it prints one JSON line: the wall time
per round (host clock around work that ends in a synchronize), the
device time per round (the union of the traced CUDA kernels' and copies'
intervals), the card's idle share, the device time under each of the
round's named ranges (``round.local_step``, ``round.optimizer``,
``round.sync``), and the kernels that took the most device time (summed
durations; concurrent kernels overlap, so they can add up to more than
the device time). Then the deep-driving cells ``chip_smoke.py`` adds
(slice 6): deepdrive_cnn at full width (348,219 weights, 68x320x3
frames), m = 100, B = 10, sgd lr 0.05, under ``periodic b=10`` and
``dynamic b=2 Δ=0.3``, traced the same way, each line also giving the
ms a round of frames takes to draw on the card (CUDA events around
``next_chunk``, outside the trace).

Serving: the cells ``chip_smoke.py`` serves — llama3-8b at full width
and depth in bf16 — traced the same way after a warm-up: one prefill at
B = 4, S = 2,048, 8 decode steps of a batch-4 ``ServeEngine`` after a
32-token prompt, and one llama3-8b-swa prefill at B = 1, S = 16,384.
For each it prints one JSON line with the wall and device time, the idle
share, kernel launches, and the device time by kind of kernel: the
port's attention, ssd_scan and rmsnorm kernels, cuBLAS products, and the
rest. Then the Mamba2 cells, mamba2-2.7b at full width and depth in bf16
(what ``chip_smoke.py`` serves): one prefill at B = 4, S = 2,048 and 8
decode steps of a batch-4 ``ServeEngine`` after a 32-token prompt.

The last line is the card's name and power limit as ``nvidia-smi``
reports them. Needs a CUDA device; it imports nothing of JAX.

    python3 benchmarks/torch_profile.py --faults

traces only the MNIST cells of ``chip_smoke.py``'s ``fault_train``
(slice 9), the same way: dynamic b=10 Δ=0.7 with ``faults=None``, at
``FaultConfig()`` and under the crash and sign-flip schedule of
examples/faulty_fleet.py, and robust_dynamic under that schedule (the
trace covers rounds 21-40, so two of its syncs and their sorts). Each
line adds the device time under ``round.faults`` (the restart zeroing
and the perturbation) and the host-to-device copies a round.

    python3 benchmarks/torch_profile.py --lm-train

traces only the LM training cells of ``chip_smoke.py``'s ``lm_train``
(slice 14): five steps of fleet-llm-100m's dynamic run at m = 4 and one
σ_1 step each of llama3-8b, mamba2-2.7b and hymba-1.5b at full width (2
layers, f32, (1, 4096); slice 16 added the last two) and of
deepseek-v2-236b (1 layer, sgd, rematerialized layers; slice 18), each
after a warm-up, the port's backward kernels among the kinds; then
``ssd_scan_bwd`` at the two SSD cells' shapes by CUDA events and, per
CUDA launch, by ``torch.profiler`` (the walk, the chunks, the sums).

    python3 benchmarks/torch_profile.py --paper

traces only the training cells, the MNIST ones and the deep-driving
ones, and skips serving.

    python3 benchmarks/torch_profile.py --kernels [--src DIR]

times the kernels a round of kernel work changes, from the port under
``DIR`` (default: this checkout's ``src``), so that two trees can be
compared in one run on one card (say, an unpacked parent commit and
this one, in turns): ``sqdist`` at (1, 1,199,882) and ``sqdist_rows`` at
(100, 1,199,882) f32 beside ``vector_norm``, and ``ssd_scan`` at
mamba2-2.7b's serving tensor (320, 2048, 64, 128), chunk 64, f32, each
as 20 back-to-back calls between CUDA events (what ``chip_smoke.py``
reports, host time between launches included), as the host's own time
per call by its clock, and as device time, CUDA launches and the host's
time inside them per call from ``torch.profiler``
(``repro_torch/kernels/_timing.py``, always this checkout's); also
``sqdist``'s C entry point called alone, so that the wrapper's host
time and the launches' can be told apart; ``ssd_scan_bwd`` at the two SSD
training cells' shapes (mamba2-2.7b's (80, 4096, 64, 128) and
hymba-1.5b's (50, 4096, 64, 16), chunk 64, one row of b and c), by CUDA
events and each CUDA launch's device time, naming the tree's
``BWD_PROGRAM``; ``rmsnorm`` at (4, 2048, d)
bf16 for every width d a full-size config norms, on inputs that have
left the L2, and f32 attention at the layouts
``chip_smoke.py`` times (llama3-8b's, MLA's, musicgen's, llama3-405b's,
hymba's window and llama3-8b-swa's S = 16,384, w = 8,192), each beside one PyTorch call (``F.rms_norm``, SDPA
in f32) by CUDA events and profiler device time; then mamba2-2.7b prefills at
B = 4, S = 2,048 in bf16 by CUDA events after a 128-token warm-up: the
first full-size call (``first_ms``, what ``chip_smoke.py`` reports) and
two more (``steady_ms``). One JSON line each.

    python3 benchmarks/torch_profile.py --decode [--src DIR]

times the serving phase's decode from the port under ``DIR`` (default:
this checkout's ``src``), so that two trees can be compared in one run:
llama3-8b and mamba2-2.7b at full width and depth in bf16, a batch-4
``ServeEngine`` fed a 32-token prompt, then 32 greedy steps between CUDA
events (``chip_smoke.py``'s ``decode_ms_per_step``), in seven fresh
engines after one for the warm-up (median and least); and the host's µs
in one call of the ``ops`` wrappers, by its clock over 500 calls (fewer
than the launch queue holds), nine times (median and least), in turns
with the kernel module's launcher alone (the least of each, and their
difference, the wrapper's own time): ``rmsnorm`` at (4, 4096) bf16 (a
decode step's norm), ``flash_attention_gqa`` at (1, 128, 32/8, 128)
bf16 and ``sqdist_rows`` at (2, 1,199,882) f32. The host's clock is
shared with other work on a one-card machine, so the least is the
steadier figure, and a difference within one process the steadiest.
One JSON line each.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

KERNELS_ONLY = "--kernels" in sys.argv[1:]
PAPER_ONLY = "--paper" in sys.argv[1:]
FAULTS_ONLY = "--faults" in sys.argv[1:]
LM_TRAIN_ONLY = "--lm-train" in sys.argv[1:]
DECODE_ONLY = "--decode" in sys.argv[1:]
OWN_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
SRC = (sys.argv[sys.argv.index("--src") + 1] if "--src" in sys.argv[1:]
       else OWN_SRC)
sys.path.insert(0, os.path.abspath(SRC))


def _own_timing():
    """The port's timing module from this checkout, whatever ``--src``
    names, so that both trees of a comparison are timed by the same
    code."""
    path = os.path.join(OWN_SRC, "repro_torch", "kernels", "_timing.py")
    spec = importlib.util.spec_from_file_location("_own_timing", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_timing = _own_timing()

from repro_torch.config import (  # noqa: E402
    FaultConfig, ProtocolConfig, TrainConfig, get_arch,
)
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.data.pipeline import LearnerStreams  # noqa: E402
from repro_torch.data.synthetic import DeepDriveStream, SyntheticMNIST  # noqa: E402
from repro_torch.models.cnn import cnn_loss, init_cnn_params  # noqa: E402
from repro_torch.models.model import init_lm_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine, make_prefill  # noqa: E402

M, B, WARM, TRACED = 100, 10, 20, 20
RANGES = ("round.local_step", "round.optimizer", "round.sync",
          "round.faults")
# examples/faulty_fleet.py:47: 20% sign-flippers, 2-4 round crashes
FAULTS = dict(fault_seed=11, byzantine_frac=0.2, byzantine_mode="sign_flip",
              crash_prob=0.15, crash_every=16, outage_min=2, outage_max=4)


def _busy_us(intervals) -> float:
    """Length of the union of [start, end] intervals."""
    busy, last = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > last:
            busy += b - max(a, last)
            last = b
    return busy


def profile_protocol(name: str, proto: ProtocolConfig,
                     arch: str = "mnist_cnn", lr: float = 0.1,
                     faults=None) -> dict:
    cfg = get_arch(arch)
    src = (DeepDriveStream(seed=1, device="cuda") if arch == "deepdrive_cnn"
           else SyntheticMNIST(seed=0, image_size=28, device="cuda"))
    streams = LearnerStreams(src, M, batch=B, seed=0)
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b), lambda g: init_cnn_params(cfg, g),
        M, proto, TrainConfig(optimizer="sgd", learning_rate=lr),
        faults=faults, device="cuda")
    dl.run_chunk(streams.next_chunk(WARM))
    draw = _timing.cuda_ms(lambda: streams.next_chunk(TRACED), iters=1,
                           warmup=0)
    batches = streams.next_chunk(TRACED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dl.run_chunk(batches)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    # device work: kernels, copies and sets. The GPU-side copies of the
    # named ranges are annotations spanning those kernels, not work.
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name not in RANGES]
    per_kernel: dict = {}
    for e in device:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    device_us = _busy_us((e.time_range.start, e.time_range.end)
                         for e in device)
    # each host-side range: the device time of the kernels launched in it
    ranges = {k: 0.0 for k in RANGES}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in RANGES:
            ranges[e.name] += e.device_time_total / TRACED
    return {
        "protocol": name, "arch": arch, "m": M, "batch": B,
        "faults": None if faults is None else {
            k: v for k, v in vars(faults).items()
            if v != getattr(FaultConfig(), k)},
        "rounds_traced": TRACED,
        "draw_ms_per_round": draw / TRACED,
        "syncs_traced": dl.comm_totals["syncs"],
        "wall_ms_per_round": wall_us / TRACED / 1e3,
        "device_ms_per_round": device_us / TRACED / 1e3,
        "idle_share": 1.0 - device_us / wall_us,
        "range_device_ms_per_round": {k: v / 1e3 for k, v in ranges.items()},
        "kernels_launched": len(device),
        "htod_copies_per_round": sum("HtoD" in e.name
                                     for e in device) / TRACED,
        "top_kernels_ms_per_round": [
            [k[:90], us / TRACED / 1e3] for k, us in kernels[:12]],
    }


# kernel name -> kind, first match wins: "attention_kernel" names both
# attention programs (attention_kernel, attention_kernel_sm90) before
# "sm90_" claims cuBLAS's own kernels
KINDS = (("attention kernel", ("attention_kernel",)),
         ("attention_bwd kernel", ("attention_bwd_",)),
         ("ssd_scan_bwd kernel", ("ssd_scan_bwd_",)),
         ("ssd_scan kernel", ("ssd_scan_",)),
         ("rmsnorm kernel", ("rmsnorm_kernel",)),
         ("rmsnorm_bwd kernel", ("rmsnorm_bwd_",)),
         ("cuBLAS products", ("nvjet", "gemm", "gemv", "xmma", "cutlass",
                              "sm90_")))


def _trace(fn, steps: int = 1) -> dict:
    """Trace ``fn()``: wall and device ms per step, idle share, launches
    and device ms by kind of kernel, the heaviest kernels."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kinds = {k: 0.0 for k, _ in KINDS}
    kinds["other"] = 0.0
    per_kernel: dict = {}
    for e in device:
        us = e.time_range.end - e.time_range.start
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + us
        kind = next((k for k, keys in KINDS
                     if any(key in e.name for key in keys)), "other")
        kinds[kind] += us
    device_us = _busy_us((e.time_range.start, e.time_range.end)
                         for e in device)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_ms_per_step": device_us / steps / 1e3,
            "idle_share": 1.0 - device_us / wall_us,
            "launches_per_step": len(device) / steps,
            "device_ms_per_step_by_kind": {
                k: v / steps / 1e3 for k, v in kinds.items()},
            "top_kernels_ms_per_step": [[k[:90], us / steps / 1e3]
                                        for k, us in top]}


def profile_serve() -> list:
    cfg, cfg_swa = get_arch("llama3-8b"), get_arch("llama3-8b-swa")
    params = init_lm_params(cfg, seed=0, dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g,
                           device="cuda")
    prefill, prefill_swa = make_prefill(cfg), make_prefill(cfg_swa)
    prefill(params, tokens[:, :128])                    # warm-up
    out = [{"cell": "llama3-8b prefill B=4 S=2048",
            **_trace(lambda: prefill(params, tokens))}]
    eng = ServeEngine(cfg, params, max_seq=48, batch=4,
                      dtype=torch.bfloat16)
    logits = eng.feed(tokens[:, :32])
    eng.generate(2, first_logits=logits)                # warm-up
    out.append({"cell": "llama3-8b decode batch 4, cache 34-41",
                **_trace(lambda: eng.generate(8, first_logits=logits), 8)})
    del eng
    swa_tokens = torch.randint(0, cfg.vocab_size, (1, 16384), generator=g,
                               device="cuda")
    out.append({"cell": "llama3-8b-swa prefill B=1 S=16384",
                **_trace(lambda: prefill_swa(params, swa_tokens))})
    return out


def profile_ssm_serve() -> list:
    cfg = get_arch("mamba2-2.7b")
    params = init_lm_params(cfg, seed=0, dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g,
                           device="cuda")
    prefill = make_prefill(cfg)
    prefill(params, tokens[:, :128])                    # warm-up
    out = [{"cell": "mamba2-2.7b prefill B=4 S=2048",
            **_trace(lambda: prefill(params, tokens))}]
    eng = ServeEngine(cfg, params, max_seq=48, batch=4,
                      dtype=torch.bfloat16)
    logits = eng.feed(tokens[:, :32])
    eng.generate(2, first_logits=logits)                # warm-up
    out.append({"cell": "mamba2-2.7b decode batch 4, after 34 tokens",
                **_trace(lambda: eng.generate(8, first_logits=logits), 8)})
    return out


def profile_lm_train() -> list:
    """The LM training cells of ``chip_smoke.py``'s ``lm_train``, traced
    after a warm-up: fleet-llm-100m at m = 4 under
    ``make_dynamic_train_step`` (b = 10, Δ = 5; 3 warm-up steps, then 5
    traced) and one σ_1 ``make_train_step`` step each (1 warm-up step),
    f32, (1, 4096), at full width: llama3-8b, mamba2-2.7b and hymba-1.5b
    at 2 layers with adam, deepseek-v2-236b at 1 of 60 with sgd and
    rematerialized layers."""
    import dataclasses
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "examples"))
    from torch_fleet_llm import fleet_model, stacked_batch
    from repro_torch import prng
    from repro_torch.core import distributed
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.model import lm_loss
    from repro_torch.train import make_train_step
    out = []
    cfg = fleet_model(big=True)
    streams = [TokenStream(seed=100 + i, vocab=cfg.vocab_size,
                           device="cuda") for i in range(4)]
    batches = [stacked_batch(streams, prng.fold_in(prng.key(1), t),
                             "cuda") for t in range(8)]
    del streams
    train = TrainConfig(optimizer="adam", learning_rate=3e-4, remat=False)
    step = distributed.make_dynamic_train_step(
        lambda p, b: lm_loss(cfg, p, b, remat=train.remat),
        ProtocolConfig(kind="dynamic", b=10, delta=45.0), train, 4)
    init = init_lm_params(cfg, seed=0, device="cuda")
    state = distributed.init_dynamic_state(
        lambda g: init, torch.Generator(device="cuda").manual_seed(0), 4,
        train, device="cuda")
    for b in batches[:3]:
        state, _ = step(state, b)

    def fleet_steps():
        nonlocal state
        for b in batches[3:]:
            state, _ = step(state, b)

    out.append({"cell": "fleet-llm-100m dynamic m=4, 4x128 tokens a "
                        "learner", **_trace(fleet_steps, 5)})
    del state, init, step, batches
    torch.cuda.empty_cache()

    adam = TrainConfig(optimizer="adam", learning_rate=1e-3, remat=False)
    # deepseek-v2-236b: the reference's production train program (sgd,
    # rematerialized layers), chip_smoke.py's LM_MOE_LAYERS and LM_MOE_LR
    sgd = TrainConfig(optimizer="sgd", learning_rate=0.1, remat=True)
    for arch, layers, train in (
            ("llama3-8b", 2, adam), ("mamba2-2.7b", 2, adam),
            ("hymba-1.5b", 2, adam), ("deepseek-v2-236b", 1, sgd)):
        full = get_arch(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        init_state, step = make_train_step(
            lambda p, b, cfg=cfg, train=train: lm_loss(
                cfg, p, b, remat=train.remat), train)
        state = init_state(init_lm_params(cfg, seed=0, device="cuda"))
        toks = prng.randint(prng.key(3), (1, 4097), 0,
                            cfg.vocab_size).long()
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        state, _ = step(state, batch)

        def one_step():
            nonlocal state
            state, _ = step(state, batch)

        out.append({"cell": f"{arch} train step, {layers} of "
                            f"{full.num_layers} layers, f32, (1, 4096), "
                            f"{train.optimizer}"
                            + (", remat" if train.remat else ""),
                    **_trace(one_step)})
        del state, init_state, step
        torch.cuda.empty_cache()
    return out + _ssd_bwd_launches()


def _ssd_bwd_launches() -> list:
    """``ssd_scan_bwd`` at mamba2-2.7b's and hymba-1.5b's training shapes
    (one layer, B = 1, S = 4,096, chunk 64, one row of B and C): CUDA
    events over back-to-back calls and each CUDA launch's device time."""
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_scan
    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for BH, N in ((80, 128), (50, 16)):
        S, P, Q = 4096, 64, 64
        x, dy = (torch.randn((BH, S, P), generator=g, device="cuda")
                 for _ in range(2))
        dt = F.softplus(torch.randn((BH, S), generator=g, device="cuda"))
        a = -torch.exp(torch.randn((BH,), generator=g, device="cuda"))
        b, c = (torch.randn((1, S, N), generator=g, device="cuda")
                for _ in range(2))
        _, _, states = ssd_scan.ssd_scan(x, dt, a, b, c, chunk=Q,
                                         keep_states=True)

        def bwd():
            return ssd_scan.ssd_scan_bwd(x, dt, a, b, c, states, dy, None,
                                         chunk=Q)
        out.append({"src": SRC,
                    "case": f"ssd_scan_bwd ({BH}, {S}, {P}, {N}), chunk "
                            f"{Q}, {BH} heads a row, f32",
                    "program": getattr(ssd_scan, "BWD_PROGRAM", None),
                    "events_ms": _timing.cuda_ms(bwd, 5, 1),
                    **_timing.profile_calls(bwd, 3)})
        del x, dy, dt, a, b, c, states
        torch.cuda.empty_cache()
    return out


def _bare_sqdist(sqdist, x, r):
    """``sqdist``'s C entry point called directly on (1, P), its buffers
    made once: the host's cost of the ``ctypes`` call and its launches
    without the Python wrapper. Takes both forms of
    ``repro_sqdist_rows``: two launches, one with the ticket counters,
    or that with the reference rows' group size (1 here)."""
    from repro_torch.kernels import _build
    lib = _build.library("sqdist")
    P = x.numel()
    S = sqdist.num_splits(1, P, sqdist._sm_count(x.device.index))
    seg = -(-P // S)
    S = -(-P // seg)
    partial = torch.empty((S,), dtype=torch.float32, device=x.device)
    out = torch.empty((1,), dtype=torch.float32, device=x.device)
    tickets = torch.zeros((1,), dtype=torch.int32, device=x.device)
    args = [0, x.data_ptr(), r.data_ptr(), partial.data_ptr(),
            out.data_ptr()]
    nargs = len(lib.repro_sqdist_rows.argtypes)
    if nargs >= 11:
        args.append(tickets.data_ptr())
    args += [1, P, seg, S] + ([1] if nargs == 12 else [])
    args.append(torch.cuda.current_stream().cuda_stream)
    _build.check(lib, lib.repro_sqdist_rows(*args), "sqdist launch")
    torch.cuda.synchronize()
    if not torch.equal(out[0], sqdist.sqdist(x, r)):
        raise SystemExit("the bare sqdist call disagrees with the wrapper")

    def call():
        lib.repro_sqdist_rows(*args)
    # the launches take raw pointers: the buffers live as long as the call
    call.buffers = (partial, out, tickets)
    return call


# f32 attention layouts: (B, S, H, Hkv, d, dv, window), causal
ATTN_F32 = ((4, 2048, 32, 8, 128, 128, 0), (4, 2048, 128, 128, 192, 128, 0),
            (4, 2048, 32, 32, 64, 64, 0), (4, 2048, 128, 8, 128, 128, 0),
            (4, 2048, 25, 5, 64, 64, 1024), (1, 16384, 32, 8, 128, 128, 8192))


def profile_norm_and_f32_attention(F, g) -> list:
    """``rmsnorm`` and f32 attention beside one PyTorch call each: CUDA
    events over back-to-back calls and the profiler's device time.
    rmsnorm takes its x from copies that have left the L2 by their turn
    (``_timing.cold_inputs``), as between a model's products, and is
    also timed in a CUDA graph (``_timing.graph_ms``)."""
    from repro_torch.config import norm_widths
    from repro_torch.kernels import flash_attention, rmsnorm
    out = []

    def rec(name, fn, iters, **extra):
        out.append({"src": SRC, "case": name,
                    "events_ms": _timing.cuda_ms(fn, iters, 1),
                    "device_ms": _timing.profile_calls(
                        fn, max(2, iters // 4))["device_ms"], **extra})

    def rec_norm(name, fn, n):
        rec(name, fn, 20, cold_inputs=n, graph_ms=_timing.graph_ms(fn))
    for d in norm_widths():
        xs = _timing.cold_inputs(lambda: torch.randn(
            (4, 2048, d), generator=g, device="cuda").bfloat16(),
            2 * 4 * 2048 * d * 2)
        s = torch.randn((d,), generator=g, device="cuda").bfloat16()
        rec_norm(f"rmsnorm (4, 2048, {d}) bf16", _timing.in_turn(
            lambda x: rmsnorm.rmsnorm(x, s, 1e-5), xs), len(xs))
        rec_norm(f"F.rms_norm (4, 2048, {d}) bf16", _timing.in_turn(
            lambda x: F.rms_norm(x, (d,), weight=s, eps=1e-5), xs), len(xs))
        del xs
    for B, S, H, Hkv, d, dv, w in ATTN_F32:
        q = torch.randn((B, S, H, d), generator=g, device="cuda")
        k = torch.randn((B, S, Hkv, d), generator=g, device="cuda")
        v = torch.randn((B, S, Hkv, dv), generator=g, device="cuda")
        qT = q.transpose(1, 2)
        kT, vT = (t.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                  for t in (k, v))
        i = torch.arange(S, device="cuda")
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
        shape = f"({B}, {S}, {H}/{Hkv}, {d}/{dv}" + (f", w {w})" if w
                                                      else ")")
        rec(f"flash_attention_gqa {shape} f32",
            lambda: flash_attention.flash_attention_gqa(q, k, v, window=w), 3)
        rec(f"SDPA {shape} f32, kv heads expanded",
            lambda: F.scaled_dot_product_attention(
                qT, kT, vT, **({"attn_mask": band} if w else
                               {"is_causal": True})), 3)
        del q, k, v, kT, vT
    torch.cuda.empty_cache()
    return out


def profile_kernels() -> list:
    import torch.nn.functional as F
    from repro_torch.kernels import sqdist, ssd_scan
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((100, 1_199_882), generator=g, device="cuda")
    r = torch.randn((1_199_882,), generator=g, device="cuda")
    x0 = X[0]
    BH, S, P, N = 320, 2048, 64, 128
    xs, dts = (torch.randn((BH, S, P), generator=g, device="cuda"),
               F.softplus(torch.randn((BH, S), generator=g, device="cuda")))
    a = -torch.exp(torch.randn((BH,), generator=g, device="cuda"))
    b, c = (torch.randn((4, S, N), generator=g, device="cuda")
            for _ in range(2))
    cases = {
        "sqdist (1, 1199882) f32": lambda: sqdist.sqdist(x0, r),
        "sqdist's C entry point alone, (1, 1199882) f32":
            _bare_sqdist(sqdist, x0, r),
        "vector_norm(x0 - r).square()":
            lambda: torch.linalg.vector_norm(x0 - r).square(),
        "sqdist_rows (100, 1199882) f32": lambda: sqdist.sqdist_rows(X, r),
        "vector_norm(X - r, dim=1).square()":
            lambda: torch.linalg.vector_norm(X - r, dim=1).square(),
        "ssd_scan (320, 2048, 64, 128) chunk 64 f32, 80 heads per row":
            lambda: ssd_scan.ssd_scan(xs, dts, a, b, c, chunk=64),
    }
    out = []
    for name, fn in cases.items():
        out.append({"src": SRC, "case": name,
                    "events_ms": _timing.cuda_ms(fn),
                    "host_us": _timing.host_us(fn),
                    **_timing.profile_calls(fn)})
    del X, xs, dts, b, c
    torch.cuda.empty_cache()
    out += _ssd_bwd_launches()
    out += profile_norm_and_f32_attention(F, g)
    cfg = get_arch("mamba2-2.7b")
    params = init_lm_params(cfg, seed=0, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g,
                           device="cuda")
    prefill = make_prefill(cfg)
    prefill(params, tokens[:, :128])                    # warm-up
    ms = [_timing.cuda_ms(lambda: prefill(params, tokens), 1, 0)
          for _ in range(3)]
    torch.cuda.reset_peak_memory_stats()
    prefill(params, tokens)
    torch.cuda.synchronize()
    out.append({"src": SRC, "case": "mamba2-2.7b prefill B=4 S=2048 bf16",
                "first_ms": ms[0], "steady_ms": ms[1:], "peak_memory_bytes":
                torch.cuda.max_memory_allocated()})
    return out


def profile_decode() -> list:
    """``--decode``: the serving decode's ms a step and the wrappers'
    host µs a call, from the port under ``SRC``."""
    from repro_torch.kernels import flash_attention, ops, rmsnorm, sqdist
    prompt, gen, engines, repeats = 32, 32, 7, 9
    out = []
    for arch in ("llama3-8b", "mamba2-2.7b"):
        cfg = get_arch(arch)
        params = init_lm_params(cfg, seed=0, dtype=torch.bfloat16)
        g = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (4, prompt), generator=g,
                               device="cuda")
        ms = []
        for _ in range(engines + 1):
            eng = ServeEngine(cfg, params, max_seq=prompt + gen + 1,
                              batch=4, dtype=torch.bfloat16)
            first = eng.feed(tokens)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            eng.generate(gen, first_logits=first)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end) / gen)
            del eng, first
        out.append({"src": SRC, "case": f"{arch} decode batch 4 bf16, "
                    f"{gen} steps after a {prompt}-token prompt",
                    "decode_ms_per_step": sorted(ms[1:])[engines // 2],
                    "decode_ms_per_step_min": min(ms[1:]),
                    "decode_ms_per_step_each": ms[1:]})
        del params
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(0)
    x, s = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
            for shape in ((4, 4096), (4096,)))
    q = torch.randn((1, 128, 32, 128), generator=g, device="cuda").to(
        torch.bfloat16)
    kv = torch.randn((1, 128, 8, 128), generator=g, device="cuda").to(
        torch.bfloat16)
    X = torch.randn((2, 1_199_882), generator=g, device="cuda")
    r = torch.randn((1_199_882,), generator=g, device="cuda")
    # each ops wrapper and its kernel module's launcher alone, in turns in
    # one process: the difference is the wrapper's own host time (the
    # placement checks and the launch count), which the process's state
    # moves less than either
    for name, wrapper, alone in (
            ("rmsnorm (4, 4096) bf16", lambda: ops.rmsnorm(x, s),
             lambda: rmsnorm.rmsnorm(x, s)),
            ("flash_attention_gqa (1, 128, 32/8, 128) bf16",
             lambda: ops.flash_attention_gqa(q, kv, kv),
             lambda: flash_attention.flash_attention_gqa(q, kv, kv)),
            ("sqdist_rows (2, 1199882) f32", lambda: ops.sqdist_rows(X, r),
             lambda: sqdist.sqdist_rows(X, r))):
        us = {"ops": [], "alone": []}
        for _ in range(repeats):
            us["ops"].append(_timing.host_us(wrapper, 500, 20))
            us["alone"].append(_timing.host_us(alone, 500, 20))
        out.append({"src": SRC, "case": name,
                    "host_us": sorted(us["ops"])[repeats // 2],
                    "host_us_min": min(us["ops"]),
                    "module_alone_host_us_min": min(us["alone"]),
                    "wrapper_us": min(us["ops"]) - min(us["alone"]),
                    "host_us_each": us})
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_profile.py needs a CUDA device")
    if DECODE_ONLY:
        for rec in profile_decode():
            print(json.dumps(rec), flush=True)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        return
    if KERNELS_ONLY:
        for rec in profile_kernels():
            print(json.dumps(rec), flush=True)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        return
    if LM_TRAIN_ONLY:
        for rec in profile_lm_train():
            print(json.dumps(rec), flush=True)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        return
    if FAULTS_ONLY:
        dyn = ProtocolConfig(kind="dynamic", b=10, delta=0.7)
        for name, proto, faults in (
                ("dynamic", dyn, None), ("dynamic", dyn, FaultConfig()),
                ("dynamic", dyn, FaultConfig(**FAULTS)),
                ("robust_dynamic", ProtocolConfig(kind="robust_dynamic",
                                                  b=10, delta=0.7),
                 FaultConfig(**FAULTS))):
            print(json.dumps(profile_protocol(name, proto, faults=faults)),
                  flush=True)
            torch.cuda.empty_cache()
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        return
    for name, proto, arch, lr in (
            ("periodic", ProtocolConfig(kind="periodic", b=10), "mnist_cnn",
             0.1),
            ("dynamic", ProtocolConfig(kind="dynamic", b=10, delta=0.7),
             "mnist_cnn", 0.1),
            ("periodic", ProtocolConfig(kind="periodic", b=10),
             "deepdrive_cnn", 0.05),
            ("dynamic", ProtocolConfig(kind="dynamic", b=2, delta=0.3),
             "deepdrive_cnn", 0.05)):
        print(json.dumps(profile_protocol(name, proto, arch, lr)),
              flush=True)
        torch.cuda.empty_cache()
    if not PAPER_ONLY:
        for rec in profile_serve():
            print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
        for rec in profile_ssm_serve():
            print(json.dumps(rec), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
