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
the device time).

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
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.config import ProtocolConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.data.pipeline import LearnerStreams  # noqa: E402
from repro_torch.data.synthetic import SyntheticMNIST  # noqa: E402
from repro_torch.models.cnn import cnn_loss, init_cnn_params  # noqa: E402
from repro_torch.models.model import init_lm_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine, make_prefill  # noqa: E402

M, B, WARM, TRACED = 100, 10, 20, 20
RANGES = ("round.local_step", "round.optimizer", "round.sync")


def _busy_us(intervals) -> float:
    """Length of the union of [start, end] intervals."""
    busy, last = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > last:
            busy += b - max(a, last)
            last = b
    return busy


def profile_protocol(name: str, proto: ProtocolConfig) -> dict:
    cfg = get_arch("mnist_cnn")
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    streams = LearnerStreams(src, M, batch=B, seed=0)
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b), lambda g: init_cnn_params(cfg, g),
        M, proto, TrainConfig(optimizer="sgd", learning_rate=0.1),
        device="cuda")
    dl.run_chunk(streams.next_chunk(WARM))
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
        "protocol": name, "m": M, "batch": B, "rounds_traced": TRACED,
        "syncs_traced": dl.comm_totals["syncs"],
        "wall_ms_per_round": wall_us / TRACED / 1e3,
        "device_ms_per_round": device_us / TRACED / 1e3,
        "idle_share": 1.0 - device_us / wall_us,
        "range_device_ms_per_round": {k: v / 1e3 for k, v in ranges.items()},
        "kernels_launched": len(device),
        "top_kernels_ms_per_round": [
            [k[:90], us / TRACED / 1e3] for k, us in kernels[:12]],
    }


# kernel name -> kind, first match wins: "attention_kernel" names both
# attention programs (attention_kernel, attention_kernel_sm90) before
# "sm90_" claims cuBLAS's own kernels
KINDS = (("attention kernel", ("attention_kernel",)),
         ("ssd_scan kernel", ("ssd_scan_kernel",)),
         ("rmsnorm kernel", ("rmsnorm_kernel",)),
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_profile.py needs a CUDA device")
    for name, proto in (
            ("periodic", ProtocolConfig(kind="periodic", b=10)),
            ("dynamic", ProtocolConfig(kind="dynamic", b=10, delta=0.7))):
        print(json.dumps(profile_protocol(name, proto)), flush=True)
    torch.cuda.empty_cache()
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
