"""Where a round of the PyTorch port spends its time on the card.

    python3 benchmarks/torch_profile.py

Runs the configuration ``chip_smoke.py`` trains — the paper's MNIST CNN at
full width (1,199,882 weights), m = 100 learners, B = 10, sgd lr 0.1 —
under ``periodic b=10`` and ``dynamic b=10 Δ=0.7``, warms each up for 20
rounds, then traces 20 rounds with ``torch.profiler`` (CPU and CUDA). For
each protocol it prints one JSON line: the wall time per round (host
clock around work that ends in a synchronize), the device time per round
(the union of the traced CUDA kernels' and copies' intervals), the card's
idle share,
the device time under each of the round's named ranges
(``round.local_step``, ``round.optimizer``, ``round.sync``), and the
kernels that took the most device time (summed durations; concurrent
kernels overlap, so they can add up to more than the device time). The
last line is the card's name
and power limit as ``nvidia-smi`` reports them. Needs a CUDA device; it
imports nothing of JAX.
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_profile.py needs a CUDA device")
    for name, proto in (
            ("periodic", ProtocolConfig(kind="periodic", b=10)),
            ("dynamic", ProtocolConfig(kind="dynamic", b=10, delta=0.7))):
        print(json.dumps(profile_protocol(name, proto)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
