"""Timing of calls on the card, shared by ``chip_smoke.py``,
``benchmarks/torch_profile.py`` and the card-only tests, so that the
times and launch counts they report and check come from one piece of
code. Imports only torch; the profiler is imported where it runs.
"""
from __future__ import annotations

import itertools
import re
import time

import torch

L2_BYTES = 50 * 2 ** 20     # an H100's L2 cache


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn()`` over ``iters`` back-to-back calls between CUDA
    events, after ``warmup`` calls. Where a call's host work takes longer
    than its device work, the card waits and this is the host's time."""
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


def graph_ms(fn, calls: int = 10, replays: int = 5) -> float:
    """Mean ms of one ``fn()`` with ``calls`` of them captured in one CUDA
    graph, replayed ``replays`` times between CUDA events: the device's
    time alone, with no host time between launches, and each call paying
    for the writes the call before left in the L2, which a profiler's
    kernel interval leaves out. ``fn`` must launch on the current stream
    and not synchronize; the outputs of the captured calls stay in the
    graph's memory until it goes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    torch.cuda.empty_cache()
    return ms


def cold_inputs(make, nbytes: int) -> list:
    """Copies made by ``make()`` of an input that a call moves ``nbytes``
    with (its reads and writes): enough that the other copies' calls
    between two turns of one move at least twice ``L2_BYTES``, so that a
    call of ``in_turn`` over them reads its input from device memory, as
    a model's norm between two matrix products does."""
    return [make() for _ in range(2 + 2 * L2_BYTES // nbytes)]


def in_turn(fn, inputs: list):
    """A call of ``fn`` on the next of ``inputs`` each time, round."""
    it = itertools.cycle(inputs)
    return lambda: fn(next(it))


def host_us(fn, calls: int = 200, warmup: int = 3) -> float:
    """Mean µs the host spends in one call of ``fn()``, by its own clock
    over ``calls`` calls with no synchronization among them. The device
    may lag behind without holding the host back while the launch queue
    has room (about a thousand launches), so this is the host's work
    alone, whichever side is slower."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def profile_calls(fn, calls: int = 10) -> dict:
    """Per call of ``fn()``, from ``torch.profiler`` over ``calls`` calls
    after a warm-up call: ``device_ms``, the device work alone (kernels,
    copies and sets, summed), without the host time between launches that
    ``cuda_ms`` includes; ``cuda_launches_per_call``, the host's
    ``cudaLaunchKernel`` calls; ``launch_host_us_per_call``, the host's
    time inside them (the profiler's own callbacks included, so an upper
    bound); ``kernels_us``, each kernel's device time by name, in the
    order the kernels first ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    launches, launch_us = 0, 0.0
    for e in prof.events():
        us = e.time_range.end - e.time_range.start
        if e.device_type == DeviceType.CPU:
            if e.name.startswith("cudaLaunchKernel"):
                launches += 1
                launch_us += us
            continue
        name = re.sub(r"^void |\(.*$", "",
                      e.name.replace("(anonymous namespace)::", ""))
        by_name[name] = by_name.get(name, 0.0) + us / calls
    return {"device_ms": sum(by_name.values()) / 1e3,
            "cuda_launches_per_call": launches / calls,
            "launch_host_us_per_call": launch_us / calls,
            "kernels_us": by_name}
