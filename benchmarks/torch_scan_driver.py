"""The chunked round driver against per-round dispatch — the twin of
``benchmarks/scan_driver.py`` on ``repro_torch``.

Runs the dynamic-averaging protocol (the smoke MNIST CNN, m = 8, b = 5,
Delta = 0.7) for 200 rounds twice from identical state: once through the
per-round ``DecentralizedLearner.step`` loop (one round a call, with the
host's counter fold and transfers each round) and once through
``run_chunk`` (a chunk of 100 rounds a call). Both draw their data in
chunks of 100 rounds (``LearnerStreams.next_chunk``) from streams of
the same seed, so both train on the same samples: the port's draws
depend on how many rounds a call draws, where the reference's per-round
keys do not. The two drivers
must agree: comm counters equal, parameters within rtol 1e-5 / atol
1e-6, cumulative losses within 1e-5 relative. It reports the cold (first
run) and warm (a second 200 rounds on each driver's own stream) seconds
of both.

Where the port differs: the reference compares one compiled
``lax.scan`` program against a jitted dispatch a round, and claims a
warm speedup of at least 5. The port runs eagerly either way:
``run_chunk`` saves a round's call and its host transfers and counter
fold, not a compilation, so ``warm_speedup`` is reported as measured and
the check, unchanged, may say MIXED.
"""
from __future__ import annotations

import time

import torch

from benchmarks.torch_common import (
    finish, mnist_setup, mnist_source, save_rows,
)
from repro_torch.config import ProtocolConfig, TrainConfig
from repro_torch.core.protocol import DecentralizedLearner
from repro_torch.data.pipeline import LearnerStreams

NAME = "scan_driver"
PAPER_REF = "ISSUE 1 tentpole (scanned protocol engine)"

M, B_CHECK, DELTA, CHUNK = 8, 5, 0.7, 100

ARCH = "mnist_cnn"
# the cut rows that tests/test_torch_bench_cuts.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds,
# {"driver": "loop" or "scan"})
# (Delta 0.3: 20 rounds at 0.7 sync no learner)
CUT = ((dict(kind="dynamic", b=B_CHECK, delta=0.3), M, 20,
        dict(driver="loop")),
       (dict(kind="dynamic", b=B_CHECK, delta=0.3), M, 20,
        dict(driver="scan")))
default_source = mnist_source


def _make(device, source=None, init_fn=None, delta=DELTA):
    _, loss_fn, default_init = mnist_setup()
    src = default_source(device) if source is None else source
    streams = LearnerStreams(src, M, batch=10, seed=0)
    dl = DecentralizedLearner(
        loss_fn, init_fn or default_init, M,
        ProtocolConfig(kind="dynamic", b=B_CHECK, delta=delta),
        TrainConfig(optimizer="sgd", learning_rate=0.1), device=device)
    return streams, dl



def _loop_rounds(streams, dl, rounds):
    t = 0
    while t < rounds:
        n = min(CHUNK, rounds - t)
        batches = streams.next_chunk(n)
        for i in range(n):
            dl.step({k: v[i] for k, v in batches.items()})
        t += n
    finish(dl.device)


def _scan_rounds(streams, dl, rounds):
    t = 0
    while t < rounds:
        n = min(CHUNK, rounds - t)
        dl.run_chunk(streams.next_chunk(n))
        t += n
    finish(dl.device)


DRIVERS = {"loop": _loop_rounds, "scan": _scan_rounds}


def cut(case, device="cuda", source=None, init_fn=None):
    """One case of ``CUT``: its driver for ``rounds`` rounds, ``(learner,
    {})``."""
    proto, _, rounds, kw = case
    streams, dl = _make(device, source, init_fn, proto["delta"])
    DRIVERS[kw["driver"]](streams, dl, rounds)
    return dl, {}


def _timed(fn, *args):
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def run(quick: bool = True, device="cuda"):
    rounds = 200
    streams_loop, dl_loop = _make(device)
    cold_loop = _timed(_loop_rounds, streams_loop, dl_loop, rounds)
    streams_scan, dl_scan = _make(device)
    cold_scan = _timed(_scan_rounds, streams_scan, dl_scan, rounds)

    comm_equal = dl_loop.comm_totals == dl_scan.comm_totals
    loss_rel = abs(dl_loop.cumulative_loss - dl_scan.cumulative_loss) / max(
        1.0, abs(dl_loop.cumulative_loss))
    params_close = bool(torch.allclose(dl_loop.X, dl_scan.X, rtol=1e-5,
                                       atol=1e-6))

    # steady state: each driver goes on with its own stream (same seed,
    # the same history), so both time the same rounds from equivalent
    # states
    warm_loop = _timed(_loop_rounds, streams_loop, dl_loop, rounds)
    warm_scan = _timed(_scan_rounds, streams_scan, dl_scan, rounds)

    rows = [{
        "rounds": rounds,
        "m": M,
        "chunk": CHUNK,
        "cold_loop_s": round(cold_loop, 2),
        "cold_scan_s": round(cold_scan, 2),
        "cold_speedup": round(cold_loop / cold_scan, 2),
        "warm_loop_s": round(warm_loop, 2),
        "warm_scan_s": round(warm_scan, 2),
        "warm_speedup": round(warm_loop / warm_scan, 2),
        "comm_totals_equal": bool(comm_equal),
        "params_close": params_close,
        "loss_rel_err": float(loss_rel),
    }]
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    r = rows[0]
    return "PASS" if (r["warm_speedup"] >= 5.0 and r["comm_totals_equal"]
                      and r["params_close"]
                      and r["loss_rel_err"] < 1e-5) else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
