"""Amortized collective cost of dynamic averaging — the twin of
``benchmarks/dynamic_amortized.py`` on ``repro_torch``.

A dry-run's collective term for ``train_dynamic`` is a worst case: the
sync sits on a branch that runs only on a violation. The executed cost
per step is

    amortized = local_step_collectives + sync_rate * sync_collective

where ``sync_rate`` = syncs / condition checks, measured by running the
protocol. This benchmark measures it across a Delta grid (the smoke
MNIST CNN, m = 8, b = 5, 200 rounds quick, 600 full), each run as two
chunks with the syncs read at the midpoint.
"""
from __future__ import annotations

from benchmarks.torch_common import mnist_setup, mnist_source, save_rows
from repro_torch.config import ProtocolConfig, TrainConfig
from repro_torch.core.protocol import DecentralizedLearner
from repro_torch.data.pipeline import LearnerStreams

NAME = "dynamic_amortized"
PAPER_REF = "DESIGN.md §2 (expected-case collective term)"

M, B = 8, 5
DELTAS = (0.1, 0.3, 0.7, 1.5, 3.0)

ARCH = "mnist_cnn"
# the cut rows that tests/test_torch_bench_cuts.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds,
# _run_one keywords)
CUT = ((dict(kind="dynamic", b=B, delta=0.3), M, 40, {}),)
default_source = mnist_source


def _run_one(delta, m, rounds, device="cuda", source=None, init_fn=None):
    """One Delta: two chunks (rounds // 2 + 1, then the rest), ``(learner,
    syncs at the midpoint)``."""
    _, loss_fn, default_init = mnist_setup()
    src = default_source(device) if source is None else source
    streams = LearnerStreams(src, m, batch=10, seed=0)
    dl = DecentralizedLearner(
        loss_fn, init_fn or default_init, m,
        ProtocolConfig(kind="dynamic", b=B, delta=delta),
        TrainConfig(optimizer="sgd", learning_rate=0.1), device=device)
    dl.run_chunk(streams.next_chunk(rounds // 2 + 1))
    half_syncs = dl.comm_totals["syncs"]
    dl.run_chunk(streams.next_chunk(rounds - rounds // 2 - 1))
    return dl, half_syncs


def cut(case, device="cuda", source=None, init_fn=None):
    """One case of ``CUT``: ``(learner, {"half_syncs": ...})``."""
    proto, m, rounds, _ = case
    dl, half = _run_one(proto["delta"], m, rounds, device, source, init_fn)
    return dl, {"half_syncs": half}


def run(quick: bool = True, device="cuda"):
    rounds = 200 if quick else 600
    rows = []
    for delta in DELTAS:
        dl, half_syncs = _run_one(delta, M, rounds, device)
        checks = rounds // B
        syncs = dl.comm_totals["syncs"]
        rows.append({
            "delta": delta,
            "sync_rate": round(syncs / checks, 3),
            "sync_rate_late_half": round(
                (syncs - half_syncs) / (checks / 2), 3),
            "amortized_sync_multiplier": round(syncs / checks, 3),
            "cumulative_loss": round(dl.cumulative_loss, 1),
        })
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    """Sync rate must fall monotonically with Delta, giving an amortized
    sync-collective multiplier << 1 for the loose-Delta operating
    points."""
    rates = [r["sync_rate"] for r in rows]
    monotone = all(a >= b - 0.05 for a, b in zip(rates, rates[1:]))
    saves = rows[-1]["sync_rate"] < 0.5
    return "PASS" if (monotone and saves) else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
