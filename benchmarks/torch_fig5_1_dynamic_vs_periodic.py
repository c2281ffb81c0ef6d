"""Fig. 5.1: cumulative loss & communication — dynamic vs periodic vs
nosync vs serial, CNN on (synthetic) MNIST — the twin of
``benchmarks/fig5_1_dynamic_vs_periodic.py`` on ``repro_torch``.

Paper setting: m=100, B=10, T=14000, sigma_b in {10,20,40},
sigma_Delta in {0.3,0.7,1.0}. The reference's scale: m=10, 120 rounds
(quick) or 600 (full), the same grid. Claim: for every periodic setup
there is a dynamic setup with comparable loss and less communication.
"""
from __future__ import annotations

import torch

from benchmarks.torch_common import (
    mnist_cut, mnist_setup, mnist_source, run_mnist_protocol, save_rows,
)
from repro_torch.config import ProtocolConfig, TrainConfig
from repro_torch.core.protocol import SerialLearner

NAME = "fig5_1_dynamic_vs_periodic"
PAPER_REF = "Figure 5.1 / Appendix A.1"

ARCH = "mnist_cnn"
# the cut rows that tests/test_torch_figures.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds,
# run_mnist_protocol keywords)
CUT = ((dict(kind="dynamic", b=10, delta=0.7), 4, 40, {}),
       (dict(kind="periodic", b=10), 4, 40, {}))
cut, default_source = mnist_cut, mnist_source

PROTOS = [
    ("nosync", ProtocolConfig(kind="nosync")),
    ("periodic_b10", ProtocolConfig(kind="periodic", b=10)),
    ("periodic_b20", ProtocolConfig(kind="periodic", b=20)),
    ("periodic_b40", ProtocolConfig(kind="periodic", b=40)),
    ("dynamic_d0.3", ProtocolConfig(kind="dynamic", b=10, delta=0.3)),
    ("dynamic_d0.7", ProtocolConfig(kind="dynamic", b=10, delta=0.7)),
    ("dynamic_d1.0", ProtocolConfig(kind="dynamic", b=10, delta=1.0)),
    # the loose end of the grid pairs against sigma_b=40 (the claim is
    # existential: for EACH periodic setup SOME dynamic setup)
    ("dynamic_d2.5", ProtocolConfig(kind="dynamic", b=10, delta=2.5)),
]


def run(quick: bool = True, device="cuda"):
    m = 10
    rounds = 120 if quick else 600
    rows = []
    for name, proto in PROTOS:
        dl, _, acc = run_mnist_protocol(proto, m=m, rounds=rounds,
                                        device=device)
        rows.append({"protocol": name,
                     "cumulative_loss": round(dl.cumulative_loss, 2),
                     "comm_bytes": dl.comm_bytes(),
                     "syncs": dl.comm_totals["syncs"],
                     "accuracy": round(acc, 4)})
    # the serial baseline observes m*T samples centrally, B = 10m a round
    _, loss_fn, init_fn = mnist_setup()
    src = mnist_source(device)
    sl = SerialLearner(loss_fn, init_fn,
                       TrainConfig(optimizer="sgd", learning_rate=0.1),
                       device=device)
    gen = torch.Generator(device=src.device).manual_seed(123)
    sl.run_chunk(src.sample(gen, 10 * m, lead=(rounds,)))
    rows.append({"protocol": "serial", "cumulative_loss":
                 round(sl.cumulative_loss * m, 2),  # the paper sums over mT
                 "comm_bytes": 0, "syncs": 0, "accuracy": None})
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    """For each periodic setup, some dynamic setup has <= 1.15x loss with
    < 1.0x communication (the paper's Fig. 5.1 claim)."""
    per = [r for r in rows if r["protocol"].startswith("periodic")]
    dyn = [r for r in rows if r["protocol"].startswith("dynamic")]
    ok = all(any(d["comm_bytes"] < p["comm_bytes"] and
                 d["cumulative_loss"] < 1.15 * p["cumulative_loss"]
                 for d in dyn) for p in per)
    return "PASS" if ok else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
