"""Fig. 5.2/5.3 (+ A.2/A.3): dynamic averaging vs FedAvg — the twin of
``benchmarks/fig5_2_fedavg.py`` on ``repro_torch``.

Paper setting: m=30, B=10, b=50, FedAvg C in {0.3,0.5,0.7},
sigma_Delta in {0.1,...,0.8}. Claim: the best dynamic configs beat the
strongest FedAvg config on cumulative communication at comparable loss
(paper: >50% less comm at +8.3% loss / -1.9% accuracy).
"""
from __future__ import annotations

from benchmarks.torch_common import (
    mnist_cut, mnist_source, run_mnist_protocol, save_rows,
)
from repro_torch.config import ProtocolConfig

NAME = "fig5_2_fedavg"
PAPER_REF = "Figures 5.2/5.3, Appendix A.2"

ARCH = "mnist_cnn"
# the cut rows that tests/test_torch_figures.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds,
# run_mnist_protocol keywords)
CUT = ((dict(kind="fedavg", b=10, fedavg_c=0.5), 4, 40, {}),)
cut, default_source = mnist_cut, mnist_source


def protos(b: int):
    return [
        ("periodic_b", ProtocolConfig(kind="periodic", b=b)),
        ("fedavg_C0.3", ProtocolConfig(kind="fedavg", b=b, fedavg_c=0.3)),
        ("fedavg_C0.5", ProtocolConfig(kind="fedavg", b=b, fedavg_c=0.5)),
        ("fedavg_C0.7", ProtocolConfig(kind="fedavg", b=b, fedavg_c=0.7)),
        ("dynamic_d0.4", ProtocolConfig(kind="dynamic", b=b, delta=0.4)),
        ("dynamic_d0.8", ProtocolConfig(kind="dynamic", b=b, delta=0.8)),
        ("dynamic_d1.2", ProtocolConfig(kind="dynamic", b=b, delta=1.2)),
        ("dynamic_d1.6", ProtocolConfig(kind="dynamic", b=b, delta=1.6)),
    ]


def run(quick: bool = True, device="cuda"):
    m = 10 if quick else 30
    # long enough that the learners approach quiescence — the regime where
    # dynamic averaging stops paying while FedAvg's bill keeps growing
    # linearly (the paper's Fig. 5.2 shape)
    rounds = 260 if quick else 800
    b = 10 if quick else 50
    rows = []
    for name, proto in protos(b):
        dl, traj, acc = run_mnist_protocol(proto, m=m, rounds=rounds,
                                           device=device)
        rows.append({"protocol": name,
                     "cumulative_loss": round(dl.cumulative_loss, 2),
                     "comm_bytes": dl.comm_bytes(),
                     "accuracy": round(acc, 4),
                     "comm_curve": traj.cumulative_bytes[::3]})
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    """Some dynamic config communicates less than the cheapest FedAvg config
    at <= 1.15x its loss."""
    fed = [r for r in rows if r["protocol"].startswith("fedavg")]
    dyn = [r for r in rows if r["protocol"].startswith("dynamic")]
    best_fed = min(fed, key=lambda r: r["comm_bytes"])
    ok = any(d["comm_bytes"] < best_fed["comm_bytes"] and
             d["cumulative_loss"] < 1.15 * best_fed["cumulative_loss"]
             for d in dyn)
    return "PASS" if ok else "MIXED"


if __name__ == "__main__":
    for r in run():
        print({k: v for k, v in r.items() if k != "comm_curve"})
