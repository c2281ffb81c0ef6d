"""Fig. 6.1 / A.7: scale-out in the number of learners m — the twin of
``benchmarks/fig6_1_scaleout.py`` on ``repro_torch``.

Paper setting: m in {10, 100, 200} on MNIST. Claim: per-learner loss
keeps improving with m (more aggregate data) and the dynamic protocols'
advantage over periodic grows with m. The reference's scale: m in
{4, 8, 16}.
"""
from __future__ import annotations

from benchmarks.torch_common import (
    mnist_cut, mnist_source, run_mnist_protocol, save_rows,
)
from repro_torch.config import ProtocolConfig

NAME = "fig6_1_scaleout"
PAPER_REF = "Figure 6.1, Appendix A.6"

ARCH = "mnist_cnn"
# the cut rows that tests/test_torch_figures.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds,
# run_mnist_protocol keywords)
CUT = ((dict(kind="dynamic", b=10, delta=0.7), 8, 30, {}),)
cut, default_source = mnist_cut, mnist_source

FLEETS = (4, 8, 16)
PROTOS = [
    ("periodic_b10", ProtocolConfig(kind="periodic", b=10)),
    ("dynamic_d0.7", ProtocolConfig(kind="dynamic", b=10, delta=0.7)),
]


def run(quick: bool = True, device="cuda"):
    rounds = 100 if quick else 400
    rows = []
    for m in FLEETS:
        for name, proto in PROTOS:
            dl, _, acc = run_mnist_protocol(proto, m=m, rounds=rounds,
                                            device=device)
            rows.append({"m": m, "protocol": name,
                         "loss_per_learner": round(dl.cumulative_loss / m, 3),
                         "comm_bytes": dl.comm_bytes(),
                         "accuracy": round(acc, 4)})
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    ok = True
    for m in FLEETS:
        p = next(r for r in rows if r["m"] == m and "periodic" in r["protocol"])
        d = next(r for r in rows if r["m"] == m and "dynamic" in r["protocol"])
        ok &= d["comm_bytes"] <= p["comm_bytes"]
    return "PASS" if ok else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
