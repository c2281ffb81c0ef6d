"""Fig. A.6: the protocol is black-box in the learning algorithm phi —
dynamic averaging's advantage over periodic holds for SGD, ADAM,
RMSprop. The twin of ``benchmarks/figA6_optimizers.py`` on
``repro_torch``."""
from __future__ import annotations

from benchmarks.torch_common import (
    mnist_cut, mnist_source, run_mnist_protocol, save_rows,
)
from repro_torch.config import ProtocolConfig

NAME = "figA6_optimizers"
PAPER_REF = "Appendix A.5, Figure A.6"

ARCH = "mnist_cnn"
# the cut rows that tests/test_torch_figures.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds,
# run_mnist_protocol keywords)
CUT = ((dict(kind="dynamic", b=10, delta=0.7), 4, 30,
        dict(optimizer="adam", lr=1e-3)),
       (dict(kind="periodic", b=10), 4, 30,
        dict(optimizer="rmsprop", lr=1e-3)))
cut, default_source = mnist_cut, mnist_source

OPTIMIZERS = (("sgd", 0.1), ("adam", 1e-3), ("rmsprop", 1e-3))
PROTOS = [
    ("periodic_b10", ProtocolConfig(kind="periodic", b=10)),
    ("dynamic_d0.7", ProtocolConfig(kind="dynamic", b=10, delta=0.7)),
]


def run(quick: bool = True, device="cuda"):
    m = 6
    rounds = 80 if quick else 300
    rows = []
    for opt, lr in OPTIMIZERS:
        for name, proto in PROTOS:
            dl, _, acc = run_mnist_protocol(proto, m=m, rounds=rounds,
                                            optimizer=opt, lr=lr,
                                            device=device)
            rows.append({"optimizer": opt, "protocol": name,
                         "cumulative_loss": round(dl.cumulative_loss, 2),
                         "comm_bytes": dl.comm_bytes(),
                         "accuracy": round(acc, 4)})
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    ok = True
    for opt, _ in OPTIMIZERS:
        p = next(r for r in rows
                 if r["optimizer"] == opt and "periodic" in r["protocol"])
        d = next(r for r in rows
                 if r["optimizer"] == opt and "dynamic" in r["protocol"])
        ok &= d["comm_bytes"] <= p["comm_bytes"]
    return "PASS" if ok else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
