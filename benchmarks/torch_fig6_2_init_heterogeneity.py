"""Fig. 6.2 / A.8: heterogeneous initializations x averaging frequency —
the twin of ``benchmarks/fig6_2_init_heterogeneity.py`` on
``repro_torch``.

Paper: noise scale eps in {0,1,...,20} on top of a Glorot init, b/B
local batches between averagings; averaged-model performance relative to
(eps=0, b/B=1). Claims: (i) homogeneous init tolerates large b/B; (ii)
mild heterogeneity (eps ~ 1-3) does NOT hurt (can help); (iii) large eps
fails.
"""
from __future__ import annotations

from benchmarks.torch_common import (
    mnist_cut, mnist_source, run_mnist_protocol, save_rows,
)
from repro_torch.config import ProtocolConfig

NAME = "fig6_2_init_heterogeneity"
PAPER_REF = "Figure 6.2, Appendix A.7"

ARCH = "mnist_cnn"
# the cut rows that tests/test_torch_figures.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds,
# run_mnist_protocol keywords)
CUT = ((dict(kind="dynamic", b=10, delta=0.7), 4, 30,
        dict(init_heterogeneity=2.0)),)
cut, default_source = mnist_cut, mnist_source

EPS = (0.0, 2.0, 10.0)
PERIODS = (1, 10, 40)


def run(quick: bool = True, device="cuda"):
    m = 6
    rounds = 80 if quick else 300
    rows = []
    base_acc = None
    for eps in EPS:
        for b in PERIODS:
            for kind in ("periodic", "dynamic"):
                proto = (ProtocolConfig(kind="periodic", b=b) if kind ==
                         "periodic" else
                         ProtocolConfig(kind="dynamic", b=b, delta=0.7))
                dl, _, acc = run_mnist_protocol(
                    proto, m=m, rounds=rounds, init_heterogeneity=eps,
                    device=device)
                if eps == 0.0 and b == 1 and kind == "periodic":
                    base_acc = acc
                rows.append({"eps": eps, "b": b, "protocol": kind,
                             "accuracy": round(acc, 4),
                             "cumulative_loss": round(dl.cumulative_loss,
                                                      2)})
    for r in rows:
        r["relative_accuracy"] = round(r["accuracy"] / max(base_acc, 1e-9), 3)
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    # mild heterogeneity with frequent averaging stays near baseline;
    # large heterogeneity with rare averaging degrades
    mild = [r for r in rows if r["eps"] == 2.0 and r["b"] == 1]
    harsh = [r for r in rows if r["eps"] == 10.0 and r["b"] == 40]
    ok = (min(r["relative_accuracy"] for r in mild) > 0.8 and
          min(r["relative_accuracy"] for r in harsh)
          <= min(r["relative_accuracy"] for r in mild) + 0.05)
    return "PASS" if ok else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
