"""Operating regimes under connectivity constraints: act_prob x topology
— the twin of ``benchmarks/fig_network_regimes.py`` on ``repro_torch``.

The drift-MLP task (m = 8) runs inside the simulated network: dynamic
averaging (b = 5, Delta = 0.5), limited by availability, and gossip
(b = 5), limited by availability and the overlay, over act_prob in
{1.0, 0.7, 0.4} and the star, ring and mobile geometric overlays, beside
a ``network=None`` baseline; 120 rounds quick, 600 full. The grid is
``examples/torch_network_regimes.py``'s, run here with the reference's
rounding of the rows.

Claim checked: the ideal row (star, act_prob 1.0, dynamic) equals the
baseline in bytes, syncs and cumulative loss, every loss is finite, and
no constrained dynamic run moves more than 1.5 times the baseline's
bytes.
"""
from __future__ import annotations

from benchmarks.torch_common import save_rows
from examples import torch_network_regimes as grid
from repro_torch.config import ProtocolConfig
from repro_torch.data.synthetic import GraphicalModelStream

NAME = "fig_network_regimes"
PAPER_REF = "ISSUE 2 tentpole (network environment subsystem)"

M = grid.M

ARCH = "drift_mlp"
# the cut rows that tests/test_torch_bench_cuts.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds,
# {"topology", "act_prob"})
CUT = ((dict(kind="dynamic", b=5, delta=0.5), M, 30,
        dict(topology="star", act_prob=1.0)),
       (dict(kind="gossip", b=5), M, 30,
        dict(topology="ring", act_prob=0.7)))


def default_source(device="cuda"):
    return GraphicalModelStream(seed=1, drift_prob=0.0, device=device)


def cut(case, device="cuda", source=None, init_fn=None):
    """One case of ``CUT``: ``(learner, {"mean_active": ...,
    "sim_net_s": ...})``."""
    proto, m, rounds, kw = case
    if m != M:
        raise ValueError(f"the grid's fleet is m = {M}, not {m}")
    dl = grid.run_one(ProtocolConfig(**proto),
                      grid.network_config(kw["topology"], kw["act_prob"]),
                      rounds, device, source, init_fn)
    return dl, {"mean_active": dl.mean_active(),
                "sim_net_s": dl.network_time}


def run(quick: bool = True, device="cuda"):
    rows = grid.run(120 if quick else 600, device)
    for r in rows:
        r["cumulative_loss"] = round(r["cumulative_loss"], 3)
        r["mean_active"] = round(r["mean_active"], 3)
        r["sim_net_s"] = round(r["sim_net_s"], 4)
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    """The reference's claim, as ``examples/torch_network_regimes.py``
    checks it: the ideal row is the baseline (bytes, syncs, loss), every
    loss finite, constrained dynamic bytes within 1.5x the baseline's."""
    return "PASS" if grid.check(rows) else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
