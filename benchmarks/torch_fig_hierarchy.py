"""Two-tier hierarchy sweep: clusters x inter-tier Delta against flat
dynamic — the twin of ``benchmarks/fig_hierarchy.py`` on
``repro_torch``.

m = 12 learners of the drift MLP, partitioned into g in {3, 4} clusters:
dynamic averaging inside each cluster (b = 2, Delta = 0.3, against the
cluster's edge aggregator) and dynamic averaging among the aggregators
at an inter-tier Delta in {0.3, 0.6}, beside single-tier dynamic at the
intra settings; a concept drift mid-run (``run_drift_segments``), 160
rounds quick, 600 full.

Claims checked:

* the bytes ledger balances on every run: the per-link sums equal the
  byte total (``ledger_balanced``);
* the edge tier absorbs traffic: some hierarchy moves strictly fewer
  coordinator-uplink bytes (the ledger's aggregator rows) than flat
  dynamic's learner uplinks, at a loss within 1.15x.
"""
from __future__ import annotations

import numpy as np

from benchmarks.torch_common import save_rows
from repro_torch.config import (
    HierarchyConfig, ProtocolConfig, TrainConfig, get_arch,
)
from repro_torch.core.protocol import DecentralizedLearner
from repro_torch.data.pipeline import LearnerStreams
from repro_torch.data.synthetic import GraphicalModelStream
from repro_torch.models.cnn import cnn_loss, init_cnn_params
from repro_torch.train.loop import run_drift_segments

NAME = "fig_hierarchy"
PAPER_REF = "ISSUE 3 tentpole (staged sync kernel, two-tier coordinators)"

M = 12
B, DELTA = 2, 0.3                       # intra tier == flat baseline
CLUSTERS = (3, 4)
INTER_DELTAS = (0.3, 0.6)

ARCH = "drift_mlp"
# the cut rows that tests/test_torch_bench_cuts.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds,
# {"drift_rounds", "clusters", "inter_delta"}); clusters 0 is flat
CUT = ((dict(kind="dynamic", b=B, delta=DELTA), M, 40,
        dict(drift_rounds=(20,), clusters=0, inter_delta=None)),
       (dict(kind="dynamic", b=B, delta=DELTA), M, 40,
        dict(drift_rounds=(20,), clusters=3, inter_delta=0.3)))


def default_source(device="cuda"):
    return GraphicalModelStream(seed=1, drift_prob=0.0, device=device)


def protocol(clusters: int, inter_delta) -> ProtocolConfig:
    """Flat dynamic (``clusters`` 0) or the two-tier hierarchy."""
    tiers = None if not clusters else HierarchyConfig(
        num_clusters=clusters,
        inter=ProtocolConfig(kind="dynamic", b=B, delta=inter_delta))
    return ProtocolConfig(kind="dynamic", b=B, delta=DELTA, tiers=tiers)


def _run_one(proto, rounds, drift_rounds, seed=0, device="cuda",
             source=None, init_fn=None):
    cfg = get_arch(ARCH, smoke=True)
    src = default_source(device) if source is None else source
    streams = LearnerStreams(src, M, batch=10, seed=seed)
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        init_fn or (lambda g: init_cnn_params(cfg, g)), M, proto,
        TrainConfig(optimizer="sgd", learning_rate=0.05), seed=seed,
        device=device)
    syncs, loss_curve = run_drift_segments(dl, streams, src, rounds,
                                           drift_rounds)
    return dl, syncs, float(loss_curve[-1])


def cut(case, device="cuda", source=None, init_fn=None):
    """One case of ``CUT``: ``(learner, {"syncs": the cumulative sync
    curve, "loss": the cumulative loss, "row": the benchmark's row})``."""
    _, m, rounds, kw = case
    if m != M:
        raise ValueError(f"the sweep's fleet is m = {M}, not {m}")
    dl, syncs, loss = _run_one(protocol(kw["clusters"], kw["inter_delta"]),
                               rounds, kw["drift_rounds"], device=device,
                               source=source, init_fn=init_fn)
    return dl, {"syncs": syncs, "loss": loss,
                "row": _row("cut", dl, loss, kw["clusters"],
                            kw["inter_delta"])}


def _row(name, dl, loss, clusters=0, inter_delta=None):
    ledger = dl.per_link_bytes()
    uplink = int(ledger[M:].sum()) if clusters else int(ledger.sum())
    return {
        "protocol": name, "clusters": clusters,
        "inter_delta": inter_delta,
        "cumulative_loss": round(loss, 2),
        "comm_bytes": dl.comm_bytes(),
        "coordinator_uplink_bytes": uplink,
        "member_link_bytes": int(ledger[:M].sum()),
        "ledger_balanced": bool(int(ledger.sum()) == dl.comm_bytes()),
        "syncs": dl.comm_totals["syncs"],
    }


def run(quick: bool = True, device="cuda"):
    rounds = 160 if quick else 600
    drift_rounds = {rounds // 2}
    dl, _, loss = _run_one(protocol(0, None), rounds, drift_rounds,
                           device=device)
    rows = [_row("dynamic_flat", dl, loss)]
    for g in CLUSTERS:
        for d_inter in INTER_DELTAS:
            dl, _, loss = _run_one(protocol(g, d_inter), rounds,
                                   drift_rounds, device=device)
            rows.append(_row(f"two_tier_g{g}_d{d_inter}", dl, loss,
                             clusters=g, inter_delta=d_inter))
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    flat = rows[0]
    hier = [r for r in rows if r["clusters"]]
    balanced = all(r["ledger_balanced"] for r in rows)
    finite = all(np.isfinite(r["cumulative_loss"]) for r in rows)
    # the edge tier absorbs traffic: some two-tier setup beats the flat
    # coordinator's uplink bytes strictly, at matched loss
    absorbed = any(
        r["coordinator_uplink_bytes"] < flat["coordinator_uplink_bytes"]
        and r["cumulative_loss"] <= 1.15 * flat["cumulative_loss"]
        for r in hier)
    return "PASS" if (balanced and finite and absorbed) else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
