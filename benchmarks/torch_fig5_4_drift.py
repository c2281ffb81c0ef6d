"""Fig. 5.4 / A.4: adaptivity to concept drift (random graphical model)
— the twin of ``benchmarks/fig5_4_drift.py`` on ``repro_torch``.

Paper setting: m=100, 5000 samples/learner, drift prob 0.001. Claim:
dynamic averaging matches periodic's loss with up to an order of
magnitude less communication, and its communication concentrates right
after drifts.
"""
from __future__ import annotations

from benchmarks.torch_common import save_rows
from repro_torch.config import ProtocolConfig, TrainConfig, get_arch
from repro_torch.core.protocol import DecentralizedLearner
from repro_torch.data.pipeline import LearnerStreams
from repro_torch.data.synthetic import GraphicalModelStream
from repro_torch.models.cnn import cnn_loss, init_cnn_params
from repro_torch.train.loop import run_drift_segments

NAME = "fig5_4_drift"
PAPER_REF = "Figure 5.4, Appendix A.3"

PROTOS = [
    ("periodic_b10", ProtocolConfig(kind="periodic", b=10)),
    ("dynamic_d0.3", ProtocolConfig(kind="dynamic", b=2, delta=0.3)),
]

ARCH = "drift_mlp"
# the cut rows that tests/test_torch_figures.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds,
# _run_one keywords)
CUT = ((dict(kind="dynamic", b=2, delta=0.3), 4, 30,
        dict(drift_rounds=(10, 20))),
       (dict(kind="periodic", b=10), 4, 30, dict(drift_rounds=(10, 20))))


def default_source(device="cuda"):
    return GraphicalModelStream(seed=1, drift_prob=0.0, device=device)


def cut(case, device="cuda", source=None, init_fn=None):
    """One case of ``CUT``: ``(learner, {"syncs": the cumulative sync
    curve, "losses": the cumulative loss curve})``."""
    proto, m, rounds, kw = case
    dl, syncs, losses = _run_one(ProtocolConfig(**proto), m, rounds,
                                 device=device, source=source,
                                 init_fn=init_fn, **kw)
    return dl, {"syncs": syncs, "losses": losses}


def _run_one(proto, m, rounds, drift_rounds, seed=0, device="cuda",
             source=None, init_fn=None):
    cfg = get_arch(ARCH, smoke=True)
    src = default_source(device) if source is None else source
    streams = LearnerStreams(src, m, batch=10, seed=seed)
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        init_fn or (lambda g: init_cnn_params(cfg, g)), m, proto,
        TrainConfig(optimizer="sgd", learning_rate=0.05), seed=seed,
        device=device)
    # drift rounds are known: the chunks are cut at them
    sync_curve, loss_curve = run_drift_segments(dl, streams, src, rounds,
                                                drift_rounds)
    return dl, sync_curve, loss_curve


def run(quick: bool = True, device="cuda"):
    m = 8
    rounds = 180 if quick else 600
    drift_rounds = {rounds // 3, 2 * rounds // 3}
    rows = []
    for name, proto in PROTOS:
        dl, syncs, losses = _run_one(proto, m, rounds, drift_rounds,
                                     device=device)
        # syncs in the 20 rounds after each drift vs 20 calm rounds before
        w = 20
        post = sum(int(syncs[min(d + w, rounds - 1)] - syncs[d])
                   for d in drift_rounds)
        pre = sum(int(syncs[d] - syncs[d - w]) for d in drift_rounds)
        rows.append({"protocol": name,
                     "cumulative_loss": round(float(losses[-1]), 2),
                     "comm_bytes": dl.comm_bytes(),
                     "syncs_total": int(syncs[-1]),
                     "syncs_post_drift_window": post,
                     "syncs_pre_drift_window": pre})
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    dyn = next(r for r in rows if r["protocol"].startswith("dynamic"))
    per = next(r for r in rows if r["protocol"].startswith("periodic"))
    adaptive = dyn["syncs_post_drift_window"] >= dyn["syncs_pre_drift_window"]
    cheaper = dyn["comm_bytes"] < per["comm_bytes"]
    similar = dyn["cumulative_loss"] < 1.2 * per["cumulative_loss"]
    return "PASS" if (adaptive and cheaper and similar) else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
