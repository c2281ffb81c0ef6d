"""Appendix C / Algorithm 2: unbalanced sampling rates B^i with weighted
model averaging — the twin of ``benchmarks/figC_unbalanced.py`` on
``repro_torch``. Claim: the weighted protocol handles unbalanced streams
(stable training, bounded divergence) and reduces to Algorithm 1 when
all B^i are equal."""
from __future__ import annotations

import numpy as np

from benchmarks.torch_common import save_rows
from repro_torch.config import ProtocolConfig, TrainConfig, get_arch
from repro_torch.core.protocol import DecentralizedLearner
from repro_torch.data.pipeline import LearnerStreams
from repro_torch.data.synthetic import GraphicalModelStream
from repro_torch.models.cnn import cnn_loss, init_cnn_params

NAME = "figC_unbalanced"
PAPER_REF = "Appendix C, Algorithm 2"

SIZES = [2, 4, 8, 8, 16, 32]
VARIANTS = (("weighted_alg2", True), ("unweighted", False))
FLEET = dict(kind="dynamic", b=5, delta=0.3)

ARCH = "drift_mlp"
# the cut rows that tests/test_torch_figures.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds, {})
CUT = tuple((dict(FLEET, weighted=w), len(SIZES), 30, {})
            for _, w in VARIANTS)


def default_source(device="cuda"):
    return GraphicalModelStream(seed=2, drift_prob=0.0, device=device)


def cut(case, device="cuda", source=None, init_fn=None):
    """One case of ``CUT``: ``(learner, {})``."""
    proto, m, rounds, kw = case
    return fleet(ProtocolConfig(**proto), m, rounds, device=device,
                 source=source, init_fn=init_fn, **kw), {}


def fleet(proto, m, rounds, device="cuda", source=None, init_fn=None):
    """The fleet of ``proto`` (FLEET, weighted by B^i as in Algorithm 2
    or not) on the unbalanced streams, after ``rounds`` rounds."""
    cfg = get_arch(ARCH, smoke=True)
    src = default_source(device) if source is None else source
    streams = LearnerStreams(src, m, batch=10, seed=0, batch_sizes=SIZES)
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        init_fn or (lambda g: init_cnn_params(cfg, g)), m, proto,
        TrainConfig(optimizer="sgd", learning_rate=0.05),
        sample_weights=streams.weights if proto.weighted else None,
        device=device)
    dl.run_chunk(streams.next_chunk(rounds))
    return dl


def run(quick: bool = True, device="cuda"):
    m = len(SIZES)
    rounds = 100 if quick else 400
    rows = []
    for name, weighted in VARIANTS:
        dl = fleet(ProtocolConfig(**FLEET, weighted=weighted), m, rounds,
                   device)
        rows.append({"variant": name,
                     "cumulative_loss": round(dl.cumulative_loss, 2),
                     "comm_bytes": dl.comm_bytes(),
                     "syncs": dl.comm_totals["syncs"]})
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    return "PASS" if all(np.isfinite(r["cumulative_loss"])
                         for r in rows) else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
