"""Concept drift in the PyTorch port: dynamic averaging invests
communication where it matters.

The twin of ``examples/concept_drift.py``. A fleet of learners trains on
a random-graphical-model stream (paper App. A.3). Two concept drifts are
forced, and the per-window sync counts are printed: dynamic averaging
goes quiet between drifts and bursts right after them, while periodic
averaging pays the same bill all the time. The drift rounds are known up
front, so the run is chunks cut at them (``run_drift_segments``) with a
``force_drift`` between them.

    PYTHONPATH=src python examples/torch_concept_drift.py            # the card
    PYTHONPATH=src python examples/torch_concept_drift.py --device cpu --smoke
"""
import argparse

from repro_torch.config import ProtocolConfig, TrainConfig, get_arch
from repro_torch.core.protocol import DecentralizedLearner
from repro_torch.data.pipeline import LearnerStreams
from repro_torch.data.synthetic import GraphicalModelStream
from repro_torch.models.cnn import cnn_loss, init_cnn_params
from repro_torch.train.loop import run_drift_segments

M, WINDOW = 8, 20
FULL = (240, (80, 160))          # rounds, drift rounds
SMOKE = (60, (20, 40))
PROTOCOLS = [("periodic b=10", ProtocolConfig(kind="periodic", b=10)),
             ("dynamic Δ=0.5", ProtocolConfig(kind="dynamic", b=2,
                                              delta=0.5))]


def run(proto, rounds, drifts, device="cuda", source=None, init_fn=None):
    """(learner, per-round cumulative syncs) of one drifting run
    (``source`` and ``init_fn`` default to the example's own draws)."""
    cfg = get_arch("drift_mlp")
    src = source or GraphicalModelStream(seed=1, drift_prob=0.0,
                                         device=device)
    streams = LearnerStreams(src, M, batch=10, seed=0)
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        init_fn or (lambda g: init_cnn_params(cfg, g)), M, proto,
        TrainConfig(optimizer="sgd", learning_rate=0.1), device=device)
    sync_hist, _ = run_drift_segments(dl, streams, src, rounds, drifts)
    return dl, sync_hist


def windows(sync_hist, rounds, drifts) -> list:
    """Syncs a ``WINDOW``-round window, a drift's window marked ``*``."""
    row = []
    for w in range(0, rounds, WINDOW):
        n = sync_hist[min(w + WINDOW, rounds) - 1] - (
            sync_hist[w - 1] if w else 0)
        mark = "*" if any(w <= d < w + WINDOW for d in drifts) else " "
        row.append(f"{mark}{int(n):2d}")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="fewer rounds (CI smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rounds, drifts = SMOKE if args.smoke else FULL

    for name, proto in PROTOCOLS:
        dl, sync_hist = run(proto, rounds, drifts, args.device)
        print(f"\n{name}: total syncs {int(sync_hist[-1])}, "
              f"comm {dl.comm_bytes()/1e6:.1f}MB, "
              f"cumulative loss {dl.cumulative_loss:.0f}")
        print(f"  syncs per {WINDOW}-round window (drifts at rounds "
              f"{' and '.join(map(str, drifts))} marked *):")
        print("  [" + " ".join(windows(sync_hist, rounds, drifts)) + "]")
    print("torch_concept_drift_done")


if __name__ == "__main__":
    main()
