"""A faulty fleet in the PyTorch port: crashes, adversaries, and the robust
pipeline.

The twin of ``examples/faulty_fleet.py``. A ``FaultConfig`` injects
crash episodes (a crashed learner rejoins COLD: its parameters,
optimizer state and sync state are zeroed) and a 20% subset of
sign-flipping adversaries, every fault a pure function of
``(fault_seed, t)`` (``repro_torch.network.faults``). Two pipelines run
under the same schedule:

* plain ``dynamic`` averages whatever arrives, so the flipped rows drag
  every sync;
* ``robust_dynamic`` (``repro_torch.core.sync.robust``) swaps the mean
  for a trimmed mean, quarantines rows that are non-finite or far from
  the reference, and warm-starts them from the reference model.

Both stream through the telemetry plane (``repro_torch.telemetry``), and
the observatory's fault card — faulty learners per round, quarantine and
recovery counts — is rebuilt from each JSONL file alone. Progress goes
through the structured event logger.

    PYTHONPATH=src python examples/torch_faulty_fleet.py            # the card
    PYTHONPATH=src python examples/torch_faulty_fleet.py --device cpu --smoke
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.config import (
    FaultConfig, ProtocolConfig, TelemetryConfig, TrainConfig, get_arch,
)
from repro_torch.data.synthetic import GraphicalModelStream
from repro_torch.models.cnn import cnn_loss, init_cnn_params
from repro_torch.network import faults as nf
from repro_torch.telemetry import console_handler, get_logger
from repro_torch.telemetry.observatory import load_run, summarize
from repro_torch.train.loop import run_protocol_training

M = 10
# one in five learners is a sign-flipping adversary, and every 16-round
# window each learner has a 15% chance of a 2-4 round crash it rejoins
# from COLD
FAULTS = FaultConfig(fault_seed=11, byzantine_frac=0.2,
                     byzantine_mode="sign_flip",
                     crash_prob=0.15, crash_every=16,
                     outage_min=2, outage_max=4)


def run_one(name, proto, rounds, jsonl, log, device):
    cfg = get_arch("drift_mlp", smoke=True)
    dl, _ = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b), lambda g: init_cnn_params(cfg, g),
        GraphicalModelStream(seed=0, drift_prob=0.0, device=device),
        m=M, rounds=rounds, protocol=proto,
        train=TrainConfig(optimizer="sgd", learning_rate=0.05),
        batch=10, seed=0, faults=FAULTS,
        telemetry=TelemetryConfig(path=jsonl), device=device)
    dl.recorder.close()
    honest = ~nf.byzantine_mask(FAULTS, M)
    honest_loss = float(dl.cumulative_loss_per_learner[honest].sum())
    log.event("fleet_run_done", protocol=name, rounds=rounds,
              syncs=dl.comm_totals["syncs"],
              honest_loss=round(honest_loss, 1),
              honest_finite=bool(np.isfinite(honest_loss)))
    return honest_loss


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="few rounds (CI smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    rounds = 32 if args.smoke else 160

    log = get_logger()
    handler = log.add_handler(console_handler())
    out_dir = tempfile.mkdtemp(prefix="torch_faulty_fleet_")

    n_adv = int(round(FAULTS.byzantine_frac * M))
    print(f"fleet: m={M}, {n_adv} sign-flipping adversaries, crash "
          f"episodes at p={FAULTS.crash_prob} per {FAULTS.crash_every}"
          f"-round window ({FAULTS.outage_min}-{FAULTS.outage_max} rounds "
          f"down, rejoin COLD), on {args.device}\n")

    try:
        for name, proto in [
            # b=1: check the divergence gate every round, so the
            # adversaries never drift uncontested between checks
            ("dynamic (mean)", ProtocolConfig(kind="dynamic", b=1,
                                              delta=0.5)),
            ("robust_dynamic", ProtocolConfig(kind="robust_dynamic", b=1,
                                              delta=0.5)),
        ]:
            jsonl = os.path.join(out_dir, name.split()[0] + ".jsonl")
            loss = run_one(name, proto, rounds, jsonl, log, args.device)
            # the observatory's view, from the stream alone
            card = summarize(load_run(jsonl))
            card_faults = card.get("faults", {})
            line = (f"{name:16s} honest_loss={loss:12.1f} "
                    f"syncs={card['cum_syncs']:3d} "
                    f"faulty_rounds={card_faults.get('faulty_rounds', 0)}"
                    f"/{rounds} max_faulty="
                    f"{card_faults.get('max_faulty', 0)}")
            if "total_recovered" in card_faults:
                line += (f" quarantined_last="
                         f"{card_faults['quarantined_last']} "
                         f"recovered_total={card_faults['total_recovered']}")
            print(line)
    finally:
        log.remove_handler(handler)

    print("\nthe plain mean averaged the flipped rows into every commit; "
          "the robust pipeline trimmed them out of the aggregate, "
          "quarantined them at commit, and warm-started every crashed "
          "learner from the reference.")
    print("torch_faulty_fleet_done")


if __name__ == "__main__":
    main()
