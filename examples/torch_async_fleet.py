"""An asynchronous fleet in the PyTorch port: event-driven averaging over
slow links.

The twin of ``examples/async_fleet.py``. At a 100 kB model and a
1-second round budget an LTE link's round trip fits inside the round,
but an edge (2G-fallback) link needs two full seconds: its exchanges are
still in flight when the next round starts. An ``AsyncConfig`` puts any
protocol on the event-driven network timeline
(``repro_torch.core.sync.async_sync``): every learner runs on a local
clock that advances only while it is idle, a triggered exchange flies
``k = ceil(round_trip / budget) - 1`` whole rounds through a bounded
arrival ring, and a learner joins a synchronization only when its
message lands. The timeline is pure in ``(seed, t)``.

The walkthrough runs the lte/edge fleet under the cadence trigger and
the divergence trigger, streams both runs through the telemetry plane,
and rebuilds the observatory's run cards, in-flight and age histograms
too, from the JSONL alone. Progress goes through the structured event
logger (``repro_torch.telemetry``).

    PYTHONPATH=src python examples/torch_async_fleet.py            # the card
    PYTHONPATH=src python examples/torch_async_fleet.py --device cpu --smoke
"""
import argparse
import json
import os
import tempfile

from repro_torch.config import (
    AsyncConfig, NetworkConfig, ProtocolConfig, TelemetryConfig,
    TrainConfig, get_arch,
)
from repro_torch.data.synthetic import GraphicalModelStream
from repro_torch.models.cnn import cnn_loss, init_cnn_params
from repro_torch.telemetry import console_handler, get_logger
from repro_torch.telemetry.observatory import load_run, summarize
from repro_torch.train.loop import run_protocol_training

M = 8
FLEET = NetworkConfig(link_classes=("lte", "edge"), act_prob=0.85)
TIMELINE = AsyncConfig(round_budget=1.0, payload_bytes=100_000)
PROTOCOLS = [("periodic b=2", ProtocolConfig(kind="periodic", b=2)),
             ("dynamic Δ=0.5", ProtocolConfig(kind="dynamic", b=2,
                                              delta=0.5))]


def run_one(name, proto, rounds, jsonl, log, device="cuda", source=None,
            init_fn=None):
    """One fleet run on the drift-MLP task, streamed to ``jsonl``
    (``source`` and ``init_fn`` default to the example's own draws)."""
    cfg = get_arch("drift_mlp", smoke=True)
    dl, _ = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b),
        init_fn or (lambda g: init_cnn_params(cfg, g)),
        source or GraphicalModelStream(seed=0, drift_prob=0.0,
                                       device=device),
        m=M, rounds=rounds, protocol=proto,
        train=TrainConfig(optimizer="sgd", learning_rate=0.05),
        batch=10, seed=0, network=FLEET, async_net=TIMELINE,
        telemetry=TelemetryConfig(path=jsonl, per_link=True), device=device)
    dl.recorder.close()
    log.event("fleet_run_done", protocol=name, rounds=rounds,
              syncs=dl.comm_totals["syncs"], bytes=dl.comm_bytes(),
              net_time_s=round(dl.network_time, 2))
    return dl


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="few rounds (CI smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rounds = 32 if args.smoke else 160

    log = get_logger()
    handler = log.add_handler(console_handler())
    out_dir = tempfile.mkdtemp(prefix="torch_async_fleet_")

    print(f"fleet: m={M}, links={FLEET.link_classes}, "
          f"act_prob={FLEET.act_prob}, round budget "
          f"{TIMELINE.round_budget}s at a {TIMELINE.payload_bytes/1e3:.0f}"
          f"kB payload -> edge exchanges fly 1 round, lte lands "
          f"synchronously; on {args.device}\n")

    try:
        for name, proto in PROTOCOLS:
            jsonl = os.path.join(out_dir, name.split()[0] + ".jsonl")
            run_one(name, proto, rounds, jsonl, log, args.device)
            # the observatory's view, from the stream alone
            card = summarize(load_run(jsonl))
            ages = card.get("state_ages", {})
            print(f"{name:14s} loss={card['cum_loss']:9.1f} "
                  f"syncs={card['cum_syncs']:3d} "
                  f"comm={card['cum_bytes']/1e6:6.1f}MB "
                  f"net_time={card['net_time_s']:7.2f}s")
            print(f"{'':14s} in-flight last={card.get('inflight_last', 0)} "
                  f"oldest age={card.get('max_age_last', 0)} "
                  f"age histogram="
                  f"{json.dumps(ages.get('age', {}).get('hist', {}))} "
                  f"in-flight histogram="
                  f"{json.dumps(ages.get('inflight', {}).get('hist', {}))}")
    finally:
        log.remove_handler(handler)

    print("\nthe cadence trigger keeps paying for every tick — the edge "
          "learners just pay it a round late; the divergence trigger "
          "only launches when a model actually drifts, so the slow links "
          "stay quiet until the violation lands. Same engine: the "
          "timeline is just trigger state.")
    print("torch_async_fleet_done")


if __name__ == "__main__":
    main()
