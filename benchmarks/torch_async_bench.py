"""Event-driven async timeline: delay regimes, frontiers, aircomp — the
twin of ``benchmarks/async_bench.py`` on ``repro_torch``.

A heterogeneous lte/edge fleet (the drift MLP, m = 8, a 100 kB payload)
runs at round budgets that make the edge links synchronous, one round in
flight, or seven rounds in flight, for the cadence (``periodic``, b = 2)
and divergence (``dynamic``, b = 2, Delta = 0.5) triggers, each run
streamed through the telemetry plane so that the comm-vs-loss frontier
is rebuilt from the JSONL stream alone (``repro_torch.telemetry.
observatory``). The streams land at
experiments/bench_torch/async_bench_<regime>_<preset>.jsonl and the run
card of the harsh dynamic run at
experiments/bench_torch/async_bench_frontier.json; 48 rounds quick, 240
full.

Three claims ride in ``check``:

* the covering budget is the synchronous engine, bit for bit (comm,
  ledger, simulated time);
* harsher budgets put messages in flight (mean in flight > 0) while the
  stream's totals stay equal to the live counters;
* aircomp moves exactly m times fewer bytes than the digital uplink at
  the same sync cadence (2 payloads a sync against 2m).
"""
from __future__ import annotations

import json
import os

import numpy as np

from benchmarks.torch_common import OUT_DIR, save_rows
from repro_torch.config import (
    AsyncConfig, NetworkConfig, ProtocolConfig, TelemetryConfig,
    TrainConfig, get_arch,
)
from repro_torch.data.synthetic import GraphicalModelStream
from repro_torch.models.cnn import cnn_loss, init_cnn_params
from repro_torch.telemetry.observatory import load_run, summarize
from repro_torch.train.loop import run_protocol_training

NAME = "async_bench"
PAPER_REF = "ISSUE 9 tentpole (event-driven async network timeline)"

M = 8
PAYLOAD = 100_000
NET = NetworkConfig(link_classes=("lte", "edge"))

# round budgets (simulated seconds a round) against the lte/edge round
# trips at the 100 kB payload: lte flies 0.14 s, edge 2.0 s, so the
# budgets put the edge links 0, 1 and 7 rounds in flight
REGIMES = (
    ("sync", 60.0),      # covers every round trip: the synchronous limit
    ("mild", 1.0),       # edge exchanges fly 1 round
    ("harsh", 0.25),     # edge exchanges fly 7 rounds
)
PRESETS = (
    ("periodic", dict(kind="periodic", b=2)),
    ("dynamic", dict(kind="dynamic", b=2, delta=0.5)),
)
AIRCOMP = AsyncConfig(round_budget=60.0, aircomp=True, snr_db=20.0)

ARCH = "drift_mlp"
# the cut rows that tests/test_torch_bench_cuts.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds,
# {"budget": a round budget} or {"aircomp": True})
CUT = ((dict(kind="dynamic", b=2, delta=0.5), M, 48, dict(budget=0.25)),
       (dict(kind="periodic", b=2), M, 24, dict(aircomp=True)))


def default_source(device="cuda"):
    return GraphicalModelStream(seed=0, drift_prob=0.0, device=device)


def _train(proto_kw: dict, rounds: int, jsonl, async_net=None,
           device="cuda", source=None, init_fn=None):
    """One run, streamed to ``jsonl`` (None: the recorder's ring only)."""
    cfg = get_arch(ARCH, smoke=True)
    dl, _ = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b),
        init_fn or (lambda g: init_cnn_params(cfg, g)),
        default_source(device) if source is None else source,
        m=M, rounds=rounds, protocol=ProtocolConfig(**proto_kw),
        train=TrainConfig(optimizer="sgd", learning_rate=0.05),
        batch=10, seed=0, record_every=max(1, rounds // 10),
        network=NET, async_net=async_net,
        telemetry=TelemetryConfig(path=jsonl, per_link=True),
        device=device)
    dl.recorder.close()
    return dl


def cut(case, device="cuda", source=None, init_fn=None):
    """One case of ``CUT``: ``(learner, {"network_time": ...})``."""
    proto, m, rounds, kw = case
    if m != M:
        raise ValueError(f"the bench's fleet is m = {M}, not {m}")
    net = AIRCOMP if kw.get("aircomp") else AsyncConfig(
        round_budget=kw["budget"], payload_bytes=PAYLOAD)
    dl = _train(proto, rounds, None, net, device, source, init_fn)
    return dl, {"network_time": dl.network_time}


def _path(stem: str) -> str:
    return os.path.normpath(os.path.join(OUT_DIR, f"{NAME}_{stem}.jsonl"))


def _fingerprint(dl):
    return (dict(dl.comm_totals),
            np.asarray(dl.link_bytes_totals).tolist(),
            float(dl.network_time))


def run(quick: bool = True, device="cuda"):
    os.makedirs(OUT_DIR, exist_ok=True)
    rounds = 48 if quick else 240
    rows = []
    for pname, proto_kw in PRESETS:
        # the no-AsyncConfig baseline the zero-delay reduction must hit
        base = _train(proto_kw, rounds, _path(f"base_{pname}"),
                      device=device)
        for regime, budget in REGIMES:
            jsonl = _path(f"{regime}_{pname}")
            dl = _train(proto_kw, rounds, jsonl,
                        AsyncConfig(round_budget=budget,
                                    payload_bytes=PAYLOAD), device)
            # everything below comes from the stream alone
            card = summarize(load_run(jsonl))
            inflight = [p[1] for p in card.get("inflight", [])]
            rows.append({
                "preset": pname, "regime": regime, "budget": budget,
                "m": M, "rounds": rounds,
                "cum_bytes": card["cum_bytes"],
                "cum_loss": round(card["cum_loss"], 4),
                "cum_syncs": card["cum_syncs"],
                "net_time_s": round(card["net_time_s"], 3),
                "inflight_mean": round(float(np.mean(inflight)), 3)
                if inflight else 0.0,
                "max_age_last": card.get("max_age_last", 0),
                "frontier_points": len(card["frontier"]),
                "stream_exact": bool(
                    card["cum_bytes"] == dl.comm_bytes()
                    and card["cum_syncs"] == dl.comm_totals["syncs"]
                    and card["cum_loss"] == dl.cumulative_loss),
                "zero_delay_exact": _fingerprint(dl) == _fingerprint(base)
                if regime == "sync" else None,
                "jsonl": jsonl,
            })
    rows.append(_aircomp_vs_digital(rounds, device))

    # the representative run card: the harsh dynamic frontier, rebuilt
    # from its JSONL after the fact
    with open(os.path.join(OUT_DIR, f"{NAME}_frontier.json"), "w") as f:
        json.dump(summarize(load_run(_path("harsh_dynamic"))), f, indent=1,
                  sort_keys=True)
    save_rows(NAME, rows)
    return rows


def _aircomp_vs_digital(rounds: int, device) -> dict:
    """Same fleet, same cadence, same rounds: the digital coordinator
    moves 2m payloads a sync, the analog channel 2, so the bytes ratio is
    exactly m when the sync counts agree."""
    digital_jsonl, air_jsonl = _path("digital"), _path("aircomp")
    _train(dict(kind="periodic", b=2), rounds, digital_jsonl, device=device)
    _train(dict(kind="periodic", b=2), rounds, air_jsonl, AIRCOMP, device)
    d_card = summarize(load_run(digital_jsonl))
    a_card = summarize(load_run(air_jsonl))
    return {
        "preset": "periodic", "regime": "aircomp", "m": M,
        "rounds": rounds, "snr_db": 20.0,
        "digital_bytes": d_card["cum_bytes"],
        "aircomp_bytes": a_card["cum_bytes"],
        "bytes_ratio": round(d_card["cum_bytes"]
                             / max(1, a_card["cum_bytes"]), 2),
        "cum_syncs": a_card["cum_syncs"],
        "syncs_equal": a_card["cum_syncs"] == d_card["cum_syncs"],
        "cum_loss": round(a_card["cum_loss"], 4),
        "digital_loss": round(d_card["cum_loss"], 4),
        "jsonl": air_jsonl,
    }


def check(rows) -> str:
    regime_rows = [r for r in rows if r["regime"] in
                   ("sync", "mild", "harsh")]
    air = next(r for r in rows if r["regime"] == "aircomp")
    ok = (
        # the covering budget IS the synchronous engine, bitwise
        all(r["zero_delay_exact"] for r in regime_rows
            if r["regime"] == "sync")
        # every stream's totals equal the live counters (int64 exact)
        and all(r["stream_exact"] for r in regime_rows)
        # harsher budgets put real messages in flight
        and all(r["inflight_mean"] > 0 for r in regime_rows
                if r["regime"] == "harsh")
        # frontiers reconstruct from the JSONL alone
        and all(r["frontier_points"] >= 2 for r in regime_rows)
        # analog superposition: one shared exchange vs m digital uplinks
        and air["syncs_equal"] and air["bytes_ratio"] == float(M))
    return "PASS" if ok else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
