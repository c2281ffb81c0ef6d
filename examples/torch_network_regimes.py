"""Operating regimes under connectivity constraints, in the PyTorch port:
availability × topology.

The twin of ``benchmarks/fig_network_regimes.py``: the drift-MLP task
(m = 8) runs inside the simulated network (``repro_torch.network``) —
dynamic averaging, a coordinator protocol limited by availability, and
gossip, limited by availability and by the peer overlay — over
``act_prob`` in {1.0, 0.7, 0.4} and the star, ring and mobile geometric
overlays, beside a ``network=None`` baseline.

Its check: the ideal row (star, ``act_prob=1.0``, dynamic) equals the
baseline bit for bit (bytes, syncs and cumulative loss), every loss is
finite, and no dynamic run under a network moves more than 1.5 times the
baseline's bytes. It exits non-zero when the check fails.

    PYTHONPATH=src python examples/torch_network_regimes.py            # the card
    PYTHONPATH=src python examples/torch_network_regimes.py --device cpu --quick
"""
import argparse
import math
import sys

from repro_torch.config import (
    NetworkConfig, ProtocolConfig, TrainConfig, get_arch,
)
from repro_torch.data.synthetic import GraphicalModelStream
from repro_torch.models.cnn import cnn_loss, init_cnn_params
from repro_torch.train.loop import run_protocol_training

M = 8
ACT_PROBS = (1.0, 0.7, 0.4)
TOPOLOGIES = ("star", "ring", "geometric")


def network_config(topo: str, act: float) -> NetworkConfig:
    """The grid's network at overlay ``topo`` and availability ``act``."""
    return NetworkConfig(topology=topo, act_prob=act, geo_radius=0.6,
                         redraw_every=20 if topo == "geometric" else 0,
                         link_classes=("wifi", "lte"))


def run_one(proto, network, rounds: int, device: str, source=None,
            init_fn=None):
    """One run of the grid: the drift MLP on ``GraphicalModelStream(seed=1)``
    (or ``source``) from ``init_fn`` (default: the port's own draw)."""
    cfg = get_arch("drift_mlp", smoke=True)
    src = (GraphicalModelStream(seed=1, drift_prob=0.0, device=device)
           if source is None else source)
    dl, _ = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b),
        init_fn or (lambda g: init_cnn_params(cfg, g)), src, m=M,
        rounds=rounds, protocol=proto,
        train=TrainConfig(optimizer="sgd", learning_rate=0.05), batch=10,
        seed=0, network=network, device=device)
    return dl


def _row(name, topo, act, dl):
    return {"protocol": name, "topology": topo, "act_prob": act,
            "cumulative_loss": dl.cumulative_loss,
            "comm_bytes": dl.comm_bytes(), "syncs": dl.comm_totals["syncs"],
            "mean_active": dl.mean_active(), "sim_net_s": dl.network_time}


def run(rounds: int, device: str):
    dyn = ProtocolConfig(kind="dynamic", b=5, delta=0.5)
    gsp = ProtocolConfig(kind="gossip", b=5)
    rows = [_row("dynamic", "none", 1.0,
                 run_one(dyn, None, rounds, device))]
    for topo in TOPOLOGIES:
        for act in ACT_PROBS:
            net = network_config(topo, act)
            for name, proto in (("dynamic", dyn), ("gossip", gsp)):
                rows.append(_row(name, topo, act,
                                 run_one(proto, net, rounds, device)))
    return rows


def check(rows) -> bool:
    base = rows[0]
    ideal = next(r for r in rows if r["topology"] == "star"
                 and r["act_prob"] == 1.0 and r["protocol"] == "dynamic")
    regression = all(ideal[k] == base[k] for k in
                     ("comm_bytes", "syncs", "cumulative_loss"))
    finite = all(math.isfinite(r["cumulative_loss"]) for r in rows)
    bounded = all(r["comm_bytes"] <= 1.5 * base["comm_bytes"] for r in rows
                  if r["protocol"] == "dynamic" and r["topology"] != "none")
    return regression and finite and bounded


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="120 rounds a run instead of 600")
    args = ap.parse_args(argv)
    rows = run(120 if args.quick else 600, args.device)
    for r in rows:
        print(r)
    ok = check(rows)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
