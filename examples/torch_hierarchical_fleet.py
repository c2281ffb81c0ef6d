"""A two-tier fleet in the PyTorch port: edge aggregators between the
devices and the cloud.

The twin of ``examples/hierarchical_fleet.py``. Phones in a depot sync
with the depot's edge server over cheap local links, and only the edge
servers talk to the coordinator over the backhaul. ``HierarchyConfig``
says so: the flat protocol runs inside each cluster against its edge
aggregator, and a second one, with its own cadence, threshold and
payload size, runs among the aggregators. The per-link ledger prices
each tier at its own payload, so an 8-bit backhaul stays exact.

Twelve learners in three clusters on a flaky network: flat dynamic
averaging against two-tier dynamic averaging with a looser inter-tier
threshold and a 1-byte-a-weight backhaul.

    PYTHONPATH=src python examples/torch_hierarchical_fleet.py            # the card
    PYTHONPATH=src python examples/torch_hierarchical_fleet.py --device cpu --smoke
"""
import argparse

from repro_torch.config import (
    HierarchyConfig, NetworkConfig, ProtocolConfig, TrainConfig, get_arch,
)
from repro_torch.data.synthetic import SyntheticMNIST
from repro_torch.models.cnn import cnn_loss, init_cnn_params
from repro_torch.train.loop import run_protocol_training

M, CLUSTERS = 12, 3
FLEET = NetworkConfig(act_prob=0.8, link_classes=("wifi", "lte"))
FLAT = ProtocolConfig(kind="dynamic", b=5, delta=0.5)
TWO_TIER = ProtocolConfig(
    kind="dynamic", b=5, delta=0.5,        # intra: devices <-> edge server
    tiers=HierarchyConfig(
        num_clusters=CLUSTERS,
        inter=ProtocolConfig(kind="dynamic", b=10, delta=1.0,
                             bytes_per_param=1),   # quantized backhaul
        link_class="wired",
    ),
)
FULL_ROUNDS, SMOKE_ROUNDS = 150, 40


def run(proto, rounds, device="cuda", source=None, init_fn=None) -> tuple:
    """(learner, member-link bytes, coordinator-uplink bytes) of one run
    (``source`` and ``init_fn`` default to the example's own draws)."""
    cfg = get_arch("mnist_cnn", smoke=True)
    dl, _ = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b),
        init_fn or (lambda g: init_cnn_params(cfg, g)),
        source or SyntheticMNIST(seed=0, image_size=14, device=device),
        m=M, rounds=rounds, protocol=proto,
        train=TrainConfig(optimizer="sgd", learning_rate=0.1),
        batch=10, seed=0, network=FLEET, device=device)
    ledger = dl.per_link_bytes()
    if int(ledger.sum()) != dl.comm_bytes():
        raise SystemExit("the ledger does not balance")
    member, uplink = int(ledger[:M].sum()), int(ledger[M:].sum())
    return dl, member, (uplink if len(ledger) > M else member)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="fewer rounds (CI smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rounds = SMOKE_ROUNDS if args.smoke else FULL_ROUNDS

    print(f"fleet: m={M} in {CLUSTERS} clusters, act_prob={FLEET.act_prob}, "
          f"links={FLEET.link_classes}, backhaul=wired (8-bit payload), "
          f"on {args.device}\n")
    for name, proto in [("flat dynamic", FLAT),
                        ("two-tier dynamic", TWO_TIER)]:
        dl, member, uplink = run(proto, rounds, args.device)
        print(f"{name:17s} loss={dl.cumulative_loss:9.1f} "
              f"total={dl.comm_bytes() / 1e6:6.1f}MB "
              f"member_links={member / 1e6:6.1f}MB "
              f"coordinator_uplinks={uplink / 1e6:6.1f}MB "
              f"net_time={dl.network_time:6.2f}s")

    print("\nthe edge tier absorbs the chatter: intra-cluster violations "
          "settle against the local aggregator, and only the aggregators' "
          "(quantized) models cross the backhaul — the ledger prices every "
          "link exactly, per tier.")
    print("torch_hierarchical_fleet_done")


if __name__ == "__main__":
    main()
