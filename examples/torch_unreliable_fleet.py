"""An unreliable fleet in the PyTorch port: dynamic averaging when the
network fights back.

The twin of ``examples/unreliable_fleet.py``. Ten learners on the
network the paper's cars and phones live on (``NetworkConfig``): 60%
availability a round with three stragglers at 30%, a random-geometric
peer overlay re-drawn every 20 rounds (mobility), and mixed wifi/lte
links, so a synchronization's wall-clock is its slowest link's. Three
protocols end to end: periodic averaging, dynamic averaging and gossip
(no coordinator; it averages over the mobile overlay). The masks, the
overlays and the link costs are pure in ``(seed, t)``
(``repro_torch.network``).

    PYTHONPATH=src python examples/torch_unreliable_fleet.py            # the card
    PYTHONPATH=src python examples/torch_unreliable_fleet.py --device cpu --smoke
"""
import argparse

import torch

from repro_torch.config import (
    NetworkConfig, ProtocolConfig, TrainConfig, get_arch,
)
from repro_torch.data.synthetic import SyntheticMNIST
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params
from repro_torch.train.loop import run_protocol_training

M = 10
FLEET = NetworkConfig(
    topology="geometric", geo_radius=0.6, redraw_every=20,
    act_prob=0.6, straggler_frac=0.3, straggler_act_prob=0.3,
    link_classes=("wifi", "lte"),
)
PROTOCOLS = [("periodic b=10", ProtocolConfig(kind="periodic", b=10)),
             ("dynamic Δ=0.7", ProtocolConfig(kind="dynamic", b=10,
                                              delta=0.7)),
             ("gossip  b=10", ProtocolConfig(kind="gossip", b=10))]
FULL_ROUNDS, SMOKE_ROUNDS = 150, 40


def run(proto, rounds, device="cuda", source=None, init_fn=None):
    """The learner of one run on the smoke MNIST CNN (``source`` and
    ``init_fn`` default to the example's own draws)."""
    cfg = get_arch("mnist_cnn", smoke=True)
    dl, _ = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b),
        init_fn or (lambda g: init_cnn_params(cfg, g)),
        source or SyntheticMNIST(seed=0, image_size=14, device=device),
        m=M, rounds=rounds, protocol=proto,
        train=TrainConfig(optimizer="sgd", learning_rate=0.1),
        batch=10, seed=0, network=FLEET, device=device)
    return dl


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="fewer rounds (CI smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rounds = SMOKE_ROUNDS if args.smoke else FULL_ROUNDS
    cfg = get_arch("mnist_cnn", smoke=True)

    print(f"fleet: m={M}, act_prob={FLEET.act_prob}, "
          f"{FLEET.straggler_frac:.0%} stragglers, "
          f"topology={FLEET.topology} (re-drawn every "
          f"{FLEET.redraw_every} rounds), links={FLEET.link_classes}, "
          f"on {args.device}\n")
    for name, proto in PROTOCOLS:
        dl = run(proto, rounds, args.device)
        test = SyntheticMNIST(seed=0, image_size=14,
                              device=args.device).sample(
            torch.Generator(device=args.device).manual_seed(999), 512)
        acc = float(cnn_accuracy(cfg, dl.mean_model(), test))
        ledger = dl.per_link_bytes()
        busiest = int(ledger.argmax())
        print(f"{name:14s} loss={dl.cumulative_loss:9.1f} "
              f"comm={dl.comm_bytes() / 1e6:7.1f}MB "
              f"net_time={dl.network_time:7.2f}s "
              f"reachable={dl.mean_active():.0%} "
              f"accuracy={acc:.3f} "
              f"busiest_link=#{busiest} "
              f"({ledger[busiest] / 1e6:.1f}MB)")

    print("\ndynamic averaging keeps its communication advantage under "
          "dropout: violations simply wait for the violator to come back "
          "in reach, while periodic pays for every reachable learner every "
          "b rounds; gossip needs no coordinator but its mixing (and its "
          "bytes) track the mobile overlay's density.")
    print("torch_unreliable_fleet_done")


if __name__ == "__main__":
    main()
