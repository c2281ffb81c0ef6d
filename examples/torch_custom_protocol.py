"""Composing a protocol from registered stages in the PyTorch port.

The twin of ``examples/custom_protocol.py``. A protocol is a
declarative ``ProtocolSpec``: one registered stage a slot, handed to the
engine. Three protocols run on an unreliable ten-learner fleet with no
edit of the engine:

1. bounded staleness (the shipped ``"stale"`` preset): the fleet
   averages the moment any reachable learner has gone tau rounds
   unsynchronized, a period under full availability that adapts under
   dropout;
2. staleness-triggered FedAvg: the same trigger with the random
   C-fraction cohort, a new protocol in four lines;
3. the classic dynamic averaging baseline.

The custom spec then round-trips through JSON (what
``python -m benchmarks.torch_run --protocol <file>`` takes) and the
restored spec drives the engine to the same counters.

    PYTHONPATH=src python examples/torch_custom_protocol.py            # the card
    PYTHONPATH=src python examples/torch_custom_protocol.py --device cpu --smoke
"""
import argparse

import torch

from repro_torch.config import (
    NetworkConfig, ProtocolConfig, TrainConfig, get_arch,
)
from repro_torch.core.sync import ProtocolSpec
from repro_torch.core.sync.staleness import BOUNDED_STALENESS
from repro_torch.data.synthetic import SyntheticMNIST
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params
from repro_torch.train.loop import run_protocol_training

M = 10
FLEET = NetworkConfig(act_prob=0.6, straggler_frac=0.3,
                      straggler_act_prob=0.3, link_classes=("wifi", "lte"))
PROTOCOLS = {
    # the shipped preset; the spec form exposes the trigger's tau
    "stale(tau=8)": BOUNDED_STALENESS.with_params(tau=8),
    # a new composition: the staleness trigger driving FedAvg's cohort
    "stale_fedavg": ProtocolSpec(
        trigger="staleness", cohort="fraction", commit="subset",
        params={"tau": 8, "fedavg_c": 0.4}, name="stale_fedavg"),
    # the paper's baseline
    "dynamic": ProtocolConfig(kind="dynamic", b=8, delta=0.5),
}
FULL, SMOKE = (300, 100), (40, 20)      # rounds; the JSON reruns' rounds


def run(name, proto, rounds, device="cuda", source=None, init_fn=None):
    """One fleet run on the smoke MNIST CNN; prints its line and returns
    the learner (``source`` and ``init_fn`` default to the example's own
    draws)."""
    cfg = get_arch("mnist_cnn", smoke=True)
    src = source or SyntheticMNIST(seed=0, image_size=14, device=device)
    dl, _ = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b),
        init_fn or (lambda g: init_cnn_params(cfg, g)),
        src, m=M, rounds=rounds, protocol=proto,
        train=TrainConfig(optimizer="sgd", learning_rate=0.1),
        batch=10, network=FLEET, device=device)
    test = SyntheticMNIST(seed=0, image_size=14, device=device).sample(
        torch.Generator(device=device).manual_seed(10_000), 512)
    acc = float(cnn_accuracy(cfg, dl.mean_model(), test))
    print(f"  {name:<14} acc={acc:.3f} syncs={dl.comm_totals['syncs']:>4} "
          f"bytes={dl.comm_bytes() / 1e6:7.1f}MB "
          f"net_time={dl.network_time:7.1f}s")
    return dl


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="fewer rounds (CI smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rounds, rerun = SMOKE if args.smoke else FULL

    print(f"{M} learners, 60% availability with stragglers, wifi/lte "
          f"links, on {args.device}")
    for name, proto in PROTOCOLS.items():
        run(name, proto, rounds, args.device)

    # the custom composition from its JSON form
    spec = PROTOCOLS["stale_fedavg"]
    blob = spec.to_json()
    print("\nstale_fedavg as the JSON `benchmarks/torch_run.py --protocol` "
          "takes:\n" + blob)
    restored = ProtocolSpec.from_json(blob)
    if restored != spec:
        raise SystemExit("the JSON round trip changed the spec")
    a = run("original", spec, rerun, args.device)
    b = run("from JSON", restored, rerun, args.device)
    if a.comm_totals != b.comm_totals:
        raise SystemExit(f"the restored spec ran otherwise: "
                         f"{a.comm_totals} vs {b.comm_totals}")
    print("restored spec reproduces the run exactly")
    print("torch_custom_protocol_done")


if __name__ == "__main__":
    main()
