"""Quickstart for the PyTorch port: decentralized training with dynamic
model averaging, on the card.

Ten learners train the paper's MNIST CNN (the reduced 14x14 config, as
``examples/quickstart.py``); the dynamic averaging protocol (sigma_Delta)
gates every synchronization on the model-divergence local conditions,
and its communication bill is compared with periodic averaging at equal
predictive performance. Dynamic averaging must communicate less; the
script exits non-zero otherwise.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import sys

import torch

from repro_torch.config import ProtocolConfig, TrainConfig, get_arch
from repro_torch.data.synthetic import SyntheticMNIST
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params
from repro_torch.train.loop import run_protocol_training


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=150)
    args = ap.parse_args(argv)

    cfg = get_arch("mnist_cnn", smoke=True)
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init_fn = lambda g: init_cnn_params(cfg, g)          # noqa: E731
    src = SyntheticMNIST(seed=0, image_size=14, device=args.device)
    test = src.sample(torch.Generator(device=src.device).manual_seed(999),
                      512)

    comm = {}
    for name, proto in [
        ("periodic b=10", ProtocolConfig(kind="periodic", b=10)),
        ("dynamic Δ=0.7", ProtocolConfig(kind="dynamic", b=10, delta=0.7)),
    ]:
        dl, traj = run_protocol_training(
            loss_fn, init_fn, src, m=args.m, rounds=args.rounds,
            protocol=proto,
            train=TrainConfig(optimizer="sgd", learning_rate=0.1),
            batch=10, seed=0, device=args.device)
        acc = float(cnn_accuracy(cfg, dl.mean_model(), test))
        comm[name] = dl.comm_bytes()
        print(f"{name:16s} cumulative_loss={dl.cumulative_loss:9.1f} "
              f"comm={dl.comm_bytes() / 1e6:8.1f}MB accuracy={acc:.3f}")

    comm_p, comm_d = comm.values()
    print(f"\ndynamic averaging used {100 * (1 - comm_d / comm_p):.0f}% "
          f"less communication than periodic averaging.")
    return 0 if comm_d < comm_p else 1


if __name__ == "__main__":
    sys.exit(main())
