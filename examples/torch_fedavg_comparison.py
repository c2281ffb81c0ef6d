"""Dynamic averaging against Federated Averaging (McMahan et al. 2017) in
the PyTorch port.

The twin of ``examples/fedavg_comparison.py``. FedAvg cuts periodic
averaging's bill by sub-sampling a C-fraction of learners a round, but
it still pays every round. Dynamic averaging pays only when the models
diverge, so as the learners converge its bill flattens while FedAvg's
keeps growing (the paper's Fig. 5.2). The cohort draws are the
reference's (``repro_torch.prng``, jax's threefry stream bit for bit).

    PYTHONPATH=src python examples/torch_fedavg_comparison.py            # the card
    PYTHONPATH=src python examples/torch_fedavg_comparison.py --device cpu --smoke
"""
import argparse

import torch

from repro_torch.config import ProtocolConfig, TrainConfig, get_arch
from repro_torch.data.synthetic import SyntheticMNIST
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params
from repro_torch.train.loop import run_protocol_training

M = 10
PROTOCOLS = [
    ("fedavg C=0.3", ProtocolConfig(kind="fedavg", b=10, fedavg_c=0.3)),
    ("fedavg C=0.7", ProtocolConfig(kind="fedavg", b=10, fedavg_c=0.7)),
    ("dynamic Δ=1.2", ProtocolConfig(kind="dynamic", b=10, delta=1.2)),
]
FULL_ROUNDS, SMOKE_ROUNDS = 260, 40


def run(proto, rounds, device="cuda", source=None, init_fn=None):
    """(learner, trajectory) of one run on the smoke MNIST CNN
    (``source`` and ``init_fn`` default to the example's own draws)."""
    cfg = get_arch("mnist_cnn", smoke=True)
    return run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b),
        init_fn or (lambda g: init_cnn_params(cfg, g)),
        source or SyntheticMNIST(seed=0, image_size=14, device=device),
        m=M, rounds=rounds, protocol=proto,
        train=TrainConfig(optimizer="sgd", learning_rate=0.1),
        batch=10, seed=0, record_every=10, device=device)


def quartiles(traj) -> list:
    """KB sent by 25 / 50 / 75 / 100% of training."""
    curve = traj.cumulative_bytes
    return [int(curve[len(curve) * i // 4 - 1]) // 1024 for i in (1, 2, 3, 4)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="fewer rounds (CI smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rounds = SMOKE_ROUNDS if args.smoke else FULL_ROUNDS
    cfg = get_arch("mnist_cnn", smoke=True)

    print(f"{'protocol':16s} {'comm':>10s} {'cumloss':>9s} {'acc':>6s}   "
          f"comm curve (KB at 25% / 50% / 75% / 100% of training)")
    for name, proto in PROTOCOLS:
        dl, traj = run(proto, rounds, args.device)
        test = SyntheticMNIST(seed=0, image_size=14,
                              device=args.device).sample(
            torch.Generator(device=args.device).manual_seed(999), 512)
        acc = float(cnn_accuracy(cfg, dl.mean_model(), test))
        print(f"{name:16s} {dl.comm_bytes()/1e6:8.2f}MB "
              f"{dl.cumulative_loss:9.1f} {acc:6.3f}   {quartiles(traj)}")
    print("torch_fedavg_comparison_done")


if __name__ == "__main__":
    main()
