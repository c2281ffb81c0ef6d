"""Decentralized training of a ~100M-parameter LM in the PyTorch port.

The twin of ``examples/fleet_llm.py``. Four learners ("pods") train a
12-layer, d_model 768 llama-family model (``--big``: fleet-llm-100m,
107.0 M weights at f32: 12/4 heads of llama3-8b's head_dim 128, which
the reference's replace keeps) or its ~31M variant on disjoint bigram-Markov
token streams (``TokenStream(seed=100 + i)``) with the dynamic averaging
protocol: the model definition, the learner-stacked train state and the
dynamic-averaging step of ``repro_torch.core.distributed``, adam at
3e-4, B = 4 x S = 128 tokens a learner a step. On the card every
learner's norms and attention, forward and backward, run as one kernel
launch per layer and op for all four (the kernels' vmap rules). It
prints tokens/s and, at the end, how many condition checks triggered
averaging, and writes the first learner's model with
``checkpoint.io.save_pytree`` under ``build/`` (gitignored).

    PYTHONPATH=src python examples/torch_fleet_llm.py --big      # the card
    PYTHONPATH=src python examples/torch_fleet_llm.py --device cpu --steps 5
"""
import argparse
import dataclasses
import os
import time

import torch

from repro_torch import prng
from repro_torch.checkpoint.io import save_pytree
from repro_torch.config import (
    ModelConfig, ProtocolConfig, TrainConfig, get_arch,
)
from repro_torch.core.distributed import (
    init_dynamic_state, make_dynamic_train_step,
)
from repro_torch.core.flatten import tree_map
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models.model import init_lm_params, lm_loss

M = 4                      # learners ("pods")
B, S = 4, 128              # per-learner batch
OUT = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "build", "fleet_llm",
    "torch_fleet_llm_final.npz"))


def fleet_model(big: bool = False) -> ModelConfig:
    """~100M-param llama-family model (--big) or a ~25M variant."""
    base = get_arch("llama3-8b")
    if big:
        return dataclasses.replace(
            base, name="fleet-llm-100m", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=8192,
            dtype="float32")
    return dataclasses.replace(
        base, name="fleet-llm-25m", num_layers=6, d_model=512,
        num_heads=8, num_kv_heads=4, d_ff=1408, vocab_size=8192,
        dtype="float32")


def stacked_batch(streams, key, device) -> dict:
    """Learner i's batch from stream i with ``fold_in(key, i)``, stacked
    on a leading learner axis."""
    batches = [s.sample(prng.fold_in(key, i, device), B, S)
               for i, s in enumerate(streams)]
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--delta", type=float, default=5.0)
    ap.add_argument("--sync-every", type=int, default=10)
    ap.add_argument("--big", action="store_true",
                    help="~100M-param model (the full example config)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--out", default=OUT, help="the checkpoint's path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = fleet_model(args.big)
    n_params = cfg.param_count()
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params), "
          f"m={M} learners, batch {B}x{S} tokens each")

    train = TrainConfig(optimizer="adam", learning_rate=3e-4, remat=False)

    def loss_fn(p, b):
        return lm_loss(cfg, p, b, remat=train.remat)

    proto = ProtocolConfig(kind="dynamic", b=args.sync_every,
                           delta=args.delta)
    step = make_dynamic_train_step(loss_fn, proto, train, M)
    state = init_dynamic_state(
        lambda g: init_lm_params(cfg, seed=0, device=dev),
        torch.Generator(device=dev).manual_seed(0), M, train, device=dev)

    streams = [TokenStream(seed=100 + i, vocab=cfg.vocab_size, device=dev)
               for i in range(M)]
    key = prng.key(1, dev)
    t0 = time.time()
    for t in range(args.steps):
        key, sub = prng.split(key, 2, dev)
        state, metrics = step(state, stacked_batch(streams, sub, dev))
        if (t + 1) % 20 == 0 or t + 1 == args.steps:
            print(f"step {t+1:4d} loss {float(metrics['loss']):.4f} "
                  f"syncs {state.syncs:3d} "
                  f"({(t+1)*M*B*S/(time.time()-t0):,.0f} tok/s)")

    save_pytree(args.out, {"params": tree_map(lambda x: x[0], state.params),
                           "step": state.step})
    checks = max(state.checks, 1)
    print(f"\ndone: {state.syncs}/{checks} condition checks triggered "
          f"averaging -> {100*state.syncs/checks:.0f}% of the periodic "
          f"protocol's communication at the same cadence.")
    print(f"checkpoint: {args.out}")
    return state


if __name__ == "__main__":
    main()
