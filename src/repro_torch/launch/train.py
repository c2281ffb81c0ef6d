"""The training launcher — the counterpart of ``repro.launch.train``.

Trains any config of the zoo with the reference's protocol, on the card
unless ``--device cpu`` asks for the CPU; ``--smoke`` takes the reduced
config and tiny shapes:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --mode train_dynamic --steps 20 --device cpu

``--mode train`` is the sigma_1 baseline (``train.step.make_train_step``,
adam); ``train_dynamic`` and ``train_periodic`` run ``--learners``
learners through ``core.distributed``'s steps. Each step emits the
reference's ``train_step`` event (``step``, ``loss``, and ``synced`` for
the fleet modes) and the run ends with ``train_done`` (``steps``,
``seconds``, ``mode``, ``arch``), through the telemetry logger, to which
this entry point attaches the console handler.

Batches follow the reference's ``make_batch``: text from a
``TokenStream(seed=0)`` drawn with the reference's keys (``prng``, bit
for bit), audio's four codebooks by ``prng.randint``, and the vision
config's stub prefix of 8 patch embeddings, ``0.02 * normal``.
Departures: ``init_lm_params`` draws from its own ``torch.Generator``
seeded with 0 (the init-key departure of ``models/model.py``); the
stream's V x V chain cannot be built at a full-size vocabulary (131.6
GB at llama3-8b's, in the reference too, ROADMAP), so without
``--smoke`` only the configs of small vocabulary run, as in the
reference.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import prng
from repro_torch.config import (
    INPUT_SHAPES, ProtocolConfig, ShapeConfig, TrainConfig, get_arch,
)
from repro_torch.core.distributed import (
    init_dynamic_state, make_dynamic_train_step, make_periodic_train_step,
)
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models.model import AUDIO_CODEBOOKS, init_lm_params, lm_loss
from repro_torch.telemetry import console_handler, get_logger
from repro_torch.train.step import make_train_step

VISION_PREFIX = 8       # the vision stub's patch embeddings a sample


def smoke_shape(cfg) -> ShapeConfig:
    return ShapeConfig("smoke", seq_len=64, global_batch=8, kind="train")


def make_batch(cfg, key, batch: int, seq: int, stream: TokenStream,
               device="cuda") -> dict:
    """One batch on ``device`` from the ``prng`` key ``key``."""
    dev = resolve_device(device)
    if cfg.modality == "audio":
        toks = prng.randint(key, (batch, seq, AUDIO_CODEBOOKS), 0,
                            cfg.vocab_size, dev).long()
        return {"tokens": toks, "labels": toks}
    b = stream.sample(key, batch, seq)
    if cfg.modality == "vision":
        b["prefix_embeds"] = 0.02 * prng.normal(
            prng.fold_in(key, 3, dev), (batch, VISION_PREFIX, cfg.d_model),
            dev)
    return b


def _stack(batches: list) -> dict:
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", default="train",
                    choices=("train", "train_dynamic", "train_periodic"))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shapes")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--learners", type=int, default=2)
    ap.add_argument("--delta", type=float, default=10.0)
    ap.add_argument("--b", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke)
    shape = smoke_shape(cfg) if args.smoke else INPUT_SHAPES["train_4k"]
    # the reference's launcher takes no rematerialized layers either
    train = TrainConfig(optimizer="adam", learning_rate=args.lr, remat=False)

    def loss_fn(p, b):
        return lm_loss(cfg, p, b, remat=train.remat)

    stream = TokenStream(seed=0, vocab=cfg.vocab_size, device=dev)
    key = prng.key(0, dev)

    if args.mode == "train":
        init_state, step = make_train_step(loss_fn, train, device=dev)
        state = init_state(init_lm_params(cfg, seed=0, device=dev))

        def next_batch(k):
            return make_batch(cfg, k, shape.global_batch, shape.seq_len,
                              stream, dev)
    else:
        m = args.learners
        proto = ProtocolConfig(kind="dynamic", b=args.b, delta=args.delta)
        mk = (make_dynamic_train_step if args.mode == "train_dynamic"
              else make_periodic_train_step)
        step = mk(loss_fn, proto, train, m)
        state = init_dynamic_state(
            lambda g: init_lm_params(cfg, seed=0, device=dev),
            torch.Generator(device=dev).manual_seed(0), m, train, device=dev)

        def next_batch(k):
            per = max(shape.global_batch // m, 1)
            return _stack([make_batch(cfg, prng.fold_in(k, i, dev), per,
                                      shape.seq_len, stream, dev)
                           for i in range(m)])

    # progress goes through the telemetry event logger: the loop emits
    # structured events; THIS entry point attaches the text formatter
    log = get_logger()
    handler = log.add_handler(console_handler())
    t0 = time.perf_counter()
    try:
        for t in range(args.steps):
            key, sub = prng.split(key, 2, dev)
            state, metrics = step(state, next_batch(sub))
            fields = {"step": t + 1, "loss": float(metrics["loss"])}
            if "synced" in metrics:
                fields["synced"] = int(metrics["synced"])
            log.event("train_step", **fields)
        log.event("train_done", steps=args.steps,
                  seconds=time.perf_counter() - t0, mode=args.mode,
                  arch=cfg.name)
    finally:
        log.remove_handler(handler)


if __name__ == "__main__":
    main()
