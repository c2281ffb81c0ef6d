"""Shared helpers of the port's benchmarks — the twin of
``benchmarks/common.py`` on ``repro_torch``.

Every ``benchmarks/torch_<name>.py`` twin of a reference benchmark has
the reference module's ``NAME`` and ``PAPER_REF``, ``run(quick, device)
-> rows`` and its own copy of the reference's ``check(rows)``;
``benchmarks/torch_run.py`` runs them and writes their rows under
experiments/bench_torch/. The settings are the reference's (its quick
and full grids), at CPU-study scale: the protocol dynamics, not
wall-clock, are the object of study, but for the timing twins
(``scan_driver``, ``sync_bench``, ``shard_bench``, ``kernel_bench``).

Each twin also names its cut rows, the short runs that the parity tests
and ``chip_smoke.py`` hold to another run: ``ARCH`` (its smoke model),
``CUT`` (cases ``(protocol keywords, m, rounds, helper keywords)``),
``cut(case, device, source, init_fn) -> (learner, extra)`` (one case
through the twin's own helper; ``extra`` holds per-round series where
the figure has them; the learner is None where the cut is one round or
the kernels' rows) and ``default_source(device)`` (the stream the twin
draws from, where it has one); ``cut_init`` gives the cut rows' initial
model. The helpers take a ``source`` and an ``init_fn`` so
that a caller can feed fixed draws: ``ReplaySource`` hands out given
batches in the order the learner streams ask for them, which is how the
parity tests run a twin on the reference's own batches and initial
model; ``RecordSource`` keeps what a source handed out, which is how
``chip_smoke.py`` replays a row drawn on the CPU on the card. The
per-sample draws otherwise come from a ``torch.Generator`` on the
device, so a twin's rows are not the reference's draw for draw.
"""
from __future__ import annotations

import json
import os
import sys
from typing import List

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(_ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(_ROOT, "src"))

import torch  # noqa: E402

from repro_torch.config import (  # noqa: E402
    ProtocolConfig, TrainConfig, get_arch,
)
from repro_torch.data.synthetic import SyntheticMNIST  # noqa: E402
from repro_torch.models.cnn import (  # noqa: E402
    cnn_accuracy, cnn_loss, init_cnn_params,
)
from repro_torch.train.loop import run_protocol_training  # noqa: E402

OUT_DIR = os.path.join(_ROOT, "experiments", "bench_torch")


class ReplaySource:
    """A data source that hands out the given batches in order: each
    ``sample(generator, batch, lead)`` call takes the next dict of
    arrays, which must have the shape ``(*lead, batch, ...)``, and
    returns it as tensors on ``device``. Drifts change nothing: the
    draws are fixed already."""

    def __init__(self, batches, device="cpu"):
        self.device = torch.device(device)
        self._queue = list(batches)

    def sample(self, generator, batch: int, lead: tuple = ()):
        if not self._queue:
            raise ValueError("the replay source has no batches left")
        b = self._queue.pop(0)
        out = {k: torch.as_tensor(v).to(self.device) for k, v in b.items()}
        for k, v in out.items():
            if tuple(v.shape[:len(lead) + 1]) != (*lead, batch):
                raise ValueError(
                    f"replayed {k!r} has shape {tuple(v.shape)}, the "
                    f"stream asked for {(*lead, batch)}")
        return out

    def force_drift(self):
        pass

    @property
    def remaining(self) -> int:
        return len(self._queue)


class RecordSource:
    """A source that keeps, as numpy arrays, every batch that ``source``
    hands out, in order (``batches``), for a ``ReplaySource`` to hand
    out again; drifts go to ``source``."""

    def __init__(self, source):
        self.source, self.device, self.batches = source, source.device, []

    def sample(self, generator, batch: int, lead: tuple = ()):
        out = self.source.sample(generator, batch, lead)
        self.batches.append({k: v.cpu().numpy() for k, v in out.items()})
        return out

    def force_drift(self):
        self.source.force_drift()


def mnist_setup(image_size: int = 14):
    """The smoke MNIST CNN of the reference's benchmarks: (config, loss,
    init)."""
    cfg = get_arch("mnist_cnn", smoke=True)
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)      # noqa: E731
    init_fn = lambda g: init_cnn_params(cfg, g)     # noqa: E731
    return cfg, loss_fn, init_fn


def run_mnist_protocol(proto, m: int, rounds: int, lr: float = 0.1,
                       optimizer: str = "sgd", seed: int = 0,
                       batch: int = 10, init_heterogeneity: float = 0.0,
                       image_size: int = 14, device="cuda", source=None,
                       init_fn=None):
    """``run_protocol_training`` of the smoke MNIST CNN on
    ``SyntheticMNIST(seed=0)`` (or ``source``), then the mean model's
    accuracy on 512 test images drawn on the device: ``(learner,
    trajectory, accuracy)``."""
    cfg, loss_fn, default_init = mnist_setup(image_size)
    test_src = mnist_source(device, image_size)
    src = test_src if source is None else source
    dl, traj = run_protocol_training(
        loss_fn, init_fn or default_init, src, m=m, rounds=rounds,
        protocol=proto,
        train=TrainConfig(optimizer=optimizer, learning_rate=lr),
        batch=batch, seed=seed, init_heterogeneity=init_heterogeneity,
        device=device)
    gen = torch.Generator(device=test_src.device).manual_seed(10_000)
    test = test_src.sample(gen, 512)
    acc = float(cnn_accuracy(cfg, dl.mean_model(), test))
    return dl, traj, acc


def mnist_source(device="cuda", image_size: int = 14):
    """The stream of the MNIST figures (and their test images)."""
    return SyntheticMNIST(seed=0, image_size=image_size, device=device)


def mnist_cut(case, device="cuda", source=None, init_fn=None):
    """One cut row of an MNIST figure: ``case`` = (protocol keywords, m,
    rounds, ``run_mnist_protocol`` keywords) -> ``(learner, {"accuracy":
    the mean model's})``."""
    proto, m, rounds, kw = case
    dl, _, acc = run_mnist_protocol(ProtocolConfig(**proto), m, rounds,
                                    device=device, source=source,
                                    init_fn=init_fn, **kw)
    return dl, {"accuracy": acc}


def cut_init(mod):
    """The initial model, as numpy, that a twin's cut rows start from in
    the parity tests and ``chip_smoke.py``: the twin's own ``cut_init()``
    where it has one, else its smoke ``ARCH`` drawn from
    ``torch.Generator().manual_seed(0)`` on the CPU; None for a twin
    without a model."""
    if hasattr(mod, "cut_init"):
        return mod.cut_init()
    if mod.ARCH is None:
        return None
    from repro_torch.convert import params_to_numpy
    return params_to_numpy(init_cnn_params(
        get_arch(mod.ARCH, smoke=True), torch.Generator().manual_seed(0)))


def finish(device) -> None:
    """Wait for the card's queued work (a no-op on the CPU), so that a
    host clock read next times the work, not its launches."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def save_rows(name: str, rows: List[dict]) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1, default=str)
    return path

