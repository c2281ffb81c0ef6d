"""The launcher twin (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``) on the CPU.

Each mode (``train``, ``train_dynamic``, ``train_periodic``) runs
in-process with ``--smoke`` on llama3-8b for ``STEPS`` steps in both
packages (the port with ``--device cpu``): the same events in the same
order (``train_step`` per step, then ``train_done``), each with the
reference's keys, the same step numbers, ``mode`` and ``arch``, finite
losses, and the loss falling: the mean of the last three steps below
the mean of the first three in each package. The two runs start from
different weights (the port draws its own, ``init_lm_params``'s
departure), so their losses and sync decisions are not compared here;
``tests/test_torch_lm_train.py`` compares the steps on the reference's
weights. ``make_batch`` draws the reference's batches: text from the
``TokenStream`` bit for bit, audio's codebooks by ``randint`` bit for
bit, the vision prefix by ``normal`` within ``prng.NORMAL_TOL``.
"""
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.config import get_arch as jget_arch  # noqa: E402
from repro.data.synthetic import TokenStream as JTokenStream  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.telemetry import get_logger as jget_logger  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.convert import key_from_numpy  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.telemetry import get_logger  # noqa: E402

STEPS = 12
MODES = ("train", "train_dynamic", "train_periodic")


def _events(logger, run):
    got = []
    handler = logger.add_handler(got.append)
    try:
        run()
    finally:
        logger.remove_handler(handler)
    return got


def _reference(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    return _events(jget_logger(), jtrain.main)


@pytest.mark.parametrize("mode", MODES)
def test_launcher_events_match_reference(mode, monkeypatch, capsys):
    check_launcher("llama3-8b", mode, monkeypatch, capsys)


def check_launcher(arch, mode, monkeypatch, capsys, steps=STEPS):
    """Both launchers' ``--smoke --mode mode`` runs of ``arch`` for
    ``steps`` steps: the same events, keys, steps, ``mode`` and ``arch``,
    finite falling losses."""
    argv = ["--arch", arch, "--smoke", "--mode", mode,
            "--steps", str(steps)]
    want = _reference(argv, monkeypatch)
    got = _events(get_logger(),
                  lambda: train.main(argv + ["--device", "cpu"]))
    assert [e["kind"] for e in got] == [e["kind"] for e in want] == \
        ["train_step"] * steps + ["train_done"]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
    assert [e["step"] for e in got[:-1]] == list(range(1, steps + 1))
    for key in ("steps", "mode", "arch"):
        assert got[-1][key] == want[-1][key]
    for events in (got, want):
        losses = [e["loss"] for e in events[:-1]]
        assert all(math.isfinite(x) for x in losses)
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
        if mode != "train":
            assert all(e["synced"] in (0, 1) for e in events[:-1])
    # the console handler printed the same events
    assert capsys.readouterr().out.count("train_step") == 2 * steps


@pytest.mark.parametrize("arch", ["llama3-8b", "internvl2-76b",
                                  "musicgen-large"])
def test_make_batch_matches_reference(arch):
    jcfg, cfg = jget_arch(arch, smoke=True), get_arch(arch, smoke=True)
    key = jax.random.PRNGKey(5)
    want = jax.tree.map(np.asarray, jtrain.make_batch(
        jcfg, key, 4, 16, JTokenStream(seed=0, vocab=jcfg.vocab_size)))
    got = train.make_batch(cfg, key_from_numpy(key, "cpu"), 4, 16,
                           TokenStream(seed=0, vocab=cfg.vocab_size,
                                       device="cpu"), "cpu")
    assert sorted(got) == sorted(want)
    for k in ("tokens", "labels"):
        assert np.array_equal(got[k].numpy(), want[k])
    if "prefix_embeds" in want:
        w = want["prefix_embeds"]
        assert np.all(np.abs(got["prefix_embeds"].numpy() - w)
                      <= 0.02 * prng.NORMAL_TOL * np.maximum(
                          1.0, np.abs(w) / 0.02))
