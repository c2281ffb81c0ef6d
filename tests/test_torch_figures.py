"""The port's figure benchmarks (``benchmarks/torch_fig*.py``) against
the reference's (``benchmarks/fig*.py``) on the CPU.

* Each twin has the reference module's ``NAME`` and ``PAPER_REF``.
* Each twin's ``check`` gives the reference's verdict on the same rows:
  rows built to pass each claim and rows built to fail it.
* Per figure, each case of the twin's ``CUT`` (one or two protocols at
  a cut setting) goes through the twin's ``cut`` on the reference's own
  batches (``ReplaySource``) from the reference's initial model, against
  the reference's helper: syncs and communication exact, losses within
  rtol 1e-4 (the port sums a chunk's f32 losses in another order than
  XLA).
* A cut row recorded from the twin's own source (``RecordSource``) and
  replayed is the same run, as ``chip_smoke.py`` replays it on the card.
* ``python -m benchmarks.torch_run --list`` runs without a card.

No whole quick grid runs here; ``chip_smoke.py``'s ``twins`` phase
runs the eight quick grids on the card.
"""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import torch_common  # noqa: E402
from benchmarks import torch_run  # noqa: E402
from benchmarks.torch_common import ReplaySource  # noqa: E402
from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.protocol import DecentralizedLearner as JLearner  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.data.synthetic import DeepDriveStream as JDeepDrive  # noqa: E402
from repro.data.synthetic import GraphicalModelStream as JGraphical  # noqa: E402
from repro.data.synthetic import SyntheticMNIST as JMNIST  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro.train.loop import run_protocol_training as jtrain  # noqa: E402
from repro_torch.config import ProtocolConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-4)
TWINS = {mod.NAME: mod for mod in torch_run.FIGURES}
REFERENCE = {
    "fig5_1_dynamic_vs_periodic": "fig5_1_dynamic_vs_periodic",
    "fig5_2_fedavg": "fig5_2_fedavg",
    "fig5_4_drift": "fig5_4_drift",
    "fig5_5_deepdrive": "fig5_5_deepdrive",
    "fig6_1_scaleout": "fig6_1_scaleout",
    "fig6_2_init_heterogeneity": "fig6_2_init_heterogeneity",
    "figA6_optimizers": "figA6_optimizers",
    "figC_unbalanced": "figC_unbalanced",
}


def _ref(name):
    return importlib.import_module(f"benchmarks.{REFERENCE[name]}")


def test_eight_twins_in_the_reference_order():
    assert list(TWINS) == list(REFERENCE)


@pytest.mark.parametrize("name", list(REFERENCE))
def test_twin_names_the_reference_figure(name):
    twin, ref = TWINS[name], _ref(name)
    assert (twin.NAME, twin.PAPER_REF) == (ref.NAME, ref.PAPER_REF)
    assert twin.__name__ == f"benchmarks.torch_{REFERENCE[name]}"


# ---------------------------------------------------------------------------
# the claims: the same verdicts on the same rows
# ---------------------------------------------------------------------------

def _pl(protocol, loss, comm, **kw):
    return {"protocol": protocol, "cumulative_loss": loss,
            "comm_bytes": comm, **kw}


def _rows(name, passing):
    """Rows built to pass (``passing``) or to fail the figure's claim."""
    if name == "fig5_1_dynamic_vs_periodic":
        return [_pl("nosync", 300.0, 0), _pl("periodic_b10", 100.0, 1000),
                _pl("periodic_b40", 120.0, 400),
                _pl("dynamic_d0.3", 105.0, 600),
                _pl("dynamic_d2.5", 130.0, 300 if passing else 500),
                _pl("serial", 90.0, 0)]
    if name == "fig5_2_fedavg":
        return [_pl("periodic_b", 100.0, 2000), _pl("fedavg_C0.3", 110.0, 900),
                _pl("fedavg_C0.7", 105.0, 1500),
                _pl("dynamic_d0.4", 104.0, 1200),
                _pl("dynamic_d1.6", 120.0 if passing else 130.0, 800)]
    if name == "fig5_4_drift":
        dyn = dict(syncs_post_drift_window=9,
                   syncs_pre_drift_window=4 if passing else 10)
        return [_pl("periodic_b10", 50.0, 1000, syncs_post_drift_window=4,
                    syncs_pre_drift_window=4),
                _pl("dynamic_d0.3", 55.0, 400, **dyn)]
    if name == "fig5_5_deepdrive":
        return [{"protocol": p, "custom_loss_Ldd": ldd, "comm_bytes": c}
                for p, ldd, c in [("periodic_b10", 0.30, 1000),
                                  ("periodic_b40", 0.50, 300),
                                  ("dynamic_d0.1", 0.35 if passing else 0.45,
                                   500),
                                  ("dynamic_d0.3", 0.60, 200),
                                  ("nosync", 0.90, 0)]]
    if name == "fig6_1_scaleout":
        return [{"m": m, "protocol": p, "comm_bytes": c}
                for m in (4, 8, 16)
                for p, c in [("periodic_b10", 1000),
                             ("dynamic_d0.7", 800 if passing or m != 8
                              else 1200)]]
    if name == "fig6_2_init_heterogeneity":
        rows = []
        for eps in (0.0, 2.0, 10.0):
            for b in (1, 10, 40):
                for kind in ("periodic", "dynamic"):
                    rel = 1.0
                    if eps == 2.0 and b == 1:
                        rel = 0.9 if passing else 0.75
                    if eps == 10.0 and b == 40:
                        rel = 0.4
                    rows.append({"eps": eps, "b": b, "protocol": kind,
                                 "relative_accuracy": rel})
        return rows
    if name == "figA6_optimizers":
        return [{"optimizer": o, "protocol": p, "comm_bytes": c}
                for o in ("sgd", "adam", "rmsprop")
                for p, c in [("periodic_b10", 1000),
                             ("dynamic_d0.7", 900 if passing or o != "adam"
                              else 1100)]]
    return [{"variant": "weighted_alg2", "cumulative_loss": 10.0},
            {"variant": "unweighted",
             "cumulative_loss": 12.0 if passing else float("nan")}]


@pytest.mark.parametrize("passing", [True, False])
@pytest.mark.parametrize("name", list(REFERENCE))
def test_check_gives_the_reference_verdict(name, passing):
    rows = _rows(name, passing)
    want = _ref(name).check([dict(r) for r in rows])
    assert want == ("PASS" if passing else "MIXED")
    assert TWINS[name].check([dict(r) for r in rows]) == want


# ---------------------------------------------------------------------------
# a cut setting of each figure through the twins' helpers
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(arch, seed=0):
    """The reference's initial model of ``seed``: the first of
    ``split(PRNGKey(seed), 3)``, as numpy."""
    cfg = jget_arch(arch, smoke=True)
    return _np(jinit(cfg, jax.random.split(jax.random.PRNGKey(seed), 3)[0]))


def _init_fn(init):
    return lambda g: params_from_numpy(init, device="cpu")


def _replay_mnist(m, rounds, seed=0):
    streams = JStreams(JMNIST(seed=0, image_size=14), m, batch=10, seed=seed)
    return ReplaySource([_np(streams.next_chunk(rounds))])


def _assert_same(dl, jdl):
    assert dl.comm_totals == {k: int(v) for k, v in jdl.comm_totals.items()}
    assert dl.comm_bytes() == jdl.comm_bytes()
    np.testing.assert_allclose(dl.cumulative_loss, jdl.cumulative_loss,
                               **LOSS_TOL)


MNIST_FIGURES = ("fig5_1_dynamic_vs_periodic", "fig5_2_fedavg",
                 "fig6_1_scaleout", "fig6_2_init_heterogeneity",
                 "figA6_optimizers")


@pytest.mark.parametrize("name", MNIST_FIGURES)
def test_mnist_figure_rows_match_reference(name):
    twin = TWINS[name]
    assert twin.cut is torch_common.mnist_cut and twin.ARCH == "mnist_cnn"
    assert twin.run_mnist_protocol is torch_common.run_mnist_protocol
    for case in twin.CUT:
        kw, m, rounds, extra = case
        jdl, _, _ = jcommon.run_mnist_protocol(JProtocolConfig(**kw), m=m,
                                               rounds=rounds, **extra)
        src = _replay_mnist(m, rounds)
        dl, got = twin.cut(case, "cpu", src, _init_fn(_init(twin.ARCH)))
        assert src.remaining == 0 and 0.0 <= got["accuracy"] <= 1.0
        _assert_same(dl, jdl)
        if kw["kind"] == "dynamic" and "optimizer" not in extra:
            assert 0 < jdl.comm_totals["syncs"]     # the trigger fired


def test_drift_figure_rows_match_reference():
    twin, ref = TWINS["fig5_4_drift"], _ref("fig5_4_drift")
    for case in twin.CUT:
        kw, m, rounds, extra = case
        drifts = sorted(extra["drift_rounds"])
        jsrc = JGraphical(seed=1, drift_prob=0.0)
        streams = JStreams(jsrc, m, batch=10, seed=0)
        chunks = []
        for start, end in zip([0] + drifts, drifts + [rounds]):
            if start:
                jsrc.force_drift()
            chunks.append(_np(streams.next_chunk(end - start)))
        jdl, jsyncs, jlosses = ref._run_one(JProtocolConfig(**kw), m, rounds,
                                            set(drifts))
        src = ReplaySource(chunks)
        dl, got = twin.cut(case, "cpu", src, _init_fn(_init(twin.ARCH)))
        assert src.remaining == 0
        np.testing.assert_array_equal(got["syncs"], jsyncs)
        np.testing.assert_allclose(got["losses"], jlosses, **LOSS_TOL)
        _assert_same(dl, jdl)


def test_deepdrive_figure_rows_match_reference():
    twin = TWINS["fig5_5_deepdrive"]
    cfg = jget_arch(twin.ARCH, smoke=True)
    for case in twin.CUT:
        kw, m, rounds, _ = case
        jsrc = JDeepDrive(seed=3, height=cfg.input_shape[0],
                          width=cfg.input_shape[1])
        batches = _np(JStreams(jsrc, m, batch=10, seed=0).next_chunk(rounds))
        jdl, _ = jtrain(lambda p, b: jcnn_loss(cfg, p, b),
                        lambda k: jinit(cfg, k), jsrc, m=m, rounds=rounds,
                        protocol=JProtocolConfig(**kw),
                        train=JTrainConfig(optimizer="sgd",
                                           learning_rate=0.05),
                        batch=10, seed=0)
        dl, _ = twin.cut(case, "cpu", ReplaySource([batches]),
                         _init_fn(_init(twin.ARCH)))
        _assert_same(dl, jdl)


def test_unbalanced_figure_rows_match_reference():
    twin = TWINS["figC_unbalanced"]
    sizes = twin.SIZES
    cfg = jget_arch(twin.ARCH, smoke=True)
    assert [case[0]["weighted"] for case in twin.CUT] == [True, False]
    for case in twin.CUT:
        kw, m, rounds, _ = case
        assert m == len(sizes)
        jsrc = JGraphical(seed=2, drift_prob=0.0)
        streams = JStreams(jsrc, m, batch=10, seed=0, batch_sizes=sizes)
        padded = _np(streams.next_chunk(rounds))
        jdl = JLearner(
            lambda p, b: jcnn_loss(cfg, p, b), lambda k: jinit(cfg, k), m,
            JProtocolConfig(**kw),
            JTrainConfig(optimizer="sgd", learning_rate=0.05),
            sample_weights=streams.weights if kw["weighted"] else None)
        jdl.run_chunk(padded)
        # the port's streams ask for each learner's B^i samples, in order
        src = ReplaySource([{k: v[:, i, :bi] for k, v in padded.items()}
                            for i, bi in enumerate(sizes)])
        dl, _ = twin.cut(case, "cpu", src, _init_fn(_init(twin.ARCH)))
        assert src.remaining == 0
        _assert_same(dl, jdl)


@pytest.mark.parametrize("name", list(REFERENCE))
def test_recorded_cut_row_replays_the_same_run(name):
    twin = TWINS[name]
    init = _init_fn(_init(twin.ARCH))
    rec = torch_common.RecordSource(twin.default_source("cpu"))
    dl, got = twin.cut(twin.CUT[0], "cpu", rec, init)
    src = ReplaySource(rec.batches)
    again, got_again = twin.cut(twin.CUT[0], "cpu", src, init)
    assert rec.batches and src.remaining == 0
    assert again.comm_totals == dl.comm_totals
    assert (again.per_link_bytes() == dl.per_link_bytes()).all()
    assert again.cumulative_loss == dl.cumulative_loss
    for k, v in got.items():
        np.testing.assert_array_equal(got_again[k], v)


def test_torch_run_lists_without_a_card():
    """Every registered twin (the figures among the reference's other
    benchmarks, ``tests/test_torch_bench_twins.py``), in the reference's
    order, with its paper reference."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "benchmarks.torch_run",
                        "--list"], capture_output=True, text=True, env=env,
                       timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln.split("\t") for ln in r.stdout.strip().splitlines()]
    assert [ln[0] for ln in lines] == [m.NAME for m in torch_run.ALL]
    assert [ln[0] for ln in lines if ln[0] in TWINS] == list(REFERENCE)
    assert all(ln[1] == m.PAPER_REF for ln, m in zip(lines, torch_run.ALL))
