"""One staged round of dynamic averaging on the fleet plane, by layout —
the twin of ``benchmarks/sync_bench.py`` on ``repro_torch``.

Times one round of the paper's hot loop — divergence monitoring over
every learner (``sqdist_rows``) plus the balancing augmentation — on
the paper's 1,199,882-weight MNIST CNN at m in (8, 64, 200), for
``layout="tree"`` and ``layout="flat"``, from identical state (each
timed call on a fresh copy of the plane, which the commit writes in
place).

The fleet balances at an exact count: v = m/8 violators sit a distance
sqrt(D0) along one shared unit direction (one (P,) draw of
``repro_torch.prng`` from key 1; the reference draws it leaf by leaf),
every other learner on the reference (the port's initial CNN, drawn
from ``torch.Generator().manual_seed(0)``), so the cohort balances at
exactly 4v = m/2 members (``||mean_B - r||^2 = D0 (v/|B|)^2``, and
``DELTA_HALF`` lies strictly between its values at |B| = 4v and 4v - 1).
A second flat round at a Delta that forces a full augmentation (8v = m
members) gives the marginal cost of one balancing step
(``per_iter_ms``, the largest m only).

Both layouts must give the same comm record and per-link transfers and
parameters within rtol 1e-4 / atol 1e-5. A short telemetry run (the
drift MLP, m = 8, dynamic b = 2 Delta = 0.5, 60 rounds quick, 400 full)
is streamed to experiments/bench_torch/sync_bench_telemetry.jsonl, its
run card to sync_bench_frontier.json, and its ``stream_exact`` holds the
stream's totals to the engine's counters.

Where the port differs: the reference's ``"tree"`` layout runs per-leaf
expressions, O(m^2 P) a round, and the claim is that ``"flat"`` is at
least 2x faster at m = 200. The port's ``"tree"`` runs on the same
plane as ``"flat"`` (``core/sync/spec.py``), so ``speedup`` is near 1
and the check, unchanged, says MIXED.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from benchmarks.torch_common import OUT_DIR, finish, save_rows
from repro_torch import prng
from repro_torch.config import (
    ProtocolConfig, TelemetryConfig, TrainConfig, get_arch,
)
from repro_torch.convert import params_to_numpy
from repro_torch.core.flatten import fleet_adapter
from repro_torch.core.sync import PROTOCOLS, init_state
from repro_torch.data.synthetic import GraphicalModelStream
from repro_torch.device import resolve_device
from repro_torch.models.cnn import cnn_loss, init_cnn_params
from repro_torch.telemetry.observatory import load_run, summarize
from repro_torch.train.loop import run_protocol_training

NAME = "sync_bench"
PAPER_REF = "ISSUE 5 tentpole (flat fleet-plane sync path)"

D0 = 16.0          # violators' squared distance to the reference
# the balanced distance at |B| = k is D0 * (v/k)^2: 1.0 at k = 4v, ~1.02
# at k = 4v - 1 (v = 25). DELTA_HALF sits strictly inside that open
# interval, so the loop stops at exactly 4v = m/2 members on both
# layouts whatever the float association
DELTA_HALF = 1.01
M_LIST = (8, 64, 200)

ARCH = "mnist_cnn"
SMOKE = False
# the cut rows that tests/test_torch_bench_cuts.py and chip_smoke.py's
# twins phase run through cut(): ({"delta"}, m, rounds = 1,
# {"layout"})
CUT = ((dict(delta=DELTA_HALF), 8, 1, dict(layout="flat")),)


class DirectionSource:
    """The violators' shared direction ``{"u": (1, P)}``, one normal draw
    of ``repro_torch.prng`` from ``key(seed)`` on the CPU."""

    def __init__(self, P: int, seed: int = 1, device="cuda"):
        self.P, self.seed, self.device = P, seed, resolve_device(device)

    def sample(self, generator, batch: int = 1, lead: tuple = ()):
        u = prng.normal(prng.key(self.seed, device="cpu"), (*lead, batch,
                                                            self.P),
                        device="cpu")
        return {"u": u.to(self.device)}

    def force_drift(self):
        pass


def _base(device):
    cfg = get_arch(ARCH, smoke=SMOKE)
    return init_cnn_params(cfg, torch.Generator(device=device).manual_seed(0))


def cut_init():
    """The cut rows' base model, as numpy (drawn on the CPU)."""
    return params_to_numpy(_base("cpu"))


def default_source(device="cuda"):
    return DirectionSource(fleet_adapter(_base("cpu")).P, device=device)


def _fleet(m: int, device, source=None, init_fn=None):
    """(X, ref, v): v = m/8 rows drifted sqrt(D0) along the unit
    direction, the rest on the reference row."""
    dev = resolve_device(device)
    base = init_fn(torch.Generator(device=dev)) if init_fn else _base(dev)
    adapter = fleet_adapter(base)
    ref = adapter.ravel_model(base).to(dev)
    src = default_source(dev) if source is None else source
    u = src.sample(None, 1)["u"][0].to(dev)
    u = u / torch.sqrt(torch.sum(u * u))
    v = max(1, m // 8)
    scale = torch.where(torch.arange(m, device=dev) < v,
                        torch.tensor(float(np.sqrt(D0)), device=dev),
                        torch.tensor(0.0, device=dev))
    return ref[None] + scale[:, None] * u[None], ref, v


def _round_fn(layout: str, delta: float):
    return PROTOCOLS["dynamic"].with_params(b=1, delta=delta,
                                            layout=layout).compile()



def _time(fn, X, state, reps: int) -> float:
    """Best-of-reps seconds for one round from fixed state, each on a
    fresh copy of the plane."""
    best = float("inf")
    for _ in range(reps):
        Xc = X.clone()
        finish(Xc.device)
        t0 = time.perf_counter()
        res = fn(Xc, state)
        finish(res.params.device)
        best = min(best, time.perf_counter() - t0)
    return best


def _rec(res) -> dict:
    return {k: int(getattr(res.rec, k)) for k in res.rec._fields}


def cut(case, device="cuda", source=None, init_fn=None):
    """One case of ``CUT``: one round at ``layout`` on the m-learner
    fleet, ``(None, {"rec": the comm record, "xfers": the per-link
    transfers, "cohort": ..., "params": the committed plane})``."""
    kw, m, _, extra = case
    X, ref, v = _fleet(m, device, source, init_fn)
    res = _round_fn(extra["layout"], kw["delta"])(X, init_state(ref, 0))
    return None, {"rec": _rec(res),
                  "xfers": [int(x) for x in np.asarray(res.xfers)],
                  "cohort": int(res.rec.model_up), "violators": v,
                  "params": res.params}


def run(quick: bool = True, device="cuda"):
    # the m sweep is the point (the claim lives at m = 200), so quick
    # mode keeps M_LIST and trims repetitions instead
    rows = []
    for m in M_LIST:
        X, ref, v = _fleet(m, device)
        state = init_state(ref, 0)
        reps_tree = (2 if quick else 3) if m <= 8 else 1
        reps_flat = 2 if quick else 4
        results = {}
        for layout in ("tree", "flat"):
            fn = _round_fn(layout, DELTA_HALF)
            results[layout] = fn(X.clone(), state)      # warm up
            dt = _time(fn, X, state,
                       reps_tree if layout == "tree" else reps_flat)
            rows.append({
                "m": m, "layout": layout, "params": int(ref.numel()),
                "round_ms": round(dt * 1e3, 2),
                "cohort": int(results[layout].rec.model_up),
                "violators": v,
            })
        t_row, f_row = rows[-2], rows[-1]
        tr, fr = results["tree"], results["flat"]
        f_row["speedup"] = round(t_row["round_ms"] / f_row["round_ms"], 2)
        f_row["counters_equal"] = bool(
            _rec(tr) == _rec(fr)
            and np.array_equal(np.asarray(tr.xfers), np.asarray(fr.xfers)))
        f_row["params_close"] = bool(torch.allclose(
            tr.params, fr.params, rtol=1e-4, atol=1e-5))
        del results, tr, fr

        # the per-iteration probe (flat, largest m only): a Delta low
        # enough to force a FULL augmentation adds exactly m - 4v loop
        # iterations over the half-fleet round; the time difference per
        # extra iteration is the marginal cost of one balancing step
        if m == max(M_LIST):
            delta_full = D0 * (v / m) ** 2 * 0.9
            fn_full = _round_fn("flat", float(delta_full))
            res = fn_full(X.clone(), state)
            if int(res.rec.full_syncs) != 1:
                raise RuntimeError("the per-iteration probe did not "
                                   "augment the whole fleet")
            dt_full = _time(fn_full, X, state, reps_flat)
            extra_iters = (m - v) - 3 * v
            f_row["per_iter_ms"] = round(
                (dt_full - f_row["round_ms"] / 1e3)
                / max(1, extra_iters) * 1e3, 3)
            del res
        del X, ref
    rows.append(_telemetry_run(quick, device))
    save_rows(NAME, rows)
    return rows


def _telemetry_run(quick: bool, device) -> dict:
    """A short streamed protocol run summarized from the JSONL alone:
    one ``layout="telemetry"`` row whose ``stream_exact`` holds the
    stream's totals to the engine's counters."""
    os.makedirs(OUT_DIR, exist_ok=True)
    jsonl = os.path.normpath(
        os.path.join(OUT_DIR, "sync_bench_telemetry.jsonl"))
    card = os.path.normpath(
        os.path.join(OUT_DIR, "sync_bench_frontier.json"))
    m, rounds = 8, (60 if quick else 400)
    cfg = get_arch("drift_mlp", smoke=True)
    dl, _ = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b), lambda g: init_cnn_params(cfg, g),
        GraphicalModelStream(seed=0, drift_prob=0.0, device=device),
        m=m, rounds=rounds,
        protocol=ProtocolConfig(kind="dynamic", b=2, delta=0.5),
        train=TrainConfig(optimizer="sgd", learning_rate=0.05),
        batch=10, seed=0, record_every=max(1, rounds // 10),
        telemetry=TelemetryConfig(path=jsonl, per_link=True, profile=True),
        device=device)
    dl.recorder.close()
    run_card = summarize(load_run(jsonl))
    with open(card, "w") as f:
        json.dump(run_card, f, indent=1, sort_keys=True)
    return {
        "m": m, "layout": "telemetry", "rounds": rounds,
        "cum_bytes": run_card["cum_bytes"],
        "cum_syncs": run_card["cum_syncs"],
        "stream_exact": bool(
            run_card["cum_bytes"] == dl.comm_bytes()
            and run_card["cum_syncs"] == dl.comm_totals["syncs"]
            and run_card["cum_loss"] == dl.cumulative_loss),
        "jsonl": jsonl, "card": card,
    }


def check(rows) -> str:
    flat = {r["m"]: r for r in rows if r["layout"] == "flat"}
    big = flat[max(flat)]
    ok = (big["speedup"] >= 2.0
          and all(r["counters_equal"] and r["params_close"]
                  for r in flat.values())
          # the marginal balancing step must cost less than 1/m of the
          # round's fixed O(m P) work, and come out positive (a negative
          # difference means noise swamped the signal)
          and 0.0 < big["per_iter_ms"] <= big["round_ms"] / big["m"])
    return "PASS" if ok else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
