"""The row-sharded fleet plane against the flat plane — the twin of
``benchmarks/shard_bench.py`` on ``repro_torch``.

Sweeps the engine under ``layout="sharded"`` over 1, 2, 4 and 8 ranks,
each a process of one ``torch.distributed`` group spawned by
``repro_torch.core.shard.launch`` (one spawn a world, shared by that
world's cases; on the card gloo, NCCL for one rank), on two fleets:

* the drift MLP at m in {200, 2000} (quick), and 10000 (``--full``);
* the paper's 1,199,882-weight MNIST CNN at m = 200 only, on one rank
  (quick) or the whole sweep (``--full``).

Every sharded run is held to a ``layout="flat"`` run of the same
fixture in this process (the same seeds, chunk and number of
``run_chunk`` calls): comm counters and per-link transfers equal
(``counters_equal``). Each row reports rounds/sec (best of the timed
chunks after a warm-up chunk), the speedup over the one-rank run and, at
the largest world, the bytes a rank received a round by the shard
layer's own count (``core/shard.py::COLLECTIVE_BYTES``:
``collective_bytes_per_round``, ``collective_bytes_by_op``) beside the
ring all-reduce estimate ``2 (n - 1) / n * P * 4``. The reference's
measured HLO collectives have no twin.

Where the port differs: the reference forces 8 XLA host devices; here
the ranks are processes that time-share one card (or the CPU's cores),
so rounds/sec cannot scale with the world. The meta row's
``scaling_expected`` is true only with at least as many cards as the
largest world, and ``check`` then asks for a speedup; on one card it is
a correctness sweep.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmarks.torch_common import finish, save_rows
from repro_torch.config import ProtocolConfig, TrainConfig, get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import shard
from repro_torch.core.protocol import DecentralizedLearner
from repro_torch.data.pipeline import LearnerStreams
from repro_torch.data.synthetic import GraphicalModelStream, SyntheticMNIST
from repro_torch.device import resolve_device
from repro_torch.models.cnn import cnn_loss, init_cnn_params

NAME = "shard_bench"
PAPER_REF = "ISSUE 8 tentpole (device-sharded fleet plane)"

DEVICE_SWEEP = (1, 2, 4, 8)

ARCH = "drift_mlp"
# the cut rows that tests/test_torch_bench_cuts.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds,
# {"world": ranks}); the drift MLP, batch 10
CUT = ((dict(kind="dynamic", b=2, delta=0.3), 8, 24, dict(world=2)),)


def _source(arch, smoke, device):
    if arch == "mnist_cnn":
        return SyntheticMNIST(seed=0, image_size=14 if smoke else 28,
                              device=device)
    return GraphicalModelStream(seed=0, drift_prob=0.0, device=device)


def default_source(device="cuda"):
    return _source(ARCH, True, device)


def _learner(case, layout, device, init=None, proto=None):
    cfg = get_arch(case["arch"], smoke=case["smoke"])
    proto = dict(proto or dict(kind="dynamic", b=2, delta=0.5))
    init_fn = ((lambda g: init_cnn_params(cfg, g)) if init is None
               else (lambda g: params_from_numpy(init, device=device)))
    return DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b), init_fn, case["m"],
        ProtocolConfig(**proto, layout=layout),
        TrainConfig(optimizer="sgd", learning_rate=0.05), device=device)


def _chunk(case, device):
    streams = LearnerStreams(_source(case["arch"], case["smoke"], device),
                             case["m"], batch=case["batch"], seed=0)
    return streams.next_chunk(case["rounds"])



def _engine(case, layout, device):
    """A warm-up chunk, then the best of ``reps`` timed chunks: ``(row,
    comm, per-link transfers, bytes received by collective in the last
    timed chunk)``."""
    dl = _learner(case, layout, device)
    chunk = _chunk(case, dl.device)
    dl.run_chunk(chunk)
    best = float("inf")
    for _ in range(case["reps"]):
        shard.COLLECTIVE_BYTES.clear()
        finish(dl.device)
        t0 = time.perf_counter()
        dl.run_chunk(chunk)
        finish(dl.device)
        best = min(best, time.perf_counter() - t0)
    row = {"arch": case["arch"], "m": case["m"], "layout": layout,
           "devices": 1 if dl.fleet is None else dl.fleet.n_devices,
           "params": dl.model_size,
           "rounds_per_sec": round(case["rounds"] / best, 2)}
    return (row, dict(dl.comm_totals), dl.link_xfer_totals.copy(),
            dict(shard.COLLECTIVE_BYTES))


def _rank_cases(cases, device):
    """One rank's sharded runs of ``cases`` (run by ``shard.launch``)."""
    return [_engine(case, "sharded", device) for case in cases]


def _rank_cut(case, init, batches, device):
    dl = _learner(case, "sharded", device, init, case["proto"])
    dl.run_chunk({k: torch.from_numpy(v).to(dl.device)
                  for k, v in batches.items()})
    return dict(dl.comm_totals), dl.link_xfer_totals.copy()


def cut(case, device="cuda", source=None, init_fn=None):
    """One case of ``CUT``: the flat run in this process and the sharded
    run over ``world`` ranks from the same batches and initial model,
    ``(flat learner, {"sharded_comm", "sharded_xfers",
    "counters_equal"})``."""
    proto, m, rounds, kw = case
    dev = resolve_device(device)
    src = default_source(dev) if source is None else source
    batches = LearnerStreams(src, m, batch=10, seed=0).next_chunk(rounds)
    cfg = get_arch(ARCH, smoke=True)
    init = params_to_numpy(
        (init_fn or (lambda g: init_cnn_params(cfg, g)))(
            torch.Generator(device=dev).manual_seed(0)))
    spec = dict(arch=ARCH, smoke=True, m=m, proto=proto)
    flat = _learner(spec, "flat", dev, init, proto)
    flat.run_chunk(batches)
    ranks = shard.launch(_rank_cut, kw["world"], spec, init,
                         {k: v.cpu().numpy() for k, v in batches.items()},
                         dev.type, device=dev.type)
    comm, xfers = ranks[0]
    agree = all(r[0] == comm and np.array_equal(r[1], xfers)
                for r in ranks)
    return flat, {"sharded_comm": comm,
                  "sharded_xfers": [int(x) for x in xfers],
                  "ranks_agree": bool(agree),
                  "counters_equal": bool(
                      comm == flat.comm_totals
                      and np.array_equal(xfers, flat.link_xfer_totals))}


def _cases(quick: bool):
    """(case, worlds): the reference's sweep (m, rounds, batch, reps)."""
    mlp = dict(arch="drift_mlp", smoke=True, batch=10, reps=1)
    cases = [(dict(mlp, m=200, rounds=16), DEVICE_SWEEP),
             (dict(mlp, m=2000, rounds=4), DEVICE_SWEEP)]
    if not quick:
        cases.append((dict(mlp, m=10000, rounds=4), DEVICE_SWEEP))
    cases.append((dict(arch="mnist_cnn", smoke=False, m=200, rounds=2,
                       batch=2, reps=1), (1,) if quick else DEVICE_SWEEP))
    return cases


def run(quick: bool = True, device="cuda"):
    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    rows = [{
        "layout": "meta", "visible_devices": cards,
        "cores": os.cpu_count(),
        "scaling_expected": cards >= max(DEVICE_SWEEP),
        "note": ("the ranks are processes sharing this machine's "
                 f"{cards or 'no'} card(s) and its cores; rounds/sec "
                 "scales only with a card a rank"),
        "cnn_memory_bound": (
            "mnist_cnn swept at m=200 only: the (m, P) carry at m=2000 x "
            "1.2M weights is ~19 GB"),
        "cnn_ranks": ("quick mode runs mnist_cnn sharded on one rank; "
                      "--full sweeps 1/2/4/8"),
    }]
    cases = _cases(quick)
    by_world = {w: [c for c, ws in cases if w in ws and c["m"] % w == 0]
                for w in DEVICE_SWEEP}
    sharded = {}
    for w, todo in by_world.items():
        if not todo:
            continue
        got = shard.launch(_rank_cases, w, todo, dev.type,
                           device=dev.type)
        for i, case in enumerate(todo):
            mine = [g[i] for g in got]
            if any(r[1] != mine[0][1] or not np.array_equal(r[2],
                                                           mine[0][2])
                   for r in mine):
                raise RuntimeError(f"the ranks of world {w} disagree on "
                                   f"{case}")
            sharded[(id(case), w)] = mine[0]
    for case, ws in cases:
        base_row, base_comm, base_xf, _ = _engine(case, "flat", dev)
        rows.append(base_row)
        sweep = [w for w in ws if (id(case), w) in sharded]
        one_rank_rps = None
        for w in sweep:
            row, comm, xf, coll = sharded[(id(case), w)]
            row = dict(row, counters_equal=bool(
                comm == base_comm and np.array_equal(xf, base_xf)))
            if w == 1:
                one_rank_rps = row["rounds_per_sec"]
            if one_rank_rps:
                row["speedup_vs_1dev"] = round(
                    row["rounds_per_sec"] / one_rank_rps, 2)
            if w == max(sweep):
                row["ring_allreduce_bytes_per_dev"] = int(
                    2 * (w - 1) / w * row["params"] * 4)
                row["collective_bytes_by_op"] = coll
                row["collective_bytes_per_round"] = int(
                    sum(coll.values()) / case["rounds"])
            rows.append(row)
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    meta = rows[0]
    sharded = [r for r in rows if r.get("layout") == "sharded"]
    if not sharded or not all(r["counters_equal"] for r in sharded):
        return "MIXED"
    if not meta.get("scaling_expected", False):
        return "PASS"      # correctness sweep: no card a rank to scale on
    big = [r for r in sharded
           if r["m"] >= 2000 and r.get("speedup_vs_1dev")]
    ok = any(r["speedup_vs_1dev"] >= 1.2 for r in big)
    return "PASS" if ok else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
