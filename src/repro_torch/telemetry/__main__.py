"""The observatory CLI: ``python -m repro_torch.telemetry <cmd>`` — the
counterpart of ``python -m repro.telemetry``; both read either package's
streams.

    record     run the drift-MLP smoke task with telemetry attached and
               write the JSONL stream (a self-contained way to produce a
               stream to analyze; benchmarks attach telemetry to their
               own runs via ``benchmarks/run.py --telemetry``)
    summarize  the run card as JSON — totals, comm-vs-loss frontier,
               sync efficiency, per-link-class bytes
    frontier   just the [round, cum_bytes, cum_loss] frontier as JSON
    tail       the newest records, one JSON object per line
               (``--follow`` keeps watching the file)
    prom       Prometheus text exposition of counters/gauges
    costs      per-stage FLOPs × this stream's observed fires
               (``repro_torch.telemetry.costs``)

``record`` runs on ``--device`` (the card unless asked for the CPU).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_record(args) -> int:
    from repro_torch.config import (
        ProtocolConfig, TelemetryConfig, TrainConfig, get_arch,
    )
    from repro_torch.data.synthetic import GraphicalModelStream
    from repro_torch.models.cnn import cnn_loss, init_cnn_params
    from repro_torch.train.loop import run_protocol_training

    cfg = get_arch("drift_mlp", smoke=True)
    proto = ProtocolConfig(kind=args.kind, b=args.b, delta=args.delta)
    telem = TelemetryConfig(path=args.out, per_link=args.per_link,
                            profile=args.profile)
    dl, _ = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b),
        lambda g: init_cnn_params(cfg, g),
        GraphicalModelStream(seed=0, drift_prob=0.0, device=args.device),
        m=args.m, rounds=args.rounds, protocol=proto,
        train=TrainConfig(optimizer="sgd", learning_rate=0.05),
        batch=10, seed=args.seed, record_every=max(1, args.rounds // 10),
        chunk_size=args.chunk, telemetry=telem, device=args.device)
    dl.recorder.close()
    print(f"recorded {dl.rounds} rounds ({args.kind}, m={args.m}) "
          f"-> {args.out}")
    print(f"  cum_loss={dl.cumulative_loss:.4f} "
          f"syncs={dl.comm_totals['syncs']} bytes={dl.comm_bytes()}")
    return 0


def _cmd_summarize(args) -> int:
    from repro_torch.telemetry.observatory import load_run, summarize
    print(json.dumps(summarize(load_run(args.path), points=args.points),
                     indent=1, sort_keys=True))
    return 0


def _cmd_frontier(args) -> int:
    from repro_torch.telemetry.observatory import frontier, load_run
    print(json.dumps(frontier(load_run(args.path))))
    return 0


def _cmd_tail(args) -> int:
    from repro_torch.telemetry.observatory import iter_records, tail_records
    for rec in tail_records(args.path, args.n):
        print(json.dumps(rec, sort_keys=True))
    if not args.follow:
        return 0
    seen = sum(1 for _ in iter_records(args.path))
    try:
        while True:
            time.sleep(args.interval)
            recs = list(iter_records(args.path))
            for rec in recs[seen:]:
                print(json.dumps(rec, sort_keys=True), flush=True)
            seen = len(recs)
    except KeyboardInterrupt:
        return 0


def _cmd_prom(args) -> int:
    from repro_torch.telemetry.observatory import load_run, prom_text
    sys.stdout.write(prom_text(load_run(args.path)))
    return 0


def _cmd_costs(args) -> int:
    from repro_torch.core.sync.spec import ProtocolSpec
    from repro_torch.telemetry.costs import attribute, round_costs
    from repro_torch.telemetry.observatory import load_run

    run = load_run(args.path)
    spec_dict = run.meta.get("spec")
    if spec_dict is None:
        print("error: stream's meta record carries no spec",
              file=sys.stderr)
        return 2
    spec = ProtocolSpec.from_dict(spec_dict)
    template = None
    if args.arch:
        import torch
        from repro_torch.config import get_arch
        from repro_torch.core.flatten import tree_map
        from repro_torch.models.cnn import init_cnn_params
        cfg = get_arch(args.arch, smoke=True)
        params = init_cnn_params(cfg, torch.Generator())
        template = tree_map(
            lambda x: torch.empty((run.meta["m"],) + tuple(x.shape),
                                  dtype=x.dtype, device="meta"), params)
    costs = round_costs(spec, template=template, m=run.meta["m"])
    last = run.rounds[-1] if run.rounds else None
    rounds = last["round"] if last else 0
    fires = last["cum_syncs"] if last else 0
    walls = [c["wall_s"] for c in run.chunks if "wall_s" in c]
    print(json.dumps(
        attribute(costs, rounds, fires,
                  wall_s=sum(walls) if walls else None),
        indent=1, sort_keys=True))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="fleet telemetry observatory")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("record", help="record a drift-MLP smoke run")
    rec.add_argument("--out", required=True, help="JSONL output path")
    rec.add_argument("--rounds", type=int, default=100)
    rec.add_argument("--m", type=int, default=8)
    rec.add_argument("--kind", default="dynamic")
    rec.add_argument("--b", type=int, default=2)
    rec.add_argument("--delta", type=float, default=0.5)
    rec.add_argument("--seed", type=int, default=0)
    rec.add_argument("--chunk", type=int, default=64)
    rec.add_argument("--per-link", action="store_true",
                     help="per-link bytes on every round record")
    rec.add_argument("--profile", action="store_true",
                     help="wall-clock + first-call spans per chunk")
    rec.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu")
    rec.set_defaults(fn=_cmd_record)

    summ = sub.add_parser("summarize", help="run card as JSON")
    summ.add_argument("path")
    summ.add_argument("--points", type=int, default=50,
                      help="downsampled curve length")
    summ.set_defaults(fn=_cmd_summarize)

    fro = sub.add_parser("frontier",
                         help="[round, cum_bytes, cum_loss] frontier")
    fro.add_argument("path")
    fro.set_defaults(fn=_cmd_frontier)

    tl = sub.add_parser("tail", help="newest records")
    tl.add_argument("path")
    tl.add_argument("-n", type=int, default=10)
    tl.add_argument("--follow", action="store_true",
                    help="keep watching the file")
    tl.add_argument("--interval", type=float, default=0.5)
    tl.set_defaults(fn=_cmd_tail)

    pr = sub.add_parser("prom", help="Prometheus text exposition")
    pr.add_argument("path")
    pr.set_defaults(fn=_cmd_prom)

    co = sub.add_parser("costs",
                        help="stage FLOPs x observed fires")
    co.add_argument("path")
    co.add_argument("--arch", default=None,
                    help="architecture template for absolute FLOPs "
                         "(e.g. drift_mlp)")
    co.set_defaults(fn=_cmd_costs)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # downstream pager/head closed the pipe mid-write — exit quietly
        # (devnull swap stops the interpreter-shutdown flush from raising)
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
