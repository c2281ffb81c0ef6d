"""The port's benchmarks, one per reference benchmark, as
``benchmarks/run.py`` registers them for the reference.

    python -m benchmarks.torch_run [--full] [--only NAME] [--list]
                                   [--device cuda|cpu]
    python -m benchmarks.torch_run --protocol spec.json [--telemetry out.jsonl]

Prints one CSV block per benchmark plus a summary ``name,seconds,
claim_check`` and writes each benchmark's rows as JSON under
experiments/bench_torch/. ``--list`` names the registered benchmarks and
their paper references without running anything (no card needed).
``--full`` runs the reference's full settings; the default is its quick
ones. ``--device`` is ``cuda`` unless the caller asks for the CPU.
``ALL`` is the reference's registry in its order, twin for twin, the
last ``roofline_table``, which tabulates the port's dry-run records
(``python -m repro_torch.launch.dryrun``, ``experiments/torch_dryrun/``);
``FIGURES`` are the eight figure twins among them.

``--protocol`` runs a serialized ``ProtocolSpec`` (the JSON that the
reference's ``ProtocolSpec.to_json`` writes, or the port's) through the
engine on the drift-MLP task and reports loss and communication;
``--telemetry`` streams that run's per-round records to a JSONL file
(``repro_torch.telemetry``) and needs ``--protocol``.
"""
from __future__ import annotations

import argparse
import re
import sys
import time

from benchmarks import (
    torch_async_bench,
    torch_dynamic_amortized,
    torch_fig5_1_dynamic_vs_periodic,
    torch_fig5_2_fedavg,
    torch_fig5_4_drift,
    torch_fig5_5_deepdrive,
    torch_fig6_1_scaleout,
    torch_fig6_2_init_heterogeneity,
    torch_figA6_optimizers,
    torch_figC_unbalanced,
    torch_fig_hierarchy,
    torch_fig_network_regimes,
    torch_kernel_bench,
    torch_robust_bench,
    torch_roofline_table,
    torch_scan_driver,
    torch_shard_bench,
    torch_sync_bench,
)

ALL = [
    torch_scan_driver,
    torch_fig5_1_dynamic_vs_periodic,
    torch_dynamic_amortized,
    torch_fig5_2_fedavg,
    torch_fig5_4_drift,
    torch_fig5_5_deepdrive,
    torch_fig6_1_scaleout,
    torch_fig6_2_init_heterogeneity,
    torch_figA6_optimizers,
    torch_figC_unbalanced,
    torch_fig_network_regimes,
    torch_fig_hierarchy,
    torch_sync_bench,
    torch_shard_bench,
    torch_async_bench,
    torch_robust_bench,
    torch_kernel_bench,
    torch_roofline_table,
]
FIGURES = [
    torch_fig5_1_dynamic_vs_periodic,
    torch_fig5_2_fedavg,
    torch_fig5_4_drift,
    torch_fig5_5_deepdrive,
    torch_fig6_1_scaleout,
    torch_fig6_2_init_heterogeneity,
    torch_figA6_optimizers,
    torch_figC_unbalanced,
]


def run_protocol_spec(path: str, full: bool = False, m: int = 8,
                      seed: int = 0, telemetry: str = None,
                      device="cuda", source=None, init_fn=None) -> dict:
    """Drive one serialized ``ProtocolSpec`` through the engine (the
    drift-MLP smoke task on ``GraphicalModelStream(seed=0)`` or
    ``source``, from ``init_fn`` or the port's own draw; sgd lr 0.05,
    batch 10, 200 rounds or 2,000 with ``full``) and report loss and
    communication. ``telemetry`` streams the run's per-round records to
    that JSONL path."""
    from repro_torch.config import TelemetryConfig, TrainConfig, get_arch
    from repro_torch.core.sync.spec import ProtocolSpec
    from repro_torch.data.synthetic import GraphicalModelStream
    from repro_torch.models.cnn import cnn_loss, init_cnn_params
    from repro_torch.train.loop import run_protocol_training

    with open(path) as f:
        spec = ProtocolSpec.from_json(f.read())
    rounds = 2000 if full else 200
    cfg = get_arch("drift_mlp", smoke=True)
    telem = (TelemetryConfig(path=telemetry, per_link=True, profile=True)
             if telemetry else None)
    dl, traj = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b),
        init_fn or (lambda g: init_cnn_params(cfg, g)),
        GraphicalModelStream(seed=0, drift_prob=0.0, device=device)
        if source is None else source,
        m=m, rounds=rounds, protocol=spec,
        train=TrainConfig(optimizer="sgd", learning_rate=0.05),
        batch=10, seed=seed, record_every=max(1, rounds // 10),
        telemetry=telem, device=device)
    if dl.recorder is not None:
        dl.recorder.close()
    return {
        "spec": spec.to_dict(),
        "m": m,
        "rounds": rounds,
        "cumulative_loss": dl.cumulative_loss,
        "mean_round_loss": dl.cumulative_loss / (rounds * m),
        "syncs": dl.comm_totals["syncs"],
        "full_syncs": dl.comm_totals["full_syncs"],
        "model_up": dl.comm_totals["model_up"],
        "messages": dl.comm_totals["messages"],
        "comm_bytes": dl.comm_bytes(),
        "loss_curve": traj.cumulative_loss,
        "bytes_curve": traj.cumulative_bytes,
    }


def run_one(mod, quick: bool, device: str):
    """``(verdict, rows, seconds)`` of one benchmark; an exception is the
    verdict ``ERROR:...``."""
    t0 = time.perf_counter()
    rows = []
    try:
        rows = mod.run(quick=quick, device=device)
        verdict = mod.check(rows)
    except Exception as e:  # noqa: BLE001
        import traceback
        traceback.print_exc()
        verdict = f"ERROR:{e!r}"
    return verdict, rows, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the reference's full settings (slow)")
    ap.add_argument("--only", default=None)
    ap.add_argument("--list", action="store_true",
                    help="name the registered benchmarks and exit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--protocol", default=None, metavar="SPEC_JSON",
                    help="run a serialized ProtocolSpec through the engine "
                         "and report loss/comm")
    ap.add_argument("--telemetry", default=None, metavar="JSONL",
                    help="with --protocol: stream per-round telemetry "
                         "records to this JSONL file")
    args = ap.parse_args()

    if args.telemetry and not args.protocol:
        ap.error("--telemetry requires --protocol (it instruments the "
                 "spec run)")

    if args.list:
        for mod in ALL:
            print(f"{mod.NAME}\t{mod.PAPER_REF}")
        return

    if args.protocol:
        from benchmarks.torch_common import save_rows
        t0 = time.perf_counter()
        row = run_protocol_spec(args.protocol, full=args.full,
                                telemetry=args.telemetry, device=args.device)
        name = re.sub(r"[^\w.-]", "_", row["spec"]["name"]) or "custom"
        print(f"=== protocol_spec  [{args.protocol}] ===")
        for k, v in row.items():
            if not isinstance(v, (list, dict)):
                print(f"  {k}={v}")
        path = save_rows(f"protocol_spec_{name}", [row])
        if args.telemetry:
            print(f"  -> telemetry {args.telemetry}")
        print(f"  -> saved {path} ({time.perf_counter() - t0:.1f}s)")
        return

    summary = []
    for mod in ALL:
        if args.only and args.only not in mod.NAME:
            continue
        print(f"\n=== {mod.NAME}  [{mod.PAPER_REF}] ===", flush=True)
        verdict, rows, dt = run_one(mod, not args.full, args.device)
        for r in rows:
            print("  " + ",".join(f"{k}={v}" for k, v in r.items()
                                  if not isinstance(v, (list, dict))))
        print(f"  -> {verdict} ({dt:.1f}s)")
        summary.append((mod.NAME, dt, verdict))

    print("\n==== SUMMARY (name,seconds,claim_check) ====")
    ok = True
    for name, dt, verdict in summary:
        print(f"{name},{dt:.1f},{verdict}")
        ok &= not str(verdict).startswith("ERROR")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
