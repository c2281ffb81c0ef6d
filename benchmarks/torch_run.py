"""The port's figure benchmarks: one per paper figure, as
``benchmarks/run.py`` registers them for the reference.

    python -m benchmarks.torch_run [--full] [--only NAME] [--list]
                                   [--device cuda|cpu]

Prints one CSV block per benchmark plus a summary ``name,seconds,
claim_check`` and writes each benchmark's rows as JSON under
experiments/bench_torch/. ``--list`` names the registered benchmarks and
their paper references without running anything (no card needed).
``--full`` runs the reference's full settings; the default is its quick
ones. ``--device`` is ``cuda`` unless the caller asks for the CPU. The
other reference benchmarks of ``benchmarks/run.py`` (the amortized
dynamic protocol, the scan loop, the network, hierarchy, async, robust,
shard, sync and kernel benchmarks, and the roofline table) have no twin
yet.
"""
from __future__ import annotations

import argparse
import sys
import time

from benchmarks import (
    torch_fig5_1_dynamic_vs_periodic,
    torch_fig5_2_fedavg,
    torch_fig5_4_drift,
    torch_fig5_5_deepdrive,
    torch_fig6_1_scaleout,
    torch_fig6_2_init_heterogeneity,
    torch_figA6_optimizers,
    torch_figC_unbalanced,
)

ALL = [
    torch_fig5_1_dynamic_vs_periodic,
    torch_fig5_2_fedavg,
    torch_fig5_4_drift,
    torch_fig5_5_deepdrive,
    torch_fig6_1_scaleout,
    torch_fig6_2_init_heterogeneity,
    torch_figA6_optimizers,
    torch_figC_unbalanced,
]


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
    args = ap.parse_args()

    if args.list:
        for mod in ALL:
            print(f"{mod.NAME}\t{mod.PAPER_REF}")
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
