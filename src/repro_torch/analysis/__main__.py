"""``python -m repro_torch.analysis`` — the analysis gate, the
counterpart of ``python -m repro.analysis``.

    python -m repro_torch.analysis --check-all        # contracts + audit + lint
    python -m repro_torch.analysis --contracts        # stage contracts
    python -m repro_torch.analysis --audit            # round audit, all presets
    python -m repro_torch.analysis --lint [paths...]  # AST lint

Exit status 0 = clean, 1 = findings (printed one per line), 2 = no
analyzer asked for. The gate runs on the CPU (``meta`` tensors and a
tiny plane): seconds of wall-clock.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List

from repro_torch.analysis.report import Finding, render_findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Analysis gate: contract checking, round audit, "
                    "source lint.")
    ap.add_argument("--check-all", action="store_true",
                    help="run every analyzer (the gate)")
    ap.add_argument("--contracts", action="store_true",
                    help="contract checking of every registered preset x "
                         "layout x hierarchy")
    ap.add_argument("--audit", action="store_true",
                    help="audit of every preset's rounds")
    ap.add_argument("--lint", action="store_true",
                    help="AST lint (bare asserts, version probes, missing "
                         "contracts, network purity, port isolation)")
    ap.add_argument("paths", nargs="*",
                    help="files/directories for --lint (default: the "
                         "installed repro_torch package)")
    args = ap.parse_args(argv)

    run_contracts = args.check_all or args.contracts
    run_audit = args.check_all or args.audit
    run_lint = args.check_all or args.lint
    if not (run_contracts or run_audit or run_lint):
        ap.print_help()
        return 2

    findings: List[Finding] = []
    t0 = time.perf_counter()
    if run_contracts or run_audit:
        import repro_torch.core.sync  # noqa: F401 — fill the registries
    if run_contracts:
        from repro_torch.analysis.contracts import check_all
        findings += check_all()
    if run_audit:
        from repro_torch.analysis.audit import audit_presets
        findings += audit_presets()
    if run_lint:
        from repro_torch.analysis.lint import lint_paths
        findings += lint_paths(args.paths or None)

    dt = time.perf_counter() - t0
    if findings:
        print(render_findings(findings))
        print(f"{len(findings)} finding(s) in {dt:.1f}s", file=sys.stderr)
        return 1
    ran = [n for n, r in (("contracts", run_contracts), ("audit", run_audit),
                          ("lint", run_lint)) if r]
    print(f"OK: {' + '.join(ran)} clean in {dt:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
