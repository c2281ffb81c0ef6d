"""AST lint: the repo-shape rules no runtime test can enforce — the
counterpart of ``repro.analysis.lint``, over ``src/repro_torch``.

Six rules (pure ``ast``: the linted code is not imported, so a file with
a syntax error is itself a finding, not a crash):

* **bare-assert** — no ``assert`` statements in library code: they
  vanish under ``python -O``. Raise ``ValueError``/``KeyError``.
* **torch-version** — ``torch.__version__`` may be read ONLY in the
  port's version shim, ``repro_torch/device.py`` (where the port pins
  the card's numerics): a version probe anywhere else is a fork in
  behavior that no test on one toolchain can see.
* **contract-required** — every ``register_trigger`` /
  ``register_cohort`` / ``register_aggregate`` / ``register_commit``
  call passes a non-None ``contract=`` (what
  ``repro_torch.analysis.contracts`` verifies).
* **print-outside-cli** — no bare ``print(`` in library code: output
  goes through ``repro_torch.telemetry.sink.get_logger().event(...)``.
  Exempt: ``__main__.py`` files, ``chip_smoke.py`` and the examples
  (they ARE the CLIs).
* **network-impure** — modules under ``repro_torch/network/`` are pure
  functions of ``(seed, t)``: no wall-clock (``time``/``datetime``), no
  stateful RNG (``random``, ``secrets``, ``numpy.random``), no carried
  ``torch.Generator`` state (``torch.Generator``, ``manual_seed``,
  ``torch.random``) and no carried keys (``prng.split``: derive
  per-round keys with ``prng.fold_in`` on the seed), no ``global``.
* **port-isolation** — nothing under ``repro_torch`` imports ``jax``
  (or ``jaxlib``) or the ``repro`` package: the port keeps its own copy
  of what it needs (``tests/test_torch_isolation.py``'s rule).
"""
from __future__ import annotations

import ast
import os
from typing import Iterable, List, Optional

from repro_torch.analysis.report import Finding

__all__ = ["lint_source", "lint_file", "lint_paths", "default_root",
           "REGISTER_FUNCS", "VERSION_SHIM"]

REGISTER_FUNCS = frozenset({
    "register_trigger", "register_cohort", "register_aggregate",
    "register_commit",
})

VERSION_SHIM = "device.py"

_IMPURE_MODULES = frozenset({"time", "random", "datetime", "secrets"})
_IMPURE_DOTTED = frozenset({
    "np.random", "numpy.random", "torch.Generator", "torch.manual_seed",
    "torch.random", "prng.split",
})
_FOREIGN = frozenset({"jax", "jaxlib", "repro"})


def default_root() -> str:
    """The installed ``repro_torch`` package directory — what
    ``--check-all`` lints when no paths are given."""
    import repro_torch
    return os.path.dirname(os.path.abspath(repro_torch.__file__))


def _parts(path: str):
    return path.replace(os.sep, "/").split("/")


def _is_shim(path: str) -> bool:
    return os.path.basename(path) == VERSION_SHIM


def _is_network(path: str) -> bool:
    return "network" in _parts(path)


def _is_cli(path: str) -> bool:
    base = os.path.basename(path)
    return (base in ("__main__.py", "chip_smoke.py")
            or "examples" in _parts(path))


def _in_port(path: str) -> bool:
    return "repro_torch" in _parts(path) or os.path.basename(path) == \
        "chip_smoke.py"


def _call_name(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def _dotted(node) -> str:
    """'torch.random.seed' for a nested Attribute/Name chain, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _imported(node) -> List[str]:
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if node.level:                      # a relative import stays inside
        return []
    return [node.module or ""]


def lint_source(src: str, path: str = "<string>") -> List[Finding]:
    """Lint one module's source text. ``path`` scopes the path-dependent
    rules (the version shim, network purity, the CLI exemption, the port
    isolation) and labels the findings."""
    findings: List[Finding] = []

    def bad(rule, node, msg):
        findings.append(Finding("lint", rule, f"{path}:{node.lineno}", msg))

    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding("lint", "syntax-error", f"{path}:{e.lineno or 0}",
                        str(e.msg))]

    shim, network = _is_shim(path), _is_network(path)
    cli, port = _is_cli(path), _in_port(path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assert):
            bad("bare-assert", node,
                "bare assert in library code — it vanishes under "
                "python -O; raise ValueError/KeyError with a message")
        elif isinstance(node, ast.Attribute):
            dotted = _dotted(node)
            if dotted == "torch.__version__" and not shim:
                bad("torch-version", node,
                    f"torch.__version__ read outside {VERSION_SHIM} — "
                    f"version probes live in the version shim only")
            if network and dotted in _IMPURE_DOTTED:
                bad("network-impure", node,
                    f"{dotted} in a network module — availability and "
                    f"topology must be pure in (seed, t); derive keys "
                    f"with prng.fold_in on the scalar seed")
        elif isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Name) and node.func.id == "print"
                    and not cli):
                bad("print-outside-cli", node,
                    "bare print() in library code — emit a structured "
                    "event via repro_torch.telemetry.sink.get_logger()"
                    ".event(...) and let the CLI print")
            if network and _call_name(node) == "manual_seed":
                bad("network-impure", node,
                    "manual_seed in a network module — a seeded generator "
                    "is carried state; derive keys with prng.fold_in")
            if _call_name(node) in REGISTER_FUNCS:
                kw = {k.arg: k.value for k in node.keywords}
                contract = kw.get("contract")
                if contract is None or (isinstance(contract, ast.Constant)
                                        and contract.value is None):
                    bad("contract-required", node,
                        f"{_call_name(node)} without a StageContract — "
                        f"declare the stage's promises "
                        f"(repro_torch.analysis.contracts verifies them)")
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for mod in _imported(node):
                top = mod.split(".")[0]
                if port and top in _FOREIGN:
                    bad("port-isolation", node,
                        f"import of {mod!r} in the port — it imports "
                        f"torch and numpy, never jax nor the repro "
                        f"package; keep a copy of what it needs")
                if network and top in _IMPURE_MODULES:
                    bad("network-impure", node,
                        f"import of {top!r} in a network module — "
                        f"availability and topology must be pure in "
                        f"(seed, t)")
        elif isinstance(node, ast.Global) and network:
            bad("network-impure", node,
                "global statement in a network module — availability "
                "and topology must be pure in (seed, t)")
    return findings


def lint_file(path: str) -> List[Finding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path)


def lint_paths(paths: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint every ``.py`` file under the given files/directories
    (default: the installed ``repro_torch`` package)."""
    if paths is None:
        paths = [default_root()]
    findings: List[Finding] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__")
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        findings += lint_file(os.path.join(dirpath, fn))
        else:
            findings += lint_file(p)
    return findings
