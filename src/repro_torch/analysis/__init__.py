"""Analysis of the port's protocol machinery — the counterpart of
``repro.analysis``.

* ``contracts`` — *do the registered stages keep their declared
  promises, on every preset, layout and hierarchy?* Each stage and each
  compiled round runs on a mixed-dtype template (on ``meta`` tensors
  where it can); also the layout-conformance harness (tree, flat and
  sharded).
* ``audit`` — *does a round make a forbidden move?* A dispatch mode
  watches rounds run: float64 / complex tensors on the device, host
  syncs over the documented budget, narrow-int carried counters that
  can wrap.
* ``lint`` — *does the source obey the repo's shape rules?* AST pass: no
  bare asserts, ``torch.__version__`` only in the version shim, every
  ``register_*`` call declares a contract, ``network/`` stays pure in
  (seed, t), nothing imports jax or ``repro``.
* ``roofline`` — *is a run compute-, memory- or collective-bound, and
  what is each kernel's least time?* (import
  ``repro_torch.analysis.roofline`` directly).

The reference's ``hlo`` module (collectives parsed from compiled HLO
text) has no port: there is no HLO.

``python -m repro_torch.analysis --check-all`` runs the first three as
the gate (exit 1 on any finding).
"""
from repro_torch.analysis.report import Finding, render_findings
from repro_torch.analysis.contracts import (
    abstract_state, check_all, check_hierarchy, check_layout_equivalence,
    check_preset_matrix, check_registry, check_round, check_spec,
    mixed_template,
)
from repro_torch.analysis.audit import (
    audit_carry, audit_learner, audit_presets, audit_spec,
)
from repro_torch.analysis.lint import lint_file, lint_paths, lint_source

__all__ = [
    "Finding", "render_findings",
    # contracts
    "abstract_state", "check_all", "check_hierarchy",
    "check_layout_equivalence", "check_preset_matrix", "check_registry",
    "check_round", "check_spec", "mixed_template",
    # audit
    "audit_carry", "audit_learner", "audit_presets", "audit_spec",
    # lint
    "lint_file", "lint_paths", "lint_source",
]
