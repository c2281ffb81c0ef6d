"""The launcher — the counterpart of ``repro.launch``.

``train`` trains any config of the zoo through the port's step factories
(``--mode train | train_dynamic | train_periodic``). The reference's
mesh, sharding, spec and dry-run modules (``mesh.py``, ``sharding.py``,
``specs.py``, ``dryrun.py``) and ``pjit_utils.py`` are ROADMAP A25.
"""
