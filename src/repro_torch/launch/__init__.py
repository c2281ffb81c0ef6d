"""The launcher — the counterpart of ``repro.launch``.

``train`` trains any config of the zoo through the port's step factories
(``--mode train | train_dynamic | train_periodic``). ``mesh`` holds the
production meshes (abstract: names and sizes) and ``device_mesh``, a
``torch.distributed.DeviceMesh``; ``sharding`` the reference's
parameter, cache and batch rules; ``specs`` builds the five programs
(``build_program``, inputs on ``meta``) and ``materialize``s them on a
device; ``dryrun`` counts every program on ``meta`` and writes the
records ``benchmarks/torch_roofline_table.py`` tabulates. The model-code
hooks are ``repro_torch.pjit_utils``.
"""
