"""The protocol engine — the counterpart of ``repro.core``: the fleet plane,
divergence, the staged sync kernel and the learner."""
