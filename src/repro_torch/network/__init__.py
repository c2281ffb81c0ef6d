"""The simulated network environment — the counterpart of
``repro.network``: per-round learner availability (``availability``),
peer topologies (``topology``), link-cost accounting (``cost``), the
event timeline's arrival ring (``events``) and the fault-injection plane
(``faults``). Masks, overlays and link times are host values (numpy),
pure in ``(seed, t)``, equal to the reference's."""
from repro_torch.network import (  # noqa: F401
    availability, cost, events, faults, topology,
)
