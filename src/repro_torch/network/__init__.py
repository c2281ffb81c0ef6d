"""The simulated network environment — the counterpart of
``repro.network``: per-round learner availability (``availability``),
peer topologies (``topology``) and link-cost accounting (``cost``).
Masks, overlays and link times are host values (numpy), pure in
``(seed, t)``, equal to the reference's."""
from repro_torch.network import availability, cost, topology  # noqa: F401
