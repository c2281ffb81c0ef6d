"""Per-learner streaming batches (paper Section 2 setting) — the
counterpart of ``repro.data.pipeline``.

``LearnerStreams`` wraps a data source and yields the batches of m
learners: learner i's sample E_t^i each round. ``next_chunk(n)`` draws n
rounds in bulk on the device, in the ``(n, m, B, ...)`` layout that
``DecentralizedLearner.run_chunk`` consumes. ``next_chunk(n,
on_round=fn)`` takes the per-round host path instead: ``fn(i)`` runs before round i's samples are drawn, so a
concept drift can change the source mid-chunk. Unbalanced sampling rates
B^i (Appendix C / Algorithm 2) are padded to max(B^i) with repeated
samples, and ``weights`` exposes the B^i.

Departure: the draws come from one ``torch.Generator`` on the device
(not the reference's per-round ``jax.random`` splits).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


class LearnerStreams:
    def __init__(self, source, m: int, batch: int = 10, seed: int = 0,
                 batch_sizes: Optional[Sequence[int]] = None):
        self.source = source
        self.device = source.device
        self.m = m
        self.batch = batch
        self.batch_sizes = batch_sizes
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed ^ 0x5EED)

    @property
    def weights(self) -> Optional[torch.Tensor]:
        if self.batch_sizes is None:
            return None
        return torch.tensor(self.batch_sizes, dtype=torch.float32,
                            device=self.device)

    def next_chunk(self, n: int, on_round=None):
        """Batches for n consecutive rounds: leaves (n, m, B, ...).
        ``on_round(i)`` (i = 0..n-1), when given, runs before round i's
        samples are drawn, and the rounds are drawn one at a time."""
        if n < 1:
            raise ValueError(f"chunk length must be >= 1, got {n}")
        if on_round is None:
            return self._draw(n)
        rounds = []
        for i in range(n):
            on_round(i)
            rounds.append(self._draw(1))
        return {k: torch.cat([r[k] for r in rounds]) for k in rounds[0]}

    def _draw(self, n: int):
        if self.batch_sizes is None:
            return self.source.sample(self._gen, self.batch,
                                      lead=(n, self.m))
        bmax = max(self.batch_sizes)
        per = []
        for bi in self.batch_sizes:
            b = self.source.sample(self._gen, bi, lead=(n,))
            reps = -(-bmax // bi)
            # pad by repeating the learner's own samples, as the reference
            per.append({k: v.tile((1, reps) + (1,) * (v.dim() - 2))[:, :bmax]
                        for k, v in b.items()})
        return {k: torch.stack([b[k] for b in per], dim=1) for k in per[0]}
