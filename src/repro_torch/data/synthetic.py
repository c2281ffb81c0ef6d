"""Synthetic data sources on the device — the counterpart of
``repro.data.synthetic``.

* ``SyntheticMNIST`` — an MNIST-like 10-class image task: class templates
  (smooth random patterns) + per-sample noise and random shifts.

The class templates come from ``np.random.RandomState(seed)`` exactly as
in the reference, so they are equal bit for bit. The per-sample draws
(labels, shifts, noise) come from a ``torch.Generator`` on the device and
do not match the reference's ``jax.random`` draws; parity tests feed the
reference's own batches instead. ``GraphicalModelStream``,
``DeepDriveStream`` and ``TokenStream`` wait for their slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


class SyntheticMNIST:
    """10-class images from class templates + noise + translation."""

    def __init__(self, seed: int = 0, num_classes: int = 10,
                 image_size: int = 28, noise: float = 0.35, device="cuda"):
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.image_size = image_size
        self.noise = noise
        rng = np.random.RandomState(seed)
        # smooth class templates: random low-frequency patterns
        freqs = rng.randn(num_classes, 4, 4)
        t = np.linspace(0, 2 * np.pi, image_size)
        basis = np.stack([np.sin((i + 1) * t / 2) for i in range(4)])  # (4,S)
        self.templates = np.einsum("cij,ih,jw->chw", freqs, basis, basis)
        self.templates /= np.abs(self.templates).max(axis=(1, 2), keepdims=True)
        self._templates_dev = torch.as_tensor(
            self.templates, dtype=torch.float32, device=self.device)

    def sample(self, generator: torch.Generator, batch: int,
               lead: tuple = ()):
        """A batch ``{"x": (*lead, B, H, W, 1) f32, "y": (*lead, B)
        int64}`` drawn from ``generator`` (on this source's device): each
        image is its class template rolled by a shift in [-2, 2] along
        both axes, plus Gaussian noise."""
        shape = (*lead, batch)
        n = int(np.prod(shape))
        S = self.image_size
        dev = self.device
        labels = torch.randint(0, self.num_classes, (n,), generator=generator,
                               device=dev)
        shift = torch.randint(-2, 3, (n, 2), generator=generator, device=dev)
        ar = torch.arange(S, device=dev)
        # roll by s: out[h, w] = template[(h - s0) % S, (w - s1) % S]
        rows = (ar[None, :] - shift[:, :1]) % S                      # (n, S)
        cols = (ar[None, :] - shift[:, 1:]) % S
        temps = self._templates_dev[labels[:, None, None], rows[:, :, None],
                                    cols[:, None, :]]
        noise = torch.randn((n, S, S), generator=generator, device=dev)
        imgs = temps + self.noise * noise
        return {"x": imgs.reshape(*shape, S, S, 1),
                "y": labels.reshape(shape)}
