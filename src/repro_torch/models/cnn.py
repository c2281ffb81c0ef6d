"""The paper's own model families in PyTorch — the counterpart of
``repro.models.cnn``.

* MNIST CNN (Appendix A.1, Table 1): Conv32-Conv64-MaxPool-Dense128-Dense10.
* Deep-driving CNN (Appendix A.4, Table 5; Bojarski et al. PilotNet).
* MLP for the random-graphical-model concept-drift task (Appendix A.3).

A ``cnn_spec`` is a tuple of layer descriptors:
  ("conv", out_ch, k, stride)   valid-padded conv + ReLU
  ("pool", k)                   max pool k x k
  ("flatten",)
  ("dense", n)                  dense + ReLU (last dense is linear)
  ("dropout", rate)             identity here (see below)

Parameters are the reference's tree, ``{"layers": [{"b", "w"} | {}]}``,
with conv weights HWIO and dense weights ``(d_in, d_out)``, so a plane
row is byte-compatible with the reference's. Batches keep the
reference's layout: ``x`` is ``(B, H, W, C)`` (or ``(B, d_in)``), ``y``
integer labels (or regression targets). Inside, convolutions run in
PyTorch's NCHW/OIHW (the HWIO weight is permuted, not copied), and the
activations are permuted back to NHWC before ``flatten`` so the first
dense layer sees its rows in the reference's order.

Departure: dropout is the identity. The reference applies it only when
given an rng, and the protocol path never gives one (its local step
calls ``loss_fn(params, batch)``), so training matches either way.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import dense_init


def _conv_init(generator, k: int, c_in: int, c_out: int, dtype):
    # Glorot-uniform with the conv fans: fan_in = k*k*c_in,
    # fan_out = k*k*c_out
    lim = math.sqrt(6.0 / (k * k * (c_in + c_out)))
    w = torch.empty((k, k, c_in, c_out), dtype=dtype, device=generator.device)
    w.uniform_(-lim, lim, generator=generator)
    return {"w": w, "b": torch.zeros((c_out,), dtype=dtype,
                                     device=generator.device)}


def init_cnn_params(cfg: ModelConfig, generator: torch.Generator,
                    dtype=torch.float32):
    """Fresh parameters drawn from ``generator`` on its device."""
    if len(cfg.input_shape) == 1:           # dense-only model (drift MLP)
        h = w = c = 0
        flat = cfg.input_shape[0]
    else:
        h, w, c = cfg.input_shape
        flat = None
    params = []
    for layer in cfg.cnn_spec:
        if layer[0] == "conv":
            _, c_out, k, s = layer
            params.append(_conv_init(generator, k, c, c_out, dtype))
            h = (h - k) // s + 1
            w = (w - k) // s + 1
            c = c_out
        elif layer[0] == "pool":
            params.append({})
            h, w = h // layer[1], w // layer[1]
        elif layer[0] == "flatten":
            params.append({})
            if c:                       # image input; 1-D inputs keep flat
                flat = h * w * c
        elif layer[0] == "dense":
            params.append({
                "w": dense_init(generator, flat, layer[1], dtype),
                "b": torch.zeros((layer[1],), dtype=dtype,
                                 device=generator.device)})
            flat = layer[1]
        elif layer[0] == "dropout":
            params.append({})
        else:
            raise ValueError(layer)
    return {"layers": params}


def cnn_apply(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) [or (B, d_in) for pure-dense specs] ->
    (B, num_outputs)."""
    spec = cfg.cnn_spec
    n_dense = sum(1 for layer in spec if layer[0] == "dense")
    seen_dense = 0
    nchw = False
    for layer, p in zip(spec, params["layers"]):
        if layer[0] == "conv":
            if not nchw:
                x = x.permute(0, 3, 1, 2)
                nchw = True
            stride = layer[3]
            w = p["w"].permute(3, 2, 0, 1)          # HWIO -> OIHW view
            x = F.relu(F.conv2d(x, w, stride=stride)
                       + p["b"][:, None, None])
        elif layer[0] == "pool":
            k = layer[1]
            x = F.max_pool2d(x, k, k)
        elif layer[0] == "flatten":
            if nchw:                    # the reference flattens NHWC
                x = x.permute(0, 2, 3, 1)
                nchw = False
            x = x.reshape(x.shape[0], -1)
        elif layer[0] == "dense":
            seen_dense += 1
            x = x @ p["w"] + p["b"]
            if seen_dense < n_dense:
                x = F.relu(x)
    return x


def cnn_loss(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Cross-entropy for classifiers, MSE for regression (num_outputs==1)."""
    out = cnn_apply(cfg, params, batch["x"])
    if cfg.num_outputs == 1:
        return torch.mean(torch.square(out[:, 0] - batch["y"]))
    lp = torch.log_softmax(out.float(), dim=-1)
    return -torch.mean(torch.gather(lp, -1, batch["y"].long()[:, None]))


def cnn_accuracy(cfg: ModelConfig, params, batch) -> torch.Tensor:
    out = cnn_apply(cfg, params, batch["x"])
    return torch.mean((torch.argmax(out, dim=-1) == batch["y"]).float())
