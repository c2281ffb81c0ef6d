"""The single-model training step — the counterpart of
``repro.train.step``.

This is the sigma_1 (continuous averaging) reference point: by the
paper's Proposition 3, m learners with batch B and learning rate eta
that average after every step are exactly one serial mini-batch SGD
step with batch mB and learning rate eta/m. The plain step is also the
baseline of a single model's training.

``make_train_step(loss_fn, train)`` returns ``(init_state, step)``.
``init_state(params)`` puts the model on the device and builds the
optimizer's state; ``step(state, batch)`` returns the next
``TrainState`` and ``{"loss": loss}``. With ``train.micro_batch`` = n >
1 the batch is split into n equal slices, taken in order: the losses and
the gradients are summed slice by slice, then multiplied by 1/n (the
reference's order), so the step holds the activations of one slice at a
time.

The gradient is taken by ``torch.autograd.grad`` on detached copies of
the leaves (views of the row), once and without ``create_graph``, where
the reference takes ``jax.value_and_grad``: ``torch.func.grad``
differentiates with ``create_graph``, which keeps every saved tensor of
the forward, and with ``lm_loss(remat=True)`` every layer's recomputed
activations too, until it returns. Here the backward frees each as it
passes it, so rematerialized layers lower the step's peak. The row of
the gradient is allocated after the backward, and the leaves' gradients
are copied into it as they are dropped: the weights, their gradient and
the new weights (3 x 4 bytes a weight in f32) bound the peak. A leaf the
loss does not reach gets zeros, as under ``torch.func.grad``.

Departures from the reference: the model is one ``(P,)`` row
(``core.flatten``), which the port's optimizer updates as
``SerialLearner``'s does; ``TrainState.params`` is the tree of views
into that row, and ``step`` works on copies of the row and the optimizer
state, so the state passed in is left as it was. ``TrainState.step`` is
an int32 tensor on the model's device. The entry point runs on
``device="cuda"`` unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.core.flatten import (fleet_adapter, tree_leaves, tree_map,
                                      tree_unflatten)
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import OptState, make_optimizer


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState
    step: torch.Tensor


def make_train_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                    train: TrainConfig, device="cuda"):
    """Returns ``(init_state, step)`` for ``loss_fn(params, batch)``."""
    dev = resolve_device(device)
    opt = make_optimizer(train)
    adapter = None

    def init_state(params) -> TrainState:
        nonlocal adapter
        params = tree_map(lambda x: x.to(dev), params)
        adapter = fleet_adapter(params)
        x = adapter.ravel_model(params)
        return TrainState(adapter.unravel_model(x), opt.init(x),
                          torch.zeros((), dtype=torch.int32, device=dev))

    def loss_and_grad(params, batch):
        """(the loss, the gradient as one (P,) row)."""
        leaves = [v.detach().requires_grad_() for v in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(adapter.structure, leaves), batch)
            grads = list(torch.autograd.grad(loss, leaves,
                                             allow_unused=True))
        del leaves
        g = torch.empty(adapter.P, dtype=adapter.plane_dtype, device=dev)
        for i, (o, s) in enumerate(zip(adapter.offsets, adapter.sizes)):
            if grads[i] is None:
                g[o:o + s].zero_()
            else:
                g[o:o + s].copy_(grads[i].reshape(-1))
            grads[i] = None
        return loss.detach(), g

    def grads_of(params, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        n = train.micro_batch
        if not n or n <= 1:
            return loss_and_grad(params, batch)
        micro = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
                 for k, v in batch.items()}
        loss_sum, grad_sum = None, None
        for i in range(n):
            loss, g = loss_and_grad(params, {k: v[i]
                                             for k, v in micro.items()})
            loss_sum = loss if loss_sum is None else loss_sum + loss
            grad_sum = g if grad_sum is None else grad_sum + g
        inv = 1.0 / n
        return loss_sum * inv, grad_sum * inv

    def step(state: TrainState, batch):
        if adapter is None:
            raise ValueError("call init_state before step")
        loss, g = grads_of(state.params, batch)
        x = adapter.ravel_model(state.params)
        x, opt_state = opt.update(x, g.to(x.dtype), OptState(*(
            None if t is None else t.clone() for t in state.opt_state)))
        return (TrainState(adapter.unravel_model(x), opt_state,
                           state.step + 1), {"loss": loss})

    return init_state, step
