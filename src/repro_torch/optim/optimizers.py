"""Optimizers on the fleet plane — the counterpart of
``repro.optim.optimizers``.

The paper treats the learning algorithm phi as a black box; it evaluates
mini-batch SGD (its main setting), ADAM and RMSprop (Appendix A.5). Each
is one interface:

    opt = make_optimizer(train_cfg)
    state = opt.init(X)                  # X: the (m, P) parameter plane
    X, state = opt.update(X, G, state)   # G: the (m, P) gradient plane

Departure from the reference: the update is elementwise over the whole
``(m, P)`` plane and writes the parameter and moment planes IN PLACE
(the reference builds new pytrees), so the per-leaf views into the plane
stay valid and the fleet holds one copy of each. The arithmetic is the
reference's, expression for expression: rmsprop takes its decay from
``cfg.momentum`` and adam computes its bias correction in f32.

The step count is one int32 per learner, an ``(m,)`` tensor on the
plane's device, as the reference's ``jax.vmap(opt.init)`` stacks it: a
crashed learner's count freezes with its rows and a restarted one's
starts again at 0 (``network/faults.py``). A single model (a ``(P,)``
row, ``SerialLearner``) holds a ``(1,)`` count. Adam's bias correction
is per row, ``1 - b ** t`` in f32 shaped ``(m, 1)``; each power is taken
as a lone scalar power is, so rows with equal counts give the bits of a
fleet-wide count.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.config import TrainConfig


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    name: str


class OptState(NamedTuple):
    step: torch.Tensor                    # (m,) int32 per-learner counts
    mu: Optional[torch.Tensor] = None     # first moment / momentum
    nu: Optional[torch.Tensor] = None     # second moment


def _apply_wd(G, X, wd: float):
    return G if wd == 0.0 else G + wd * X


def init_step(X: torch.Tensor) -> torch.Tensor:
    """Zero step counts: one per row of an (m, P) plane, one for a (P,)
    row."""
    rows = X.shape[0] if X.dim() > 1 else 1
    return torch.zeros((rows,), dtype=torch.int32, device=X.device)


def _row_pow(base: float, t: torch.Tensor, like: torch.Tensor):
    """``base ** t`` in f32 for the (m,) counts ``t``, shaped to broadcast
    over the rows of ``like``. The exponent is a strided view, which keeps
    the CPU kernel on its scalar loop (``std::pow``, the bits of a
    one-element call) instead of its vectorized one; a CUDA power is per
    element either way. This rests on a dispatch detail of PyTorch,
    checked on 2.13 (CPU) and 2.11 (CUDA 12.8);
    ``tests/test_torch_optim_steps.py::
    test_equal_steps_give_the_fleet_wide_bits`` guards it."""
    tf = t.to(torch.float32)
    tf = torch.stack([tf, tf], dim=-1)[..., 0]
    out = torch.pow(torch.tensor(base, dtype=torch.float32,
                                 device=like.device), tf)
    return out.reshape((-1,) + (1,) * (like.dim() - 1)) if like.dim() > 1 \
        else out


def sgd(lr: float, weight_decay: float = 0.0) -> Optimizer:
    def init(X):
        return OptState(step=init_step(X))

    def update(X, G, state):
        g = _apply_wd(G, X, weight_decay)
        X.sub_(lr * g)
        return X, OptState(step=state.step + 1)

    return Optimizer(init, update, "sgd")


def momentum(lr: float, beta: float = 0.9,
             weight_decay: float = 0.0) -> Optimizer:
    def init(X):
        return OptState(step=init_step(X), mu=torch.zeros_like(X))

    def update(X, G, state):
        g = _apply_wd(G, X, weight_decay)
        mu = state.mu.mul_(beta).add_(g)
        X.sub_(lr * mu)
        return X, OptState(step=state.step + 1, mu=mu)

    return Optimizer(init, update, "momentum")


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(X):
        return OptState(step=init_step(X), mu=torch.zeros_like(X),
                        nu=torch.zeros_like(X))

    def update(X, G, state):
        g = _apply_wd(G, X, weight_decay)
        t = state.step + 1
        mu = state.mu.mul_(b1).add_((1 - b1) * g)
        nu = state.nu.mul_(b2).add_((1 - b2) * torch.square(g))
        bc1 = 1 - _row_pow(b1, t, X)
        bc2 = 1 - _row_pow(b2, t, X)
        X.sub_(lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps))
        return X, OptState(step=t, mu=mu, nu=nu)

    return Optimizer(init, update, "adam")


def rmsprop(lr: float, decay: float = 0.9, eps: float = 1e-8,
            weight_decay: float = 0.0) -> Optimizer:
    def init(X):
        return OptState(step=init_step(X), nu=torch.zeros_like(X))

    def update(X, G, state):
        g = _apply_wd(G, X, weight_decay)
        nu = state.nu.mul_(decay).add_((1 - decay) * torch.square(g))
        X.sub_(lr * g / (torch.sqrt(nu) + eps))
        return X, OptState(step=state.step + 1, nu=nu)

    return Optimizer(init, update, "rmsprop")


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    if cfg.optimizer == "sgd":
        return sgd(cfg.learning_rate, cfg.weight_decay)
    if cfg.optimizer == "momentum":
        return momentum(cfg.learning_rate, cfg.momentum, cfg.weight_decay)
    if cfg.optimizer == "adam":
        return adam(cfg.learning_rate, cfg.beta1, cfg.beta2, cfg.eps,
                    cfg.weight_decay)
    if cfg.optimizer == "rmsprop":
        return rmsprop(cfg.learning_rate, cfg.momentum, cfg.eps,
                       cfg.weight_decay)
    raise ValueError(cfg.optimizer)
