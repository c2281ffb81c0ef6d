"""Programs and input specs for the dry run and the launchers — the
counterpart of ``repro.launch.specs``.

``build_program(cfg, shape, mesh, mode)`` returns a ``Program``: the
step function, shape-only stand-ins for every input (``meta`` tensors:
shapes and dtypes, no memory) and the in / out specs
(``launch.sharding.PartitionSpec`` trees). ``materialize(prog, seed,
device)`` gives the same program with real inputs on ``device``: the
weights by ``init_lm_params`` from the seed, tokens by ``prng.randint``
(ROADMAP C6: no ``TokenStream`` at a full vocabulary), caches by
``init_lm_cache``, and the step function made again for that device.

Modes, with the reference's defaults (``TrainConfig(optimizer="sgd",
remat=True)``, ``ProtocolConfig(kind="dynamic", b=10, delta=1.0)``):

* ``train`` — the sigma_1 step (``train/step.py::make_train_step`` with
  ``lm_loss(remat=train.remat)``);
* ``train_dynamic`` — the paper's protocol over m learners (the ``pod``
  axis, or 2), ``core/distributed.py::make_dynamic_train_step``;
* ``train_periodic`` — sigma_b in the same layout;
* ``prefill`` — the full forward (``serve/engine.py::make_prefill``; a
  vision model's ``lm_apply`` with its ``VISION_PREFIX_TOKENS`` patch
  embeddings);
* ``decode`` — one token against a ``seq_len``-deep cache
  (``make_decode_step``), its weights left sharded (the dry run counts
  no gather for it).

Each program calls its step as it is: the activation rules
(``sharding.activation_rules``) take effect through
``pjit_utils.mesh_context`` once the model code calls ``constrain`` and
``gather_weight``, which it does not yet (ROADMAP).

Departures from the reference. The sigma_1 optimizer's step count is
(1,), one a row (``optim/optimizers.py::init_step``). The fleet modes'
state is the port's ``DynamicTrainState``: ``plane`` (m, P) and ``ref``
(P,) are raveled rows in the plane's dtype (f32, also for a bf16
model), each with the spec ``Raveled`` of its leaves' shapes and specs;
``params`` are views into the plane where a leaf has its dtype (copies
otherwise); ``step``, ``syncs`` and ``checks`` are host ints; it starts
at step b - 1, so that the program's one call is a checked step (the
step the reference's HLO lists with its ``cond``'s collectives), which
the dry run counts as one that syncs (``dryrun.count``). The decode
program's ``pos`` is a () int32 tensor, which the step reads on the host;
on ``meta`` it has no value and the step writes the cache's last slot,
which costs what any slot costs.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.config import (
    MODALITY_AUDIO, MODALITY_VISION, ModelConfig, ProtocolConfig,
    ShapeConfig, TrainConfig,
)
from repro_torch.core.distributed import (
    DynamicTrainState, init_dynamic_state, make_dynamic_train_step,
    make_periodic_train_step,
)
from repro_torch.core.flatten import (
    tree_leaves, tree_map, tree_structure, tree_unflatten,
)
from repro_torch.device import resolve_device, shapes_only
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import axis_sizes
from repro_torch.launch.sharding import PartitionSpec as P
from repro_torch.models.model import (
    AUDIO_CODEBOOKS, init_lm_cache, init_lm_params, lm_apply, lm_loss,
)
from repro_torch.serve.engine import make_decode_step, make_prefill
from repro_torch.train.step import TrainState, make_train_step

VISION_PREFIX_TOKENS = 256


class Raveled(NamedTuple):
    """The spec of a raveled row: its leaves' shapes and specs, in the
    row's column order."""
    shapes: Tuple[Tuple[int, ...], ...]
    specs: Tuple[P, ...]


@dataclass
class Program:
    name: str
    fn: Callable
    args: Tuple[Any, ...]          # meta tensors, or real ones
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    meta: dict
    # what ``materialize`` builds the program again from
    recipe: tuple = field(default=(), repr=False)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@functools.lru_cache(maxsize=32)
def _one_layer_layout(cfg: ModelConfig) -> tuple:
    """(tree structure, ((shape, dtype, stacked), ...)) of the parameter
    tree of ``cfg`` at one layer: ``init_lm_params`` run under a
    fake-tensor mode, which draws no values and holds no memory;
    ``stacked`` marks the leaves of ``blocks``, whose leading axis is
    the layers'."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = init_lm_params(cfg, dtype=_dtype(cfg), device="cpu")
    stacked = {id(t) for t in tree_leaves(params["blocks"])}
    return tree_structure(params), tuple(
        (tuple(t.shape), t.dtype, id(t) in stacked)
        for t in tree_leaves(params))


def params_struct(cfg: ModelConfig) -> dict:
    """The parameter tree as ``meta`` tensors (the one-layer tree, its
    stacked leaves grown to ``cfg.num_layers``)."""
    structure, leaves = _one_layer_layout(
        dataclasses.replace(cfg, num_layers=1))
    return tree_unflatten(structure, [
        torch.empty(((cfg.num_layers,) + s[1:]) if stacked else s,
                    dtype=d, device="meta") for s, d, stacked in leaves])


def _tokens(shape, vocab: int, seed: int, device) -> Tuple[torch.Tensor, ...]:
    """(tokens, labels) int32 of ``shape`` (the sequence on dim 1): meta
    stand-ins, or ``prng.randint`` draws with the labels the next token."""
    if device.type == "meta":
        return tuple(torch.empty(shape, dtype=torch.int32, device=device)
                     for _ in range(2))
    seq = (shape[0], shape[1] + 1) + tuple(shape[2:])
    toks = prng.randint(prng.key(seed, device), seq, 0, vocab, device)
    return toks[:, :-1].clone(), toks[:, 1:].clone()


def batch_struct(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 device="meta") -> dict:
    """A training / prefill batch for the arch's modality: meta stand-ins
    (the default), or drawn from ``seed`` on ``device``."""
    dev = torch.device(device)
    if cfg.modality == MODALITY_AUDIO:
        t, lab = _tokens((batch, seq, AUDIO_CODEBOOKS), cfg.vocab_size, seed,
                         dev)
        return {"tokens": t, "labels": lab}
    if cfg.modality == MODALITY_VISION:
        s_text = seq - VISION_PREFIX_TOKENS
        t, lab = _tokens((batch, s_text), cfg.vocab_size, seed, dev)
        pshape = (batch, VISION_PREFIX_TOKENS, cfg.d_model)
        pe = (torch.empty(pshape, dtype=_dtype(cfg), device=dev)
              if dev.type == "meta" else 0.02 * prng.normal(
                  prng.key(seed + 1, dev), pshape, dev).to(_dtype(cfg)))
        return {"tokens": t, "labels": lab, "prefix_embeds": pe}
    t, lab = _tokens((batch, seq), cfg.vocab_size, seed, dev)
    return {"tokens": t, "labels": lab}


def input_specs(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                device="meta") -> dict:
    """Every model input of this shape (meta stand-ins by default)."""
    dev = torch.device(device)
    if shape.kind == "decode":
        tshape = ((shape.global_batch, AUDIO_CODEBOOKS)
                  if cfg.modality == MODALITY_AUDIO
                  else (shape.global_batch,))
        with shapes_only():
            cache = init_lm_cache(cfg, shape.global_batch, shape.seq_len,
                                  _dtype(cfg), dev)
        tok = _tokens(tshape + (1,), cfg.vocab_size, seed, dev)[0]
        return {"token": tok.reshape(tshape), "cache": cache,
                "pos": torch.full((), shape.seq_len - 1, dtype=torch.int32,
                                  device=dev)}
    b = batch_struct(cfg, shape.global_batch, shape.seq_len, seed, dev)
    if shape.kind == "prefill":
        b.pop("labels")
    return b


def _host_pos(pos: torch.Tensor, depth: int) -> int:
    """The decode position on the host; on ``meta`` the last slot of a
    ``depth``-deep cache."""
    return depth - 1 if pos.device.type == "meta" else int(pos)


def _raveled(p_struct, p_spec) -> Raveled:
    """A raveled row's spec, its leaves in the row's (``tree_leaves``)
    order."""
    return Raveled(tuple(tuple(t.shape) for t in tree_leaves(p_struct)),
                   tuple(_spec_leaves(p_spec)))


def _spec_leaves(tree) -> list:
    """The specs of a spec tree in ``tree_leaves`` order (dict keys
    sorted)."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _spec_leaves(v)]
    return []


def build_program(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  mode: str = "auto",
                  train: Optional[TrainConfig] = None,
                  proto: Optional[ProtocolConfig] = None) -> Program:
    """The ``mode`` program of ``cfg`` at ``shape`` on ``mesh`` (an
    ``AbstractMesh`` or a ``DeviceMesh``), its inputs on ``meta``."""
    with shapes_only():
        return _program(cfg, shape, mesh, mode, train, proto, 0,
                        torch.device("meta"))


def materialize(prog: Program, seed: int = 0, device="cuda") -> Program:
    """``prog`` with real inputs on ``device`` (the card unless the caller
    asks for the CPU), drawn from ``seed``, and its step made for them."""
    return _program(*prog.recipe, seed, resolve_device(device))


def _program(cfg, shape, mesh, mode, train, proto, seed, dev) -> Program:
    multi_pod = "pod" in axis_sizes(mesh)
    axes = shd.default_axes_map(multi_pod)
    train = train or TrainConfig(optimizer="sgd", remat=True)
    proto = proto or ProtocolConfig(kind="dynamic", b=10, delta=1.0)
    if mode == "auto":
        mode = {"train": "train", "prefill": "prefill",
                "decode": "decode"}[shape.kind]
    recipe = (cfg, shape, mesh, mode, train, proto)
    meta_dev = dev.type == "meta"

    def params():
        return (params_struct(cfg) if meta_dev
                else init_lm_params(cfg, seed, _dtype(cfg), dev))

    p_struct = params_struct(cfg)
    p_spec = shd.param_spec_tree(p_struct, mesh, axes)
    loss_fn = (lambda p, b: lm_loss(cfg, p, b, remat=train.remat))  # noqa

    if mode == "train":
        init_state, step = make_train_step(loss_fn, train, device=dev)
        state = init_state(params())
        state_spec = TrainState(params=p_spec,
                                opt_state=shd.replicated(state.opt_state),
                                step=P())
        batch = batch_struct(cfg, shape.global_batch, shape.seq_len, seed,
                             dev)
        b_spec = shd.batch_spec_tree(batch, mesh, axes)
        return Program(
            name=f"{cfg.name}:{shape.name}:train",
            fn=step, args=(state, batch),
            in_shardings=(state_spec, b_spec),
            out_shardings=(state_spec, {"loss": P()}),
            meta={"mode": "train", "multi_pod": multi_pod}, recipe=recipe)

    if mode in ("train_dynamic", "train_periodic"):
        m = axis_sizes(mesh)["pod"] if multi_pod else 2
        # multi-pod: the pod axis carries the learners and a learner's
        # batch shards over data; single pod: the learner axis unsharded
        axes = (dict(axes, batch="data") if multi_pod
                else dict(axes, learner=None))
        mk = (make_dynamic_train_step if mode == "train_dynamic"
              else make_periodic_train_step)
        step = mk(loss_fn, proto, train, m)
        base = params()
        state = init_dynamic_state(lambda _g: base, torch.Generator(), m,
                                   train, device=dev)._replace(
                                       step=proto.b - 1)
        del base
        stacked = tree_map(lambda t: torch.empty(
            (m,) + tuple(t.shape), dtype=t.dtype, device="meta"), p_struct)
        sp_stacked = shd.param_spec_tree(stacked, mesh, axes,
                                         learner_axis=True)
        state_spec = DynamicTrainState(
            params=sp_stacked, opt_state=shd.replicated(state.opt_state),
            ref=_raveled(p_struct, p_spec), step=P(), syncs=P(), checks=P(),
            plane=_raveled(stacked, sp_stacked))
        per = shape.global_batch // m
        batch = {k: v.reshape((m, per) + tuple(v.shape[1:]))
                 for k, v in batch_struct(cfg, shape.global_batch,
                                          shape.seq_len, seed, dev).items()}
        b_spec = shd.batch_spec_tree(batch, mesh, axes, learner_axis=True)
        out_metrics = {"loss": P(), "synced": P()}
        if mode == "train_dynamic":
            out_metrics.update({"loss_per_learner": P(), "max_sq_dist": P()})
        return Program(
            name=f"{cfg.name}:{shape.name}:{mode}", fn=step,
            args=(state, batch), in_shardings=(state_spec, b_spec),
            out_shardings=(state_spec, out_metrics),
            meta={"mode": mode, "m": m, "multi_pod": multi_pod},
            recipe=recipe)

    if mode == "prefill":
        batch = batch_struct(cfg, shape.global_batch, shape.seq_len, seed,
                             dev)
        batch.pop("labels")
        b_spec = shd.batch_spec_tree(batch, mesh, axes)
        if cfg.modality == MODALITY_VISION:
            def fn(p, t, pe):
                return lm_apply(cfg, p, t, prefix_embeds=pe)[0]
            args = (params(), batch["tokens"], batch["prefix_embeds"])
            in_sh = (p_spec, b_spec["tokens"], b_spec["prefix_embeds"])
        else:
            fn = make_prefill(cfg)
            args = (params(), batch["tokens"])
            in_sh = (p_spec, b_spec["tokens"])
        return Program(
            name=f"{cfg.name}:{shape.name}:prefill",
            fn=fn, args=args, in_shardings=in_sh,
            out_shardings=P(axes["batch"], None, None),
            meta={"mode": "prefill", "multi_pod": multi_pod}, recipe=recipe)

    if mode == "decode":
        spec_in = input_specs(cfg, shape, seed, dev)
        step = make_decode_step(cfg)

        def fn(p, c, t, pos):
            return step(p, c, t, _host_pos(pos, shape.seq_len))
        return Program(
            name=f"{cfg.name}:{shape.name}:decode", fn=fn,
            args=(params(), spec_in["cache"], spec_in["token"],
                  spec_in["pos"]),
            in_shardings=(p_spec,
                          shd.cache_spec_tree(spec_in["cache"], mesh, axes),
                          shd.batch_spec_tree(spec_in["token"], mesh, axes),
                          P()),
            out_shardings=None,
            meta={"mode": "decode", "multi_pod": multi_pod}, recipe=recipe)

    raise ValueError(mode)
