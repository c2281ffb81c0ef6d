"""The serving zoo's configs, the vision prefix and the audio codebooks
against the JAX package.

Every config of the zoo (the eight the serving zoo adds: mixtral-8x22b,
deepseek-v2-236b, hymba-1.5b, internvl2-76b, musicgen-large,
minitron-4b, qwen1.5-110b, llama3-405b) is the reference's field for
field at both sizes, with the same ``param_count()``, and builds a tree
of the reference's structure. ``zoo_parity`` holds one smoke config's model against the
reference's on the reference's own f32 weights, carried across by
``repro_torch.convert``, with the same numpy tokens: ``lm_apply`` logits
and the auxiliary loss, twelve ``lm_decode_step`` logits and the caches
after them, and a ``ServeEngine``'s prompt logits and 16 greedy tokens;
this file runs it for the vision backbone (a stub prefix of patch
embeddings before the text), the audio backbone (four codebook streams,
logits (B, S, K, V), (B, K) decode tokens) and the three dense configs
(qwen1.5's QKV bias); ``test_torch_moe_model.py``,
``test_torch_mla.py`` and ``test_torch_hybrid.py`` run it for theirs.

Tolerance: ``test_torch_lm.py``'s rtol 1e-4 / atol 1e-5 for f32 logits,
losses and caches (both sides in f32, summing in other orders); greedy
tokens identical. The reference runs jitted, each function compiled once
per config.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jget_arch  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.flatten import tree_leaves  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
ZOO = ("mixtral-8x22b", "deepseek-v2-236b", "hymba-1.5b", "internvl2-76b",
       "musicgen-large", "minitron-4b", "qwen1.5-110b", "llama3-405b")
PREFIX = 6           # stub patch embeddings before the text (vision)


def smoke_pair(name, **changes):
    """The reference's smoke config and the port's, with ``changes``
    applied to both (``moe=`` takes a dict of MoE fields)."""
    jcfg, cfg = jget_arch(name, smoke=True), get_arch(name, smoke=True)
    if "moe" in changes:
        fields = changes.pop("moe")
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **fields))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **fields))
    return (dataclasses.replace(jcfg, **changes),
            dataclasses.replace(cfg, **changes))


def tokens(cfg, B, S, seed):
    shape = (B, S, model.AUDIO_CODEBOOKS) if cfg.modality == "audio" else (
        B, S)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def zoo_parity(jcfg, cfg, S=24, seed=0, steps=12):
    """The checks named in the module docstring, for one config pair.
    Returns the reference's and the port's weights for further checks."""
    jparams = jmodel.init_lm_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    B = 2
    toks = tokens(cfg, B, S, seed + 1)
    kw, jkw = {}, {}
    if cfg.modality == "vision":
        pre = np.random.default_rng(seed + 2).standard_normal(
            (B, PREFIX, cfg.d_model)).astype(np.float32)
        kw["prefix_embeds"] = torch.from_numpy(pre)
        jkw["prefix_embeds"] = jnp.asarray(pre)
    want, jaux = jax.jit(functools.partial(jmodel.lm_apply, jcfg))(
        jparams, jnp.asarray(toks), **jkw)
    got, aux = model.lm_apply(cfg, tparams, torch.from_numpy(toks), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert (float(aux) > 0) == cfg.is_moe

    # decode: logits each step, then every cache leaf
    max_seq = 16
    jcache = jmodel.init_lm_cache(jcfg, B, max_seq)
    cache = model.init_lm_cache(cfg, B, max_seq, device="cpu")
    jstep = jax.jit(jengine.make_decode_step(jcfg))
    step = engine.make_decode_step(cfg)
    for t in range(steps):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t]),
                           jnp.int32(t))
        tl, cache = step(tparams, cache, torch.from_numpy(toks[:, t]), t)
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jleaves, leaves = jax.tree.leaves(jcache), tree_leaves(cache)
    assert jax.tree.structure(params_to_numpy(cache)) == jax.tree.structure(
        jax.tree.map(np.asarray, jcache))
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    # the engine: prompt logits, then 16 greedy tokens
    prompt = toks[:, :5]
    jeng = jengine.ServeEngine(jcfg, jparams, max_seq=32, batch=B)
    jlogits = jeng.feed(jnp.asarray(prompt))
    jgen = jeng.generate(16, first_logits=jlogits)
    eng = engine.ServeEngine(cfg, tparams, max_seq=32, batch=B, device="cpu")
    logits = eng.feed(torch.from_numpy(prompt))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    gen = eng.generate(16, first_logits=logits)
    assert gen.shape == jgen.shape
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
    return jparams, tparams


@pytest.mark.parametrize("name", ["internvl2-76b", "musicgen-large",
                                  "minitron-4b", "qwen1.5-110b",
                                  "llama3-405b"])
def test_zoo_model_matches_reference(name):
    zoo_parity(*smoke_pair(name))


@pytest.mark.parametrize("name", ZOO)
@pytest.mark.parametrize("smoke", [False, True])
def test_zoo_configs_match_reference(name, smoke):
    """Field for field (the MoE and MLA settings by value: each package
    has its own dataclasses), with the same counts."""
    jcfg, cfg = jget_arch(name, smoke=smoke), get_arch(name, smoke=smoke)
    for f in dataclasses.fields(cfg):
        mine, theirs = getattr(cfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(mine):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        else:
            assert mine == theirs, f.name
    assert {f.name for f in dataclasses.fields(jcfg)} - {
        f.name for f in dataclasses.fields(cfg)} == {"moe_layer_period",
                                                     "scan_layers"}
    assert jcfg.moe_layer_period == 1
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim
    assert cfg.is_moe == jcfg.is_moe
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("name", ZOO)
def test_zoo_init_has_the_reference_tree(name):
    """The port's own draw has the reference's tree, shapes and dtypes,
    and repeats from its seed."""
    jcfg, cfg = jget_arch(name, smoke=True), get_arch(name, smoke=True)
    jparams = jax.eval_shape(lambda k: jmodel.init_lm_params(jcfg, k),
                             jax.random.PRNGKey(0))
    mine = model.init_lm_params(cfg, seed=1, device="cpu")
    assert jax.tree.structure(params_to_numpy(mine)) == jax.tree.structure(
        jparams)
    for a, b in zip(tree_leaves(mine), jax.tree.leaves(jparams)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    again = model.init_lm_params(cfg, seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(mine),
                                                 tree_leaves(again)))


def test_vision_prefix_alone_and_before_text():
    """``prefix_embeds`` without tokens is the whole input; with tokens
    it is prepended: the text positions' logits depend on it, the
    prefix positions' do not depend on the text."""
    _, cfg = smoke_pair("internvl2-76b")
    params = model.init_lm_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    pre = torch.randn((1, PREFIX, cfg.d_model), generator=g)
    toks = torch.from_numpy(tokens(cfg, 1, 5, 0))
    alone, _ = model.lm_apply(cfg, params, prefix_embeds=pre)
    both, _ = model.lm_apply(cfg, params, toks, prefix_embeds=pre)
    text, _ = model.lm_apply(cfg, params, toks)
    assert both.shape == (1, PREFIX + 5, cfg.vocab_size)
    torch.testing.assert_close(both[:, :PREFIX], alone, **TOL)
    assert not torch.allclose(both[:, PREFIX:], text, **TOL)


def test_audio_sampling_draws_one_token_per_codebook():
    _, cfg = smoke_pair("musicgen-large")
    params = model.init_lm_params(cfg, seed=0, device="cpu")
    eng = engine.ServeEngine(cfg, params, max_seq=16, batch=2, device="cpu")
    logits = eng.feed(torch.from_numpy(tokens(cfg, 2, 3, 1)))
    assert logits.shape == (2, model.AUDIO_CODEBOOKS, cfg.vocab_size)
    out = eng.generate(4, generator=torch.Generator().manual_seed(0),
                       temperature=0.8, first_logits=logits)
    assert out.shape == (2, 4, model.AUDIO_CODEBOOKS)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size


@pytest.mark.parametrize("field,value", [
    ("moe", config.MoEConfig()),
    ("mla", config.MLAConfig()),
    ("block_type", config.BLOCK_HYBRID),
    ("modality", config.MODALITY_VISION),
    ("modality", config.MODALITY_AUDIO),
])
def test_zoo_fields_are_accepted(field, value):
    """MoE, MLA, hybrid blocks and the vision and audio modalities are
    ported: none of them raises any more (a hybrid block needs its SSM
    settings, as an SSM block does)."""
    extra = {"ssm": config.SSMConfig()} if field == "block_type" else {}
    cfg = dataclasses.replace(get_arch("llama3-8b", smoke=True),
                              **{field: value}, **extra)
    assert getattr(cfg, field) == value
    assert cfg.is_moe == (field == "moe")
    assert not hasattr(config, "NOT_PORTED_LM")


@pytest.mark.parametrize("fields,error", [
    ({"moe": object()}, TypeError),
    ({"mla": {"kv_lora_rank": 4}}, TypeError),
    ({"block_type": config.BLOCK_HYBRID}, ValueError),
    ({"modality": "video"}, ValueError),
])
def test_bad_zoo_fields_raise(fields, error):
    with pytest.raises(error):
        dataclasses.replace(get_arch("llama3-8b", smoke=True), **fields)
