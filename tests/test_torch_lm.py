"""The port's decoder LM and serving path against the JAX package.

The llama3-8b and llama3-8b-swa smoke configs (2 layers, d_model 256,
8 heads over 2 KV heads, head dim 32; the swa window is 16), with the
reference's own f32 weights carried across by ``repro_torch.convert``
and the same numpy tokens. On the CPU the port's attention and norm run
their plain versions, which tests/test_torch_lm_kernels.py holds against
the Pallas kernels.

Tolerance for f32 logits and caches: rtol 1e-4 / atol 1e-5. Both sides
compute in f32 but sum the products, the softmax and the norm
statistics in other orders, through two layers and the head. Greedy
tokens must be identical.
"""
import dataclasses

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
from repro_torch.models import attention, model  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("llama3-8b", "llama3-8b-swa")
_CACHE = {}


def _setup(name, dtype=jnp.float32):
    """The reference's smoke config and weights, and the port's twins
    (built once per arch and dtype; callers only read them)."""
    if (name, dtype) not in _CACHE:
        jcfg = jget_arch(name, smoke=True)
        jparams = jmodel.init_lm_params(jcfg, jax.random.PRNGKey(0), dtype)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _CACHE[name, dtype] = (jcfg, jparams, get_arch(name, smoke=True),
                               tparams)
    return _CACHE[name, dtype]


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _count_paths(monkeypatch):
    """Count the model's calls into each attention entry point."""
    calls = {"flash_attention_gqa": 0, "swa_attention": 0}
    for name in calls:
        fn = getattr(attention.ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(attention.ops, name, counted)
    return calls


@pytest.mark.parametrize("name,S,path", [
    ("llama3-8b", 24, "flash_attention_gqa"),
    ("llama3-8b-swa", 32, "swa_attention"),          # S = 2w: banded
    ("llama3-8b-swa", 48, "swa_attention"),          # three bands
    ("llama3-8b-swa", 24, "flash_attention_gqa"),    # S < 2w: masked
    ("llama3-8b-swa", 16, "flash_attention_gqa"),    # S = w
])
def test_lm_apply_matches_reference(name, S, path, monkeypatch):
    jcfg, jparams, cfg, tparams = _setup(name)
    toks = _tokens((2, S), cfg.vocab_size, seed=S)
    calls = _count_paths(monkeypatch)
    logits, aux = model.lm_apply(cfg, tparams, torch.from_numpy(toks))
    want, _ = jmodel.lm_apply(jcfg, jparams, jnp.asarray(toks))
    assert logits.shape == (2, S, cfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    assert calls[path] == cfg.num_layers
    assert sum(calls.values()) == cfg.num_layers


@pytest.mark.parametrize("name", ARCHS)
def test_make_prefill_matches_reference(name):
    jcfg, jparams, cfg, tparams = _setup(name)
    toks = _tokens((3, 20), cfg.vocab_size, seed=5)
    got = engine.make_prefill(cfg)(tparams, torch.from_numpy(toks))
    want = jax.jit(jengine.make_prefill(jcfg))(jparams, jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match_reference_logits_and_cache(name):
    jcfg, jparams, cfg, tparams = _setup(name)
    T, B, max_seq = 12, 2, 16
    toks = _tokens((B, T), cfg.vocab_size, seed=9)
    jcache = jmodel.init_lm_cache(jcfg, B, max_seq)
    cache = model.init_lm_cache(cfg, B, max_seq, device="cpu")
    jstep = jax.jit(jengine.make_decode_step(jcfg))
    step = engine.make_decode_step(cfg)
    for t in range(T):
        want, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t]),
                             jnp.int32(t))
        got, cache = step(tparams, cache, torch.from_numpy(toks[:, t]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jleaves = jax.tree.leaves(jcache)
    leaves = tree_leaves(cache)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_engine_greedy_tokens_match_reference(name):
    jcfg, jparams, cfg, tparams = _setup(name)
    prompt = _tokens((2, 5), cfg.vocab_size, seed=1)
    jeng = jengine.ServeEngine(jcfg, jparams, max_seq=32, batch=2)
    jlogits = jeng.feed(jnp.asarray(prompt))
    want = jeng.generate(16, first_logits=jlogits)
    eng = engine.ServeEngine(cfg, tparams, max_seq=32, batch=2,
                             device="cpu")
    logits = eng.feed(torch.from_numpy(prompt))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    got = eng.generate(16, first_logits=logits)
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert eng.pos == jeng.pos == 21


def test_engine_prompt_logits_equal_prefill_last_position():
    _, _, cfg, tparams = _setup("llama3-8b")
    prompt = torch.from_numpy(_tokens((2, 7), cfg.vocab_size, seed=2))
    eng = engine.ServeEngine(cfg, tparams, max_seq=8, batch=2, device="cpu")
    logits = eng.feed(prompt)
    full = engine.make_prefill(cfg)(tparams, prompt)
    torch.testing.assert_close(logits, full[:, -1], **TOL)
    with pytest.raises(ValueError, match="does not fit"):
        eng.feed(prompt[:, :2])


def test_sampling_needs_an_explicit_generator():
    _, _, cfg, tparams = _setup("llama3-8b")
    eng = engine.ServeEngine(cfg, tparams, max_seq=16, batch=2, device="cpu")
    logits = eng.feed(torch.from_numpy(_tokens((2, 3), cfg.vocab_size)))
    with pytest.raises(ValueError, match="Generator"):
        eng.generate(2, temperature=1.0, first_logits=logits)
    g = torch.Generator().manual_seed(0)
    out = eng.generate(4, generator=g, temperature=0.7, first_logits=logits)
    assert out.shape == (2, 4)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size


def test_sliding_window_ring_buffer_decode():
    """Decode past the window (T = 40, w = 16): the ring buffer stays at
    the window's size, every step's logits match the reference's, and the
    last step matches the port's own full forward (the masked path,
    since 40 % 16 != 0)."""
    jcfg, jparams, cfg, tparams = _setup("llama3-8b-swa")
    T = 40
    toks = _tokens((1, T), cfg.vocab_size, seed=2)
    cache = model.init_lm_cache(cfg, 1, max_seq=T, device="cpu")
    jcache = jmodel.init_lm_cache(jcfg, 1, max_seq=T)
    assert cache["attn"]["k"].shape[2] == cfg.sliding_window == 16
    jstep = jax.jit(lambda p, c, t, pos: jmodel.lm_decode_step(
        jcfg, p, t, c, pos))
    for t in range(T):
        logits, cache = model.lm_decode_step(
            cfg, tparams, torch.from_numpy(toks[:, t]), cache, t)
        want, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t]),
                             jnp.int32(t))
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(cache["attn"]["pos"].numpy(),
                                  np.asarray(jcache["attn"]["pos"]))
    full, _ = model.lm_apply(cfg, tparams, torch.from_numpy(toks))
    torch.testing.assert_close(logits, full[:, -1], **TOL)


def test_bf16_forward_follows_the_reference():
    """bf16 weights and activations: the port keeps attention scores and
    probabilities in f32 where the reference's ``_sdpa`` rounds them to
    bf16, and bf16 products round differently in XLA and PyTorch, so the
    logits agree only to bf16 precision through the two layers (atol 0.05
    on logits of size ~1), and most greedy picks agree."""
    jcfg, jparams, cfg, tparams = _setup("llama3-8b", jnp.bfloat16)
    assert tparams["embed"].dtype == torch.bfloat16
    toks = _tokens((2, 16), cfg.vocab_size, seed=4)
    logits, _ = model.lm_apply(cfg, tparams, torch.from_numpy(toks))
    want, _ = jmodel.lm_apply(jcfg, jparams, jnp.asarray(toks))
    assert logits.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(logits.float().numpy(), want, rtol=0,
                               atol=0.05)
    agree = (logits.float().argmax(-1).numpy() == want.argmax(-1)).mean()
    assert agree >= 0.9


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_convert_carries_lm_params_and_cache_bitwise(dtype):
    """The LM's parameter tree (L-leading blocks) and its sliding-window
    cache (int32 ring tags) cross into the port and back unchanged; bf16
    leaves by their bits."""
    jcfg = jget_arch("llama3-8b-swa", smoke=True)
    jparams = jmodel.init_lm_params(jcfg, jax.random.PRNGKey(3), dtype)
    jcache = jmodel.init_lm_cache(jcfg, 2, 8, dtype)
    jcache = jax.tree.map(lambda a: a + jnp.ones_like(a), jcache)
    for tree in (jparams, jcache):
        np_tree = jax.tree.map(np.asarray, tree)
        port = params_from_numpy(np_tree, device="cpu")
        assert [t.shape for t in tree_leaves(port)] == [
            a.shape for a in jax.tree.leaves(np_tree)]
        back = params_to_numpy(port)
        assert jax.tree.structure(back) == jax.tree.structure(np_tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(
                a, np.asarray(b.astype(jnp.float32)) if b.dtype == jnp.bfloat16
                else np.asarray(b))
    assert port["attn"]["pos"].dtype == torch.int32
    assert params_from_numpy(jax.tree.map(np.asarray, jparams),
                             device="cpu")["embed"].dtype == (
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(name, smoke):
    jcfg, cfg = jget_arch(name, smoke=smoke), get_arch(name, smoke=smoke)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim
    assert cfg.param_count() == jcfg.param_count()
    if not smoke:
        assert cfg.param_count() == 8_030_257_152   # + 4,096 final norm


def test_init_lm_params_has_the_reference_tree():
    jcfg, jparams, cfg, _ = _setup("llama3-8b")
    mine = model.init_lm_params(cfg, seed=1, device="cpu")
    assert jax.tree.structure(params_to_numpy(mine)) == jax.tree.structure(
        jax.tree.map(np.asarray, jparams))
    for a, b in zip(tree_leaves(mine), jax.tree.leaves(jparams)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    assert sum(a.numel() for a in tree_leaves(mine)) == (
        cfg.param_count() + cfg.d_model)           # + final_norm
    again = model.init_lm_params(cfg, seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(mine),
                                                 tree_leaves(again)))


@pytest.mark.parametrize("field,value,what", [
    ("moe", object(), "Queue A 23"),
    ("mla", object(), "Queue A 23"),
    ("block_type", config.BLOCK_HYBRID, "Queue A 23"),
    ("modality", config.MODALITY_VISION, "Queue A 23"),
    ("modality", config.MODALITY_AUDIO, "Queue A 23"),
])
def test_unported_families_raise(field, value, what):
    with pytest.raises(NotImplementedError, match=what):
        dataclasses.replace(get_arch("llama3-8b", smoke=True),
                            **{field: value})


@pytest.mark.parametrize("fields", [
    {"ssm": config.SSMConfig()},
    {"ssm": config.SSMConfig(), "block_type": config.BLOCK_SSM},
])
def test_ssm_fields_are_accepted(fields):
    """Mamba2 is ported (ROADMAP Queue A 22): ``ssm=`` and
    ``block_type="ssm"`` no longer raise. As in the reference, ``ssm`` on
    an attention block is carried and unused."""
    cfg = dataclasses.replace(get_arch("llama3-8b", smoke=True), **fields)
    assert cfg.ssm == config.SSMConfig()
    assert cfg.is_attention_free == (cfg.block_type == config.BLOCK_SSM)
    assert "ssm" not in config.NOT_PORTED_LM
