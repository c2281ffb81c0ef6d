"""The port's Mamba2 model and serving path against the JAX package.

The mamba2-2.7b smoke config (2 layers, d_model 256, d_state 32, head
dim 64 so 8 heads, chunk 16, one group), with the reference's own f32
weights carried across by ``repro_torch.convert`` and the same numpy
tokens. On the CPU the port's SSD runs its plain version, the
sequential recurrence (which tests/test_torch_ssm_kernels.py holds
against the Pallas kernel), where the JAX model runs the chunked jnp
form ``_ssd_chunked``.

Tolerance for f32 outputs, logits, states and caches: rtol and atol
1e-4. Both sides compute in f32 but sum the products, the SSD (chunked
against sequential) and the norm statistics in other orders, through two
layers and the head. Greedy tokens and cache shapes must be identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jget_arch  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.config import BLOCK_SSM, SSMConfig, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.flatten import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import layers, mamba, model  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "mamba2-2.7b"
_CACHE = {}


def _setup(dtype=jnp.float32):
    """The reference's smoke config and weights, and the port's twins
    (built once per dtype; callers only read them)."""
    if dtype not in _CACHE:
        jcfg = jget_arch(ARCH, smoke=True)
        jparams = jmodel.init_lm_params(jcfg, jax.random.PRNGKey(0), dtype)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _CACHE[dtype] = (jcfg, jparams, get_arch(ARCH, smoke=True), tparams)
    return _CACHE[dtype]


def _layer0(tree):
    return tree["blocks"]["ssm"], 0


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.mark.parametrize("S", [16, 37, 48])
def test_mamba_forward_and_final_state_match_reference(S):
    """One SSM layer's forward (S = 37 is not a chunk multiple: the port's
    ops.ssd_scan pads, the reference's mamba_forward pads) and its final
    state from ``return_state``."""
    jcfg, jparams, cfg, tparams = _setup()
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["ssm"])
    tp = tree_map(lambda a: a[0], tparams["blocks"]["ssm"])
    x = _normal((2, S, cfg.d_model), seed=S)
    out, state = mamba.mamba_forward(cfg, tp, torch.from_numpy(x),
                                     return_state=True)
    want, want_state = jmamba.mamba_forward(jcfg, jp, jnp.asarray(x),
                                            return_state=True)
    assert out.shape == (2, S, cfg.d_model)
    assert state.shape == (2, 8, 64, 32) and state.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), **TOL)
    assert torch.equal(mamba.mamba_forward(cfg, tp, torch.from_numpy(x)),
                       out)


def test_mamba_decode_steps_match_reference_outputs_and_caches():
    """Eight one-token steps of one SSM layer: the outputs, the SSM state
    and the conv window against the reference's, step by step; the port
    updates its cache in place."""
    jcfg, jparams, cfg, tparams = _setup()
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["ssm"])
    tp = tree_map(lambda a: a[0], tparams["blocks"]["ssm"])
    jcache = jmamba.mamba_cache_init(jcfg, 3)
    cache = mamba.mamba_cache_init(cfg, 3)
    ssm_buf = cache["ssm"]
    x = _normal((3, 8, cfg.d_model), seed=1)
    for t in range(8):
        want, jcache = jmamba.mamba_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                           jcache)
        got, cache = mamba.mamba_decode(cfg, tp, torch.from_numpy(
            x[:, t:t + 1]), cache)
        assert got.shape == (3, 1, cfg.d_model)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in ("ssm", "conv"):
            assert cache[k].shape == jcache[k].shape
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), **TOL)
    assert cache["ssm"] is ssm_buf


def test_decode_after_prefill_continues_from_its_final_state():
    """The recurrence picks up where the chunked forward stops: the state
    after S steps of decode equals ``mamba_forward``'s final state."""
    _, _, cfg, tparams = _setup()
    tp = tree_map(lambda a: a[0], tparams["blocks"]["ssm"])
    x = torch.from_numpy(_normal((2, 21, cfg.d_model), seed=3))
    out, state = mamba.mamba_forward(cfg, tp, x, return_state=True)
    cache = mamba.mamba_cache_init(cfg, 2)
    for t in range(21):
        y, cache = mamba.mamba_decode(cfg, tp, x[:, t:t + 1], cache)
    torch.testing.assert_close(cache["ssm"], state, **TOL)
    torch.testing.assert_close(y[:, 0], out[:, -1], **TOL)


def _count_ssd(monkeypatch):
    calls = {"ssd_scan": 0}
    fn = mamba.ops.ssd_scan

    def counted(*a, **kw):
        calls["ssd_scan"] += 1
        return fn(*a, **kw)
    monkeypatch.setattr(mamba.ops, "ssd_scan", counted)
    return calls


@pytest.mark.parametrize("S", [20, 32])
def test_lm_apply_matches_reference(S, monkeypatch):
    jcfg, jparams, cfg, tparams = _setup()
    toks = _tokens((2, S), cfg.vocab_size, seed=S)
    calls = _count_ssd(monkeypatch)
    logits, aux = model.lm_apply(cfg, tparams, torch.from_numpy(toks))
    want, _ = jmodel.lm_apply(jcfg, jparams, jnp.asarray(toks))
    assert logits.shape == (2, S, cfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    assert calls["ssd_scan"] == cfg.num_layers


def test_make_prefill_matches_reference():
    jcfg, jparams, cfg, tparams = _setup()
    toks = _tokens((3, 19), cfg.vocab_size, seed=5)
    got = engine.make_prefill(cfg)(tparams, torch.from_numpy(toks))
    want = jax.jit(jengine.make_prefill(jcfg))(jparams, jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_steps_match_reference_logits_and_cache():
    jcfg, jparams, cfg, tparams = _setup()
    T, B = 12, 2
    toks = _tokens((B, T), cfg.vocab_size, seed=9)
    jcache = jmodel.init_lm_cache(jcfg, B, 16)
    cache = model.init_lm_cache(cfg, B, 16, device="cpu")
    jstep = jax.jit(jengine.make_decode_step(jcfg))
    step = engine.make_decode_step(cfg)
    for t in range(T):
        want, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t]),
                             jnp.int32(t))
        got, cache = step(tparams, cache, torch.from_numpy(toks[:, t]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jleaves = jax.tree.leaves(jcache)
    leaves = tree_leaves(cache)
    assert len(leaves) == len(jleaves) == 2
    for a, b in zip(leaves, jleaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_cache_tree_matches_reference(dtype):
    """The SSM state (L, B, H, P, N) in f32 and the conv window
    (L, B, d_conv - 1, C) in the model's dtype; ``max_seq`` is unused."""
    jcfg, _, cfg, _ = _setup()
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    jcache = jmodel.init_lm_cache(jcfg, 3, 7, dtype)
    cache = model.init_lm_cache(cfg, 3, 7, tdt, device="cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jcache)) == \
        jax.tree.structure(params_to_numpy(cache))
    assert cache["ssm"]["ssm"].shape == (2, 3, 8, 64, 32)
    assert cache["ssm"]["ssm"].dtype == torch.float32
    assert cache["ssm"]["conv"].shape == (2, 3, 3, 512 + 2 * 32)
    assert cache["ssm"]["conv"].dtype == tdt
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
        assert tuple(a.shape) == b.shape
    assert tree_leaves(model.init_lm_cache(cfg, 3, 100, device="cpu"))[0] \
        .shape == cache["ssm"]["conv"].shape


def test_serve_engine_greedy_tokens_match_reference():
    jcfg, jparams, cfg, tparams = _setup()
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
    """The engine's logits after the prompt (the O(1) recurrence) against
    the prefill's last position (the SSD over the whole prompt). The
    state is O(1), so ``max_seq`` does not bound the engine."""
    _, _, cfg, tparams = _setup()
    prompt = torch.from_numpy(_tokens((2, 23), cfg.vocab_size, seed=2))
    eng = engine.ServeEngine(cfg, tparams, max_seq=4, batch=2, device="cpu")
    logits = eng.feed(prompt)
    full = engine.make_prefill(cfg)(tparams, prompt)
    torch.testing.assert_close(logits, full[:, -1], **TOL)
    assert eng.pos == 23


def test_bf16_forward_follows_the_reference():
    """bf16 weights and activations. Both sides run the SSD in f32 from
    the same bf16 inputs, but bf16 products and elementwise ops round
    differently in XLA and PyTorch, so the logits agree only to bf16
    precision through the two layers (atol 0.05 on logits of size ~1),
    and most greedy picks agree."""
    jcfg, jparams, cfg, tparams = _setup(jnp.bfloat16)
    assert tparams["blocks"]["ssm"]["A_log"].dtype == torch.bfloat16
    toks = _tokens((2, 24), cfg.vocab_size, seed=4)
    logits, _ = model.lm_apply(cfg, tparams, torch.from_numpy(toks))
    want, _ = jmodel.lm_apply(jcfg, jparams, jnp.asarray(toks))
    assert logits.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(logits.float().numpy(), want, rtol=0,
                               atol=0.05)
    agree = (logits.float().argmax(-1).numpy() == want.argmax(-1)).mean()
    assert agree >= 0.9


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("width,L,seed", [
    ("smoke", 2, 0), ("smoke", 16, 0), ("smoke", 64, 0), ("smoke", 64, 1),
    ("smoke", 64, 2), ("full", 4, 0)])
def test_bf16_prompt_gap_tracks_the_reference(width, L, seed):
    """In bf16 the engine's logits after a 32-token prompt (the O(1)
    recurrence) and the prefill's at that position (the SSD over the
    prompt) round differently, and random weights amplify that with
    depth. The reference's own gap, on the same weights, is the yardstick
    for the port's (``chip_smoke.py``'s ``SSM_SERVE_REL_TOL`` rests on the
    64-layer cases, three draws of weights and tokens): the port's may be
    no larger. "full" is mamba2-2.7b's
    width (d_model 2560, 80 heads, state 128, chunk 64) with its vocabulary
    cut to the smoke config's 512. Run with ``-s`` to print both gaps and
    each bf16 prefill's distance from the reference's f32 logits."""
    base = dict(num_layers=L) if width == "smoke" else dict(num_layers=L,
                                                             vocab_size=512)
    jcfg = dataclasses.replace(jget_arch(ARCH, smoke=width == "smoke"),
                               **base)
    cfg = dataclasses.replace(get_arch(ARCH, smoke=width == "smoke"), **base)
    jparams = jmodel.init_lm_params(jcfg, jax.random.PRNGKey(seed),
                                    jnp.bfloat16)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    B, S = 2, 32
    toks = _tokens((B, S), cfg.vocab_size, seed=seed)
    jprefill = jmodel.lm_apply(jcfg, jparams, jnp.asarray(toks))[0][:, -1]
    jeng = jengine.ServeEngine(jcfg, jparams, max_seq=S, batch=B,
                               dtype=jnp.bfloat16)
    jfeed = jeng.feed(jnp.asarray(toks))
    want32 = jmodel.lm_apply(jcfg, jax.tree.map(
        lambda a: a.astype(jnp.float32), jparams), jnp.asarray(toks))[0][:, -1]
    tt = torch.from_numpy(toks).long()
    prefill = engine.make_prefill(cfg)(tparams, tt)[:, -1].float()
    eng = engine.ServeEngine(cfg, tparams, max_seq=S, batch=B,
                             dtype=torch.bfloat16, device="cpu")
    feed = eng.feed(tt).float()
    ref_gap = _rel(jfeed.astype(jnp.float32), jprefill.astype(jnp.float32))
    port_gap = _rel(feed.numpy(), prefill.numpy())
    print(f"\nbf16 prompt gap, {width} width, {L} layers, seed {seed}: "
          f"reference "
          f"{ref_gap:.4f}, port {port_gap:.4f}; prefill vs f32: reference "
          f"{_rel(jprefill.astype(jnp.float32), want32):.4f}, port "
          f"{_rel(prefill.numpy(), want32):.4f}")
    assert np.isfinite(feed.numpy()).all()
    assert port_gap <= ref_gap


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    jcfg, cfg = jget_arch(ARCH, smoke=smoke), get_arch(ARCH, smoke=smoke)
    for f in dataclasses.fields(cfg):
        mine, ref = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "ssm":          # a dataclass of each package
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        else:
            assert mine == ref, f.name
    assert cfg.is_attention_free and jcfg.is_attention_free
    assert cfg.param_count() == jcfg.param_count()
    if not smoke:
        assert cfg.param_count() == 2_830_780_416


def test_init_lm_params_has_the_reference_tree():
    """The reference's tree and shapes; the tree holds
    L * (H + d_inner - d) + d weights more than ``param_count()``; the
    deterministic leaves are the reference's (``A_log`` within two ulps:
    XLA's and PyTorch's log and linspace round differently)."""
    jcfg, jparams, cfg, _ = _setup()
    mine = model.init_lm_params(cfg, seed=1, device="cpu")
    assert jax.tree.structure(params_to_numpy(mine)) == jax.tree.structure(
        jax.tree.map(np.asarray, jparams))
    for a, b in zip(tree_leaves(mine), jax.tree.leaves(jparams)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    L, d, H, d_inner = cfg.num_layers, cfg.d_model, 8, 512
    assert sum(a.numel() for a in tree_leaves(mine)) == (
        cfg.param_count() + L * (H + d_inner - d) + d)
    ssm, jssm = mine["blocks"]["ssm"], jparams["blocks"]["ssm"]
    np.testing.assert_allclose(ssm["A_log"].numpy(), np.asarray(jssm["A_log"]),
                               rtol=3e-7, atol=0)
    for k in ("D", "dt_bias"):
        np.testing.assert_array_equal(ssm[k].numpy(), np.asarray(jssm[k]))
    assert abs(float(ssm["conv_w"].std()) - 0.1) < 0.01
    again = model.init_lm_params(cfg, seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(mine),
                                                 tree_leaves(again)))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_convert_carries_ssm_params_and_cache_bitwise(dtype):
    jcfg = jget_arch(ARCH, smoke=True)
    jparams = jmodel.init_lm_params(jcfg, jax.random.PRNGKey(3), dtype)
    jcache = jax.tree.map(lambda a: a + jnp.ones_like(a),
                          jmodel.init_lm_cache(jcfg, 2, 8, dtype))
    for tree in (jparams, jcache):
        np_tree = jax.tree.map(np.asarray, tree)
        port = params_from_numpy(np_tree, device="cpu")
        assert [tuple(t.shape) for t in tree_leaves(port)] == [
            a.shape for a in jax.tree.leaves(np_tree)]
        back = params_to_numpy(port)
        assert jax.tree.structure(back) == jax.tree.structure(np_tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, np.asarray(b.astype(jnp.float32)))
    assert port["ssm"]["ssm"].dtype == torch.float32
    assert port["ssm"]["conv"].dtype == (
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 5, 33])
def test_causal_conv1d_matches_reference(S, dtype):
    """The K = 4 loop of multiply-adds in x's dtype, as the reference's:
    exact in f32, within one bf16 step in bf16."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x, w = _normal((2, S, 24), seed=S), _normal((4, 24), seed=100) * 0.1
    got = layers.causal_conv1d(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(w).to(tdt))
    want = jlayers.causal_conv1d(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    assert got.dtype == tdt and got.shape == (2, S, 24)
    tol = dict(rtol=2 ** -7, atol=1e-6) if dtype == "bfloat16" else dict(
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_causal_conv1d_update_steps_through_the_full_conv():
    """Decode steps of the conv, one position at a time, against the
    reference's update and against the full causal conv; the window
    keeps the last K - 1 inputs."""
    x, w = _normal((2, 9, 16), seed=7), _normal((4, 16), seed=8) * 0.1
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    state, jstate = torch.zeros(2, 3, 16), jnp.zeros((2, 3, 16))
    full = layers.causal_conv1d(tx, tw)
    for t in range(9):
        y, state = layers.causal_conv1d_update(state, tx[:, t], tw)
        jy, jstate = jlayers.causal_conv1d_update(jstate, jnp.asarray(x[:, t]),
                                                  jnp.asarray(w))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate))
        torch.testing.assert_close(y, full[:, t], rtol=0, atol=0)
    np.testing.assert_array_equal(state.numpy(), x[:, -3:])


def test_ssm_config_validation():
    base = get_arch(ARCH, smoke=True)
    with pytest.raises(ValueError, match="needs ssm="):
        dataclasses.replace(base, ssm=None)
    with pytest.raises(TypeError, match="SSMConfig"):
        dataclasses.replace(base, ssm=object())
    assert dataclasses.replace(base, ssm=SSMConfig()).block_type == BLOCK_SSM
