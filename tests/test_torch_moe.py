"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against
the JAX package's.

``moe_apply`` on the reference's own f32 weights and the same numpy
inputs: the output and the Switch auxiliary loss within rtol 1e-4 /
atol 1e-5, at the smoke configs' capacity factor 8 (nothing dropped) and
at the default 1.25, where tokens are dropped: there the kept
(token, k) set and the experts picked are identical to the reference's
routing (lines 79-94 of ``repro/models/moe.py``, repeated here in jnp),
and so is the order in which each expert's bucket fills. An all-zero
router (every probability equal) picks experts 0..K-1, as
``jax.lax.top_k`` does. ``repro_torch.convert`` carries the stacked
(E, d, f) expert weights both ways. The two MoE configs end to end are
in ``test_torch_moe_model.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.config import MoEConfig  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import model, moe  # noqa: E402
from test_torch_modalities import TOL, smoke_pair  # noqa: E402


def _moe_inputs(name, B, S, seed=0, **moe_fields):
    jcfg, cfg = smoke_pair(name, moe=moe_fields) if moe_fields else \
        smoke_pair(name)
    jp = jmoe.moe_init(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    # a direction every token shares tilts the router the same way for all,
    # so the busiest experts overflow at capacity factor 1.25
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((B, S, cfg.d_model)) + 2.0 * rng.standard_normal(
        cfg.d_model)
    return jcfg, cfg, jp, tp, x.astype(np.float32)


def _reference_route(jcfg, jp, x):
    """The reference's routing (moe.py:79-94) on x (B, S, D): the
    experts picked and which (token, k) pairs are kept, per group."""
    m = jcfg.moe
    B, S, D = x.shape
    g = min(S, jmoe.MOE_GROUP_TOKENS)
    xt = jnp.asarray(x).reshape(-1, g, D)
    logits = jnp.einsum("gtd,de->gte", xt, jp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, m.num_experts_per_tok)
    onehot = jax.nn.one_hot(idx, m.num_experts, dtype=jnp.float32)
    flat = onehot.reshape(xt.shape[0], g * m.num_experts_per_tok,
                          m.num_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat, axis=-1)
    pos = pos.reshape(idx.shape)
    keep = pos < jmoe.group_capacity(m, g)
    return np.asarray(idx), np.asarray(keep), np.asarray(pos).astype(int)


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v2-236b"])
@pytest.mark.parametrize("cf,S", [(8.0, 24), (1.25, 64), (1.25, 48)])
def test_moe_apply_matches_reference(name, cf, S):
    jcfg, cfg, jp, tp, x = _moe_inputs(name, 2, S, capacity_factor=cf)
    want, jaux = jax.jit(lambda p, v: jmoe.moe_apply(jcfg, p, v))(
        jp, jnp.asarray(x))
    got, aux, _ = moe.moe_apply(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert aux.dtype == torch.float32
    # the routing: experts, kept set and bucket slots exact
    idx, keep, pos = _reference_route(jcfg, jp, x)
    r = moe.moe_route(cfg, tp, torch.from_numpy(x).reshape(idx.shape[0], -1,
                                                           cfg.d_model))
    np.testing.assert_array_equal(r["gate_idx"].numpy(), idx)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    np.testing.assert_array_equal(r["slot"].numpy(), pos)
    assert r["capacity"] == jmoe.group_capacity(jcfg.moe, min(S, 1024))
    if cf == 1.25:
        assert not keep.all()          # the case drops (token, k) pairs
    else:
        assert keep.all()


def test_all_equal_probabilities_pick_the_lowest_experts():
    """An all-zero router makes every probability 1/E: both packages pick
    experts 0..K-1 for every token (``lax.top_k``'s tie order), with
    equal gates, and drop the same pairs past capacity."""
    jcfg, cfg, jp, tp, x = _moe_inputs("deepseek-v2-236b", 2, 32,
                                       capacity_factor=1.25)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    K = cfg.moe.num_experts_per_tok
    xt = torch.from_numpy(x).reshape(2, 32, cfg.d_model)
    r = moe.moe_route(cfg, tp, xt)
    assert (r["gate_idx"] == torch.arange(K)).all()
    idx, keep, _ = _reference_route(jcfg, jp, x)
    np.testing.assert_array_equal(idx, r["gate_idx"].numpy())
    np.testing.assert_array_equal(keep, r["keep"].numpy())
    assert int(r["keep"].sum()) == 2 * K * moe.group_capacity(cfg.moe, 32)
    want, _ = jax.jit(lambda p, v: jmoe.moe_apply(jcfg, p, v))(
        jp, jnp.asarray(x))
    got, _, _ = moe.moe_apply(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cf,g,K,E,want", [
    (1.25, 1024, 2, 8, 320), (1.25, 1024, 6, 160, 48), (1.25, 1, 6, 160, 4),
    (8.0, 24, 2, 4, 96), (1.25, 24, 2, 4, 15), (1.25, 7, 1, 8, 4)])
def test_group_capacity_truncates_with_a_floor_of_four(cf, g, K, E, want):
    m = MoEConfig(capacity_factor=cf, num_experts_per_tok=K, num_experts=E)
    assert moe.group_capacity(m, g) == want == jmoe.group_capacity(m, g)


def test_moe_rejects_ragged_groups():
    _, cfg, _, tp, _ = _moe_inputs("mixtral-8x22b", 1, 8)
    x = torch.zeros((3, 1100, cfg.d_model))     # 3300 tokens, groups of 1024
    with pytest.raises(ValueError, match="groups of 1024"):
        moe.moe_apply(cfg, tp, x)


def test_routing_log_keeps_each_calls_kept_set():
    _, cfg, _, tp, x = _moe_inputs("mixtral-8x22b", 2, 64,
                                   capacity_factor=1.25)
    _, _, keep = moe.moe_apply(cfg, tp, torch.from_numpy(x))
    assert keep.shape == (2, 64, cfg.moe.num_experts_per_tok)
    assert 0 < int(keep.sum()) < keep.numel()
    r = moe.moe_route(cfg, tp, torch.from_numpy(x))
    assert torch.equal(keep, r["keep"])


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_lm_forward_returns_each_layers_kept_set(name):
    """``lm_forward`` is ``lm_apply`` with one kept (token, k) mask a MoE
    layer, in layer order; at capacity factor 1.25 some pairs drop."""
    _, cfg = smoke_pair(name, moe={"capacity_factor": 1.25})
    params = model.init_lm_params(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 64)))
    logits, aux, keeps = model.lm_forward(cfg, params, toks)
    want, want_aux = model.lm_apply(cfg, params, toks)
    assert torch.equal(logits, want) and torch.equal(aux, want_aux)
    assert len(keeps) == cfg.num_layers
    for keep in keeps:
        assert keep.dtype == torch.bool
        assert keep.shape == (2, 64, cfg.moe.num_experts_per_tok)
    assert not all(bool(k.all()) for k in keeps)


def test_convert_carries_stacked_experts_both_ways():
    jcfg, _ = smoke_pair("deepseek-v2-236b")
    jp = jmoe.moe_init(jcfg, jax.random.PRNGKey(4), jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    E, d = jcfg.moe.num_experts, jcfg.d_model
    assert tuple(tp["w_gate"].shape) == (E, d, jcfg.moe.expert_d_ff)
    assert tuple(tp["w_down"].shape) == (E, jcfg.moe.expert_d_ff, d)
    assert tp["w_up"].dtype == torch.bfloat16
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b.astype(jnp.float32)))
