"""The port's multi-head latent attention (MLA, DeepSeek-V2) against the
JAX package's.

``mla_forward`` (the prefill: queries through the low-rank ``w_dq`` /
``w_uq`` or the full-rank ``w_q``, the latent ``c_kv`` and its up
projections, the rotary key shared by every head) and the absorbed
``mla_decode`` with its ``{ckv, krope}`` cache, on the reference's own
f32 weights, within rtol 1e-4 / atol 1e-5. The prefill sends
``q = [q_c | q_r]`` and ``k = [k_c | k_r]`` of width hd + rope_head_dim
(48 at the smoke size) against values of width hd (32) through
``ops.flash_attention_gqa`` once a layer; its plain version at those
widths, and at deepseek-v2's full (192, 128), is held to the reference's
``flash_attention_ref``. ``kernel_bound`` counts 2 (Dqk + Dv) flops a
kept pair. The deepseek-v2 smoke model end to end runs in
``test_torch_moe.py`` (it is an MoE config too); here it runs with
full-rank queries. ``repro_torch.convert`` carries the MLA weights and
cache both ways.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import MLAConfig as JMLAConfig  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.config import MLAConfig  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import flash_attention, ops, ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from test_torch_modalities import TOL, smoke_pair, zoo_parity  # noqa: E402


FULL_RANK = dict(kv_lora_rank=64, q_lora_rank=0, rope_head_dim=16)


def _full_rank_pair():
    """deepseek-v2's smoke config with full-rank queries (``w_q``)."""
    jcfg, cfg = smoke_pair("deepseek-v2-236b")
    return (dataclasses.replace(jcfg, mla=JMLAConfig(**FULL_RANK)),
            dataclasses.replace(cfg, mla=MLAConfig(**FULL_RANK)))


def _mla(q_lora=True, seed=0):
    jcfg, cfg = smoke_pair("deepseek-v2-236b") if q_lora else \
        _full_rank_pair()
    jp = jattn.attn_init(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("q_lora", [True, False])
@pytest.mark.parametrize("S", [1, 24, 70])
def test_mla_forward_matches_reference(q_lora, S, monkeypatch):
    jcfg, cfg, jp, tp = _mla(q_lora)
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    widths = []
    real = ops.flash_attention_gqa

    def counted(q, k, v, **kw):
        widths.append((q.shape[-1], k.shape[-1], v.shape[-1], kw["scale"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(attention.ops, "flash_attention_gqa", counted)
    got = attention.mla_forward(cfg, tp, torch.from_numpy(x),
                                torch.arange(S))
    want = jax.jit(lambda p, v: jattn.mla_forward(
        jcfg, p, v, jnp.arange(S)))(jp, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    hd, rh = cfg.resolved_head_dim, cfg.mla.rope_head_dim
    assert widths == [(hd + rh, hd + rh, hd, 1.0 / np.sqrt(hd + rh))]


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_decode_matches_reference_logits_and_cache(q_lora):
    jcfg, cfg, jp, tp = _mla(q_lora, seed=3)
    B, T, max_seq = 2, 10, 12
    xs = np.random.default_rng(1).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    jcache = jattn.attn_cache_init(jcfg, B, max_seq)
    cache = attention.attn_cache_init(cfg, B, max_seq)
    assert set(cache) == {"ckv", "krope"}
    jstep = jax.jit(lambda p, x, c, pos: jattn.mla_decode(jcfg, p, x, c, pos))
    for t in range(T):
        want, jcache = jstep(jp, jnp.asarray(xs[:, t:t + 1]), jcache,
                             jnp.int32(t))
        got, cache = attention.mla_decode(
            cfg, tp, torch.from_numpy(xs[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    # the prefill over the same inputs ends where the decode steps end
    full = attention.mla_forward(cfg, tp, torch.from_numpy(xs),
                                 torch.arange(T))
    torch.testing.assert_close(got[:, 0], full[:, -1], **TOL)
    with pytest.raises(ValueError, match="does not fit"):
        attention.mla_decode(cfg, tp, torch.from_numpy(xs[:, :1]), cache,
                             max_seq)


def test_deepseek_with_full_rank_queries_matches_reference():
    zoo_parity(*_full_rank_pair(), S=20, seed=2)


@pytest.mark.parametrize("d,dv,causal,Sq,Sk", [
    (48, 32, True, 40, 40), (192, 128, True, 33, 33),
    (48, 32, False, 24, 40), (192, 128, False, 17, 29)])
def test_plain_attention_takes_wider_queries_and_keys(d, dv, causal, Sq, Sk):
    """The plain version (the CPU's, and the card checks' yardstick) at
    Dqk != Dv against the JAX package's ``flash_attention_ref``, and its
    GQA front end over MLA's layout (as many kv heads as query heads)."""
    rng = np.random.default_rng(d + Sq)
    q = rng.standard_normal((3, Sq, d)).astype(np.float32)
    k = rng.standard_normal((3, Sk, d)).astype(np.float32)
    v = rng.standard_normal((3, Sk, dv)).astype(np.float32)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    g = ops.flash_attention_gqa(
        torch.from_numpy(q).reshape(1, 3, Sq, d).transpose(1, 2),
        torch.from_numpy(k).reshape(1, 3, Sk, d).transpose(1, 2),
        torch.from_numpy(v).reshape(1, 3, Sk, dv).transpose(1, 2),
        causal=causal)
    assert g.shape == (1, Sq, 3, dv)
    torch.testing.assert_close(g.transpose(1, 2).reshape(3, Sq, dv), got)


def test_programs_take_mla_widths():
    """Both programs are compiled for (192, 128), the f32 one also for the
    smoke size's (48, 32); each source's entry point dispatches on both
    widths."""
    W = flash_attention.WIDTHS
    assert (192, 128) in W[torch.bfloat16] and (192, 128) in W[torch.float32]
    assert (48, 32) in W[torch.float32]
    assert {(d, d) for d in flash_attention.HEAD_DIMS} <= W[torch.bfloat16]
    for dtype, src in ((torch.float32, "attention.cu"),
                       (torch.bfloat16, "attention_sm90.cu")):
        text = (flash_attention._build.CSRC / src).read_text()
        for dk, dv in W[dtype]:
            assert f"REPRO_ATTENTION_CASE({dk}, {dv})" in text


def test_kernel_bound_counts_both_widths():
    """Causal flops 2 (Dqk + Dv) a kept pair and head, bytes q, k, v and o
    at their own widths; at Dv = Dqk the old count."""
    B, S, H = 4, 2048, 128
    pairs = S * (S + 1) // 2
    nbytes, flops = roofline.attention_work(B, S, S, H, H, 192, True, 0, 2,
                                            dv=128)
    assert flops == 2 * (192 + 128) * pairs * B * H
    assert nbytes == 2 * (2 * B * S * H * (192 + 128))
    same = roofline.attention_work(B, S, S, 32, 8, 128, True, 0, 2)
    assert same[1] == 4 * 128 * pairs * B * 32
    b = roofline.kernel_bound("flash_attention", (B, S, S, H, H, 192, 128),
                              torch.bfloat16)
    assert b["ops"] == flops and b["bound_by"] == "operations"


def test_attention_bwd_bound_counts_each_product_at_its_width():
    """The backward's flops 2 (3 Dqk + 2 Dv) a kept pair and head (s, dk
    and dq over Dqk; dp and dv over Dv), three TF32 products each; at Dv
    = Dqk the old 5/2 of the forward's; bytes q, k, v, o, do, dq, dk, dv
    at their own widths and the log-sum-exp."""
    B, S, H = 1, 4096, 128
    pairs = S * (S + 1) // 2
    b = roofline.kernel_bound("attention_bwd", (B, S, S, H, H, (192, 128)))
    assert b["ops"] == 3 * 2 * (3 * 192 + 2 * 128) * pairs * B * H
    assert b["bytes"] == 4 * (2 * B * S * H * 2 * (192 + 128) + B * H * S)
    assert b["bound_by"] == "operations"
    assert 10.7 < b["bound_ms"] < 10.9      # ~10.8 ms on an H100 at 700 W
    fwd = roofline.kernel_work("flash_attention", (B, S, S, H, H, 128),
                               torch.float32)[1]
    same = roofline.kernel_bound("attention_bwd", (B, S, S, H, H, 128))
    assert same == roofline.kernel_bound("attention_bwd",
                                         (B, S, S, H, H, (128, 128)))
    assert same["ops"] == fwd * 5 // 2


def test_convert_carries_mla_weights_and_cache_both_ways():
    jcfg, cfg, jp, tp = _mla(seed=4)
    assert set(tp) == {"w_dkv", "w_krope", "w_uk", "w_uv", "w_o", "w_dq",
                       "w_uq"}
    mine = attention.attn_init(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in jp.items()}
    jcache = jax.tree.map(lambda a: a + 1.0,
                          jattn.attn_cache_init(jcfg, 2, 8, jnp.bfloat16))
    for tree in (jp, jcache):
        back = params_to_numpy(params_from_numpy(
            jax.tree.map(np.asarray, tree), device="cpu"))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, np.asarray(b.astype(
                jnp.float32)))
