"""The port's Hymba-style hybrid block against the JAX package's.

hymba-1.5b's smoke config (2 layers, d_model 256, attention 4 heads over
2 kv heads of 64 with a sliding window of 16, beside a Mamba2 branch of
8 heads of 64 with N = 16 and chunk 16): both branches read the same
normed input, each is RMS-normed on its own, and the block adds their
mean. Held against the reference on its own f32 weights at rtol 1e-4 /
atol 1e-5 (``test_torch_modalities.zoo_parity``) at S = 24 (the masked
attention path, the SSM padded to a chunk multiple) and S = 32 and 48
(S a multiple of the window and at least 2w: the banded path); each
forward goes through the banded or masked attention entry point and the
SSD scan once a layer, and through five norms a layer. The decode
carries both caches, the window's ring buffer with its position tags and
the SSM and conv states: 40 steps past the window match the reference's
step by step and end on the port's own full forward.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as jmodel  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention, mamba, model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from test_torch_modalities import TOL, smoke_pair, tokens, zoo_parity  # noqa: E402

NAME = "hymba-1.5b"


def _count(monkeypatch):
    calls = {"flash_attention_gqa": 0, "swa_attention": 0, "ssd_scan": 0,
             "rmsnorm": 0}
    for mod, name in ((attention.ops, "flash_attention_gqa"),
                      (attention.ops, "swa_attention"),
                      (mamba.ops, "ssd_scan"), (layers.ops, "rmsnorm")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("S,path", [(24, "flash_attention_gqa"),
                                    (32, "swa_attention"),
                                    (48, "swa_attention")])
def test_hybrid_model_matches_reference(S, path, monkeypatch):
    jcfg, cfg = smoke_pair(NAME)
    assert (cfg.block_type, cfg.attn_type) == ("hybrid", "sliding")
    calls = _count(monkeypatch)
    jparams, tparams = zoo_parity(jcfg, cfg, S=S, seed=S)
    # the forward's own calls (zoo_parity's decode steps run no kernel
    # but the norms): count one forward afresh
    for k in calls:
        calls[k] = 0
    model.lm_apply(cfg, tparams, torch.from_numpy(tokens(cfg, 2, S, 0)))
    L = cfg.num_layers
    assert calls[path] == calls["ssd_scan"] == L
    assert calls["flash_attention_gqa"] + calls["swa_attention"] == L
    # mix, the SSM branch's out_norm, the two branch norms, ffn; final
    assert calls["rmsnorm"] == 5 * L + 1


def test_hybrid_block_tree_and_cache():
    jcfg, cfg = smoke_pair(NAME)
    params = model.init_lm_params(cfg, seed=0, device="cpu")
    blocks = params["blocks"]
    assert set(blocks) == {"norm_mix", "attn", "ssm", "norm_attn_out",
                           "norm_ssm_out", "norm_ffn", "ffn"}
    cache = model.init_lm_cache(cfg, 2, 64, device="cpu")
    assert set(cache) == {"attn", "ssm"}
    assert tuple(cache["attn"]["k"].shape) == (2, 2, 16, 2, 64)  # the window
    H = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    assert tuple(cache["ssm"]["ssm"].shape) == (2, 2, H, 64, 16)
    jcache = jmodel.init_lm_cache(jcfg, 2, 64)
    assert jax.tree.map(np.shape, jcache) == {
        k: {n: tuple(t.shape) for n, t in v.items()} for k, v in cache.items()}


def test_ring_buffer_and_ssm_state_decode_past_the_window():
    """40 steps with a window of 16: every step's logits match the
    reference's, the ring tags and the SSM state too, and the last step
    is the port's own full forward's last position."""
    jcfg, cfg = smoke_pair(NAME)
    jparams = jmodel.init_lm_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    T = 40
    toks = tokens(cfg, 1, T, 3)
    cache = model.init_lm_cache(cfg, 1, max_seq=T, device="cpu")
    jcache = jmodel.init_lm_cache(jcfg, 1, max_seq=T)
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
    np.testing.assert_allclose(cache["ssm"]["ssm"].numpy(),
                               np.asarray(jcache["ssm"]["ssm"]), **TOL)
    full, _ = model.lm_apply(cfg, tparams, torch.from_numpy(toks))
    torch.testing.assert_close(logits, full[:, -1], **TOL)
