"""The arithmetic of the bf16 tensor-core attention program
(``src/repro_torch/kernels/csrc/attention_sm90.cu``), modelled in plain
PyTorch on the CPU and held against the JAX package.

The model repeats the kernel's loop: 128-row query tiles of two 64-row
halves (the two consumer warpgroups), each walking the same BK-key tiles
of the query tile's key range; scores as an f32 product of bf16 inputs,
scaled into log2 units inside the exponent (the kernel fuses that
multiply into the exponent's FMA, one rounding fewer); the online max
and rescale; the mask only on the
tiles the kernel masks (and an assertion that a skipped mask would have
kept every key); the probabilities split into p_hi = bf16(p) and
p_lo = bf16(p - p_hi), each multiplied by V and summed in f32; the
denominator summed from the f32 p. It lives here and not in the package:
``repro_torch.kernels.ref`` keeps the exact f32 plain version as the one
plain version.

Tolerance: the card checks' bf16 ``LM_TOL`` (``chip_smoke.py``,
``tests/test_torch_cuda.py``), rtol 2^-7 / atol 1e-5: two sides that keep
f32 statistics may land one bf16 step apart. One case shows why the split
is there: the same loop with p rounded once to bf16 breaks it.
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, flash_attention  # noqa: E402

LM_TOL = dict(rtol=2 ** -7, atol=1e-5)
BQ, HALF = 128, 64
BKS = (64, 128)           # key tiles modelled; the kernel's BK is one of them
LOG2E = 1.4426950408889634


def tile_model(q, k, v, *, causal, window, bk, split=True):
    """q (B, Sq, H, d), k/v (B, Sk, Hkv, d) bf16 -> (B, Sq, H, d) bf16,
    computed as the kernel's tile loop computes it."""
    B, Sq, H, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    sl2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, Sq, d)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    out = torch.zeros((B, H, Sq, d), dtype=torch.float32)
    q_off = Sk - Sq
    for q0 in range(0, Sq, BQ):
        # the key range of the whole 128-row tile, as the producer loads it
        q_last = min(q0 + BQ, Sq) - 1
        k_hi = min(Sk, q_off + q_last + 1) if causal else Sk
        k_lo = max(0, q_off + q0 - window + 1) if window > 0 else 0
        t_end = (k_hi + bk - 1) // bk if k_hi > 0 else 0
        for h0 in (q0, q0 + HALF):
            rows = torch.arange(h0, h0 + HALF)
            qpos = rows + q_off
            qh = torch.zeros((B, H, HALF, d))
            n = max(0, min(Sq, h0 + HALF) - h0)
            qh[:, :, :n] = qf[:, :, h0:h0 + n]      # rows >= Sq read zeros
            m = torch.full((B, H, HALF), -1e30)
            lsum = torch.zeros((B, H, HALF))
            o = torch.zeros((B, H, HALF, d))
            lo_pos, hi_pos = q_off + h0, q_off + h0 + HALF - 1
            for t in range(k_lo // bk, t_end):
                k0 = t * bk
                kpos = torch.arange(k0, k0 + bk)
                kt = torch.zeros((B, H, bk, d))
                vt = torch.zeros((B, H, bk, d))
                nk = max(0, min(Sk, k0 + bk) - k0)
                kt[:, :, :nk], vt[:, :, :nk] = (kf[:, :, k0:k0 + nk],
                                                vf[:, :, k0:k0 + nk])
                x = qh @ kt.transpose(-1, -2)
                keep = kpos[None, :] < Sk
                if causal:
                    keep = keep & (kpos[None, :] <= qpos[:, None])
                if window > 0:
                    keep = keep & (kpos[None, :] > qpos[:, None] - window)
                needs_mask = (k0 + bk > Sk or (causal and k0 + bk - 1 > lo_pos)
                              or (window > 0 and k0 <= hi_pos - window))
                if needs_mask:
                    x = torch.where(keep, x, -math.inf)
                else:
                    assert bool(keep.all()), "an interior tile masks a key"
                # scale > 0: the scaled max is the max of the scaled scores
                m_new = torch.maximum(m, x.amax(-1) * sl2)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(x * sl2 - m_new[..., None])
                lsum = lsum * alpha + p.sum(-1)
                hi = p.to(torch.bfloat16).float()
                pv = hi @ vt
                if split:
                    pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
                o = o * alpha[..., None] + pv
                m = m_new
            res = o / lsum.clamp_min(1e-30)[..., None]
            out[:, :, h0:h0 + n] = res[:, :, :n]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _inputs(B, Sq, Sk, H, Hkv, d, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, Sq, H, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d))]
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in arrs],
            [jnp.asarray(a, jnp.bfloat16) for a in arrs])


def _oracle(jq, jk, jv, *, causal, window):
    """``repro.kernels.ref.flash_attention_ref`` per (batch, head), query
    head h reading kv head h // (H // Hkv)."""
    B, Sq, H, d = jq.shape
    Sk, Hkv = jk.shape[1], jk.shape[2]
    G = H // Hkv
    qg = jq.transpose(0, 2, 1, 3).reshape(B * H, Sq, d)
    kg = jnp.repeat(jk.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, Sk, d)
    vg = jnp.repeat(jv.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, Sk, d)
    out = jref.flash_attention_ref(qg, kg, vg, causal=causal, window=window)
    return np.asarray(out.astype(jnp.float32)).reshape(
        B, H, Sq, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("bk", BKS)
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,d,causal,window,pallas", [
    (1, 100, 200, 4, 2, 64, True, 0, True),     # causal, ragged Sq < Sk
    (2, 160, 160, 4, 1, 32, True, 24, True),    # window 24
    (1, 256, 256, 4, 2, 128, True, 64, False),  # window = a 64-key tile
    (1, 256, 256, 4, 1, 128, True, 128, False),  # window = a 128-key tile
    (1, 70, 150, 4, 2, 32, False, 0, False),    # non-causal ragged Sk (C1)
    (1, 130, 130, 4, 1, 128, True, 0, False),   # d 128, Sq past one tile
])
def test_tile_loop_matches_the_reference(B, Sq, Sk, H, Hkv, d, causal,
                                         window, pallas, bk):
    (q, k, v), (jq, jk, jv) = _inputs(B, Sq, Sk, H, Hkv, d,
                                      Sq + Sk + d + window)
    got = tile_model(q, k, v, causal=causal, window=window, bk=bk)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(
        got, _oracle(jq, jk, jv, causal=causal, window=window), **LM_TOL)
    if pallas:
        # the GQA front end over the Pallas kernel (interpret mode); with
        # causal=False and a ragged Sk it lets padded keys in (ROADMAP C1)
        out = jops.flash_attention_gqa(jq, jk, jv, causal=causal,
                                       window=window, block_q=64, block_k=64)
        np.testing.assert_allclose(
            got, np.asarray(out.astype(jnp.float32)), **LM_TOL)


def test_rounding_p_once_breaks_the_tolerance():
    """Why P·V runs twice: with p rounded once to bf16 before the product
    the same loop misses LM_TOL at (1, 512, 4, 128) causal; with the
    split it holds."""
    (q, k, v), (jq, jk, jv) = _inputs(1, 512, 512, 4, 4, 128, 7)
    want = _oracle(jq, jk, jv, causal=True, window=0)
    once = tile_model(q, k, v, causal=True, window=0, bk=128, split=False)
    split = tile_model(q, k, v, causal=True, window=0, bk=128)
    tol = LM_TOL["atol"] + LM_TOL["rtol"] * np.abs(want)
    misses = int((np.abs(once.float().numpy() - want) > tol).sum())
    assert misses > 0
    assert int((np.abs(split.float().numpy() - want) > tol).sum()) == 0


def test_model_has_the_kernels_geometry():
    """The tiles modelled here are the ones the kernel source declares."""
    src = (_build.CSRC / "attention_sm90.cu").read_text()

    def const(pattern):
        return int(re.search(pattern, src).group(1))
    assert const(r"constexpr int kBQ = (\d+);") == BQ
    assert const(r"constexpr int kHalf = (\d+);") == HALF
    assert const(r"static constexpr int BK = (\d+);") in BKS


def test_dtype_picks_the_program():
    """bf16 runs the tensor-core program, f32 the CUDA-core one; both are
    entry points of the one attention library, each in its own source."""
    assert flash_attention.program(torch.bfloat16) == "sm90_wgmma_tma"
    assert flash_attention.program(torch.float32) == "cuda_core_f32"
    assert set(flash_attention.PROGRAMS) == {torch.bfloat16, torch.float32}
    assert _build.SOURCES["attention"] == ("attention.cu", "attention_sm90.cu")
    for (_, entry), src in zip(
            (flash_attention.PROGRAMS[t] for t in (torch.float32,
                                                   torch.bfloat16)),
            _build.SOURCES["attention"]):
        assert entry in _build.SIGNATURES["attention"]
        assert f'extern "C" int {entry}(' in (_build.CSRC / src).read_text()
