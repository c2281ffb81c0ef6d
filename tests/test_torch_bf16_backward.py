"""The bf16 backward kernels' arithmetic and their autograd routes, on the
CPU, against the JAX package.

* ``attention_bwd`` in bf16 (``csrc/attention_bwd_bf16.cu``), modelled
  in plain PyTorch as its passes walk the tiles: delta; the dk/dv pass,
  blocks of 128 keys of one kv head (two warpgroups of 64) walking the
  group's query heads in head order and, for each, the query tiles of BQ
  rows (64, 32 at MLA's (192, 128)) of the range the kernel bounds, dK
  and dV summed over the whole group in one accumulator; the dq pass,
  blocks of 128 query rows (two warpgroups of 64) walking the key tiles
  (128 keys at (128, 128), else 64) of the forward's range. Every product one bf16 product with f32
  sums: S^T and dP^T (S and dP) from the bf16 inputs; P and dS rounded
  to bf16 once, to nearest even, as the A operand of dV, dK and dQ, whose
  running sums take each 16-wide k-step's product in turn (a wgmma
  chain's order); dq, dk and dv rounded to bf16 once, dk and dq scaled.
  The per-warpgroup shortcuts are checked on every tile and every kept
  (query, key, head) triple is visited once per pass. Held against
  ``jax.vjp`` of the reference's bf16 attention
  (``repro.models.attention._sdpa``, which rounds the scores and the
  probabilities to bf16): dq, dk and dv within ``BF16_REF_FACTOR`` times
  the reference's own gap, its bf16 gradient against its f32 gradient at
  the same (bf16) inputs, each gradient's max |diff| over its max. Cases:
  ragged S, GQA groups 1 and 4, head widths 32, 64 and 128, a window,
  non-causal with Sk != Sq, a right-aligned diagonal, MLA's (192, 128).
* ``rmsnorm_bwd`` in bf16: the kernel's arithmetic in its bf16 form
  (``test_torch_backward_tiles.rmsnorm_bwd_model``: each row's scalar
  head, 16-byte vectors and scalar tail, as ``bwd_plan`` partitions them)
  on the bf16 values, dx and dscale rounded to bf16 once, against
  ``jax.vjp`` of the reference's norm
  (``repro.models.layers.rmsnorm_apply``, f32 inside, the result cast) in
  bf16: within one bf16 step of each gradient's max.
* The routes, with stand-in launches (the plain versions) that refuse
  wrapped tensors and count their calls (``test_torch_ssd_bwd.StandIns``)
  and ``ops`` taking the card's routes: a bf16 block through
  ``ops.rmsnorm``, ``ops.flash_attention_gqa``, the banded
  ``ops.swa_attention`` and ``ops.ssd_scan`` under ``torch.func.grad``,
  ``loss.backward()`` and the learners' ``vmap``: the gradients in the
  inputs' dtypes, equal to the plain route's, one forward and one
  backward call per op whatever m; the attention and norm backward
  stand-ins receive bf16, the SSD's f32 (its route upcasts).
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import _sdpa  # noqa: E402
from repro.models.layers import rmsnorm_apply  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from test_torch_backward_tiles import (  # noqa: E402
    LOG2E, SMEM, _fma_f32, _kept, _rows, _warps, rmsnorm_bwd_model,
)
from test_torch_ssd_bwd import StandIns, _kernel_route  # noqa: E402

# the model's gap to the reference's bf16 gradient, at most this many
# times the reference's own bf16-vs-f32 gap (as chip_smoke.py holds the
# kernel to twice SDPA's)
BF16_REF_FACTOR = 2.0
BF16 = torch.bfloat16


def _bf16(x):
    """A float32 tensor rounded to bf16 and back (to nearest even)."""
    return x.to(BF16).float()


# the kernel's geometry: keys a dk/dv block, query rows a dq block, rows a
# consumer warpgroup (wgmma's M), the two rings' stages, and the k-step of
# a bf16 wgmma
KV_KEYS, Q_ROWS, HALF = 128, 128, 64
KV_STAGES, Q_STAGES, KSTEP = 3, 2, 16


def _bq(d, dv):
    """The dk/dv pass's query tile: 64 rows at equal widths, 32 at (192,
    128), where dK and dV take 160 of a consumer's registers."""
    return 64 if d + dv <= 256 else 32


def _bk(d, dv):
    """The dq pass's key tile: 128 keys at (128, 128), else 64."""
    return 128 if (d, dv) == (128, 128) else 64


def _smem(d, dv):
    """Each pass's shared-memory bytes (tiles, lse and delta rows,
    barriers, and 1,024 to align the first tile)."""
    bq, bk = _bq(d, dv), _bk(d, dv)
    kv = (2 * KV_KEYS * (d + dv) + KV_STAGES * 2 * bq * (d + dv)
          + KV_STAGES * 2 * bq * 4 + 8 * (1 + 2 * KV_STAGES) + 1024)
    q = (2 * Q_ROWS * (d + dv) + Q_STAGES * 2 * bk * (d + dv)
         + 8 * (1 + 2 * Q_STAGES) + 1024)
    return kv, q


def _chain(acc, a, b):
    """acc + a @ b as a wgmma chain sums it into its accumulator: one
    16-wide k-step's product at a time (each an f32 sum of exact bf16
    products)."""
    for k0 in range(0, a.shape[-1], KSTEP):
        acc = acc + a[..., k0:k0 + KSTEP] @ b[..., k0:k0 + KSTEP, :]
    return acc


def attention_bwd_bf16_model(q, k, v, o, lse, do, causal, window):
    """The kernel's passes on bf16 tensors q (B, Sq, H, d), k (B, Sk, Hkv,
    d), v (B, Sk, Hkv, dv), o and do (B, Sq, H, dv) and the f32 lse:
    (dq, dk, dv) in bf16 and the visits of each pass, (B, H, Sq, Sk)
    counts of the pairs it computed that the mask keeps."""
    B, Sq, H, d = q.shape
    Sk, Hkv, dw = k.shape[1], k.shape[2], v.shape[3]
    BQ, BK = _bq(d, dw), _bk(d, dw)
    G, off = H // Hkv, Sk - Sq
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    sl2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    qf, of, dof = (x.float().permute(0, 2, 1, 3) for x in (q, o, do))
    kg, vg = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # kv heads
    delta = (dof * of).sum(-1)                                 # (B, H, Sq)
    lse2 = torch.where(torch.isinf(lse), torch.tensor(math.inf),
                       lse * torch.tensor(LOG2E, dtype=torch.float32))
    seen_kv = torch.zeros((B, H, Sq, Sk), dtype=torch.int32)
    seen_q = torch.zeros_like(seen_kv)

    def head(x, hh):
        """Query head hh of every kv head's group: (B, Hkv, ...)."""
        return x.reshape(B, Hkv, G, *x.shape[2:])[:, :, hh]

    # dk, dv: blocks of KV_KEYS keys of one kv head, the group's query
    # heads in order, one accumulator over all of them
    dk = torch.zeros((B, Hkv, Sk, d), dtype=BF16)
    dv = torch.zeros((B, Hkv, Sk, dw), dtype=BF16)
    for k0 in range(0, Sk, KV_KEYS):
        i_lo = max(0, k0 - off) if causal else 0
        i_hi = (min(Sq, k0 + KV_KEYS - 1 + window - off) if window > 0
                else Sq)
        t_lo = i_lo // BQ
        n_t = -(-i_hi // BQ) - t_lo if i_hi > i_lo else 0
        nk = min(KV_KEYS, Sk - k0)
        kpos = torch.arange(k0, k0 + KV_KEYS)[:, None]
        kt, vt = _rows(kg, k0, KV_KEYS, Sk), _rows(vg, k0, KV_KEYS, Sk)
        acc_k = torch.zeros((B, Hkv, KV_KEYS, d))
        acc_v = torch.zeros((B, Hkv, KV_KEYS, dw))
        for hh in range(G):
            for t in range(t_lo, t_lo + n_t):
                q0 = t * BQ
                qt = _rows(head(qf, hh), q0, BQ, Sq)
                dot = _rows(head(dof, hh), q0, BQ, Sq)
                l2 = _rows(head(lse2, hh)[..., None], q0, BQ, Sq,
                           math.inf)[..., 0]
                dl = _rows(head(delta, hh)[..., None], q0, BQ, Sq)[..., 0]
                lo, hi = q0 + off, q0 + off + BQ - 1
                keep = _kept(torch.arange(lo, hi + 1)[None, :], kpos, Sk,
                             causal, window)
                active = _warps(
                    keep, nk, range(k0, k0 + KV_KEYS, HALF),
                    lambda r: r >= Sk or (causal and r > hi) or (
                        window > 0 and r + HALF - 1 <= lo - window),
                    lambda r: r + HALF - 1 >= Sk or (
                        causal and r + HALF - 1 > lo) or (
                        window > 0 and r <= hi - window), rows=HALF)
                on = keep & active[:, None]
                st = kt @ qt.transpose(-1, -2)
                dpt = vt @ dot.transpose(-1, -2)
                p = torch.exp2(_fma_f32(st, sl2, -l2[..., None, :]))
                p = torch.where(on, p, torch.zeros(()))
                ds = p * (dpt - dl[..., None, :])
                acc_v = _chain(acc_v, _bf16(p), dot)
                acc_k = _chain(acc_k, _bf16(ds), qt)
                nq = min(BQ, Sq - q0)
                head(seen_kv, hh)[:, :, q0:q0 + nq, k0:k0 + nk] += \
                    on[:nk, :nq].T.int()
        dk[:, :, k0:k0 + nk] = (acc_k[:, :, :nk] * scale).to(BF16)
        dv[:, :, k0:k0 + nk] = acc_v[:, :, :nk].to(BF16)

    # dq: blocks of Q_ROWS query rows walking tiles of BK keys
    kf, vf = (x.repeat_interleave(G, dim=1) for x in (kg, vg))
    dq = torch.zeros((B, H, Sq, d), dtype=BF16)
    for q0 in range(0, Sq, Q_ROWS):
        q_last = min(q0 + Q_ROWS, Sq) - 1
        k_hi = min(Sk, off + q_last + 1) if causal else Sk
        k_lo = max(0, off + q0 - window + 1) if window > 0 else 0
        t_lo = k_lo // BK
        n_t = max(0, (-(-k_hi // BK) if k_hi > 0 else 0) - t_lo)
        nq = min(Q_ROWS, Sq - q0)
        qt, dot = _rows(qf, q0, Q_ROWS, Sq), _rows(dof, q0, Q_ROWS, Sq)
        l2 = _rows(lse2[..., None], q0, Q_ROWS, Sq, math.inf)
        dl = _rows(delta[..., None], q0, Q_ROWS, Sq)
        qpos = torch.arange(q0, q0 + Q_ROWS)[:, None] + off
        acc = torch.zeros((B, H, Q_ROWS, d))
        for t in range(t_lo, t_lo + n_t):
            k0 = t * BK
            kt, vt = _rows(kf, k0, BK, Sk), _rows(vf, k0, BK, Sk)
            keep = _kept(qpos, torch.arange(k0, k0 + BK)[None, :], Sk,
                         causal, window)
            active = _warps(
                keep, nq, range(q0, q0 + Q_ROWS, HALF),
                lambda r: r >= Sq or (
                    causal and k0 > r + off + HALF - 1) or (
                    window > 0 and k0 + BK - 1 <= r + off - window),
                lambda r: k0 + BK > Sk or (
                    causal and k0 + BK - 1 > r + off) or (
                    window > 0 and k0 <= r + off + HALF - 1 - window),
                rows=HALF)
            on = keep & active[:, None]
            s_, dp = qt @ kt.transpose(-1, -2), dot @ vt.transpose(-1, -2)
            p = torch.where(on, torch.exp2(_fma_f32(s_, sl2, -l2)),
                            torch.zeros(()))
            acc = _chain(acc, _bf16(p * (dp - dl)), kt)
            nk = min(BK, Sk - k0)
            seen_q[:, :, q0:q0 + nq, k0:k0 + nk] += on[:nq, :nk].int()
        dq[:, :, q0:q0 + nq] = (acc[:, :, :nq] * scale).to(BF16)
    grads = (dq.permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3),
             dv.permute(0, 2, 1, 3))
    return grads, (seen_kv, seen_q)


BF16_CASES = [  # B, Sq, Sk, H, Hkv, d, dv, causal, window
    (2, 100, 100, 4, 4, 64, 64, True, 0),      # ragged S, group 1
    (1, 130, 130, 8, 2, 128, 128, True, 0),    # ragged past a block, group 4
    (1, 150, 150, 4, 1, 64, 64, True, 40),     # a window, group 4
    (2, 70, 100, 2, 2, 32, 32, False, 0),      # non-causal, Sk != Sq
    (1, 90, 200, 4, 1, 128, 128, True, 0),     # right-aligned diagonal
    (1, 100, 100, 2, 2, 192, 128, True, 0),    # deepseek-v2's MLA widths
    (2, 70, 100, 2, 2, 192, 128, False, 0),    # MLA, ragged non-causal
]


def _ref_attention(q, k, v, causal, window):
    """The reference's training attention (``_sdpa``) on the GQA layout,
    the port's masks (causal diagonal right-aligned)."""
    B, Sq, H, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qpos = jnp.arange(Sq)[:, None] + (Sk - Sq)
    kpos = jnp.arange(Sk)[None, :]
    mask = jnp.ones((Sq, Sk), bool)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    out = _sdpa(q.reshape(B, Sq, Hkv, H // Hkv, d), k, v, mask,
                1.0 / math.sqrt(d))
    return out.reshape(B, Sq, H, v.shape[-1])


def _gaps(got, want):
    got = [np.asarray(g, np.float32) for g in got]
    want = [np.asarray(w, np.float32) for w in want]
    return [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("case", BF16_CASES)
def test_attention_bwd_bf16_model_within_the_references_bf16_noise(case):
    B, Sq, Sk, H, Hkv, d, dv, causal, window = case
    rng = np.random.default_rng(sum(case[:7]))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(BF16) for s in ((B, Sq, H, d), (B, Sk, Hkv, d),
                                        (B, Sk, Hkv, dv), (B, Sq, H, dv)))
    j16 = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
           for t in (q, k, v, do)]
    _, vjp = jax.vjp(lambda *a: _ref_attention(*a, causal, window), *j16[:3])
    want16 = vjp(j16[3])
    _, vjp = jax.vjp(lambda *a: _ref_attention(*a, causal, window),
                     *(x.astype(jnp.float32) for x in j16[:3]))
    want32 = vjp(j16[3].astype(jnp.float32))
    # the forward's output and log-sum-exp, as the bf16 forward writes them
    o = ref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
    lse = ref.attention_lse_ref(q, k, causal=causal, window=window)
    got, seen = attention_bwd_bf16_model(q, k, v, o, lse, do, causal, window)
    assert all(g.dtype == BF16 for g in got)
    kept = _kept(torch.arange(Sq)[:, None] + Sk - Sq,
                 torch.arange(Sk)[None, :], Sk, causal, window)
    for visits in seen:       # every kept triple once, in each pass
        assert torch.equal(visits, kept.int().expand(B, H, Sq, Sk))
    own = _gaps(want16, want32)
    model = _gaps([g.float().numpy() for g in got], want16)
    for m, r in zip(model, own):
        assert m <= BF16_REF_FACTOR * r, (case, model, own)


def test_attention_bwd_bf16_model_has_the_kernels_geometry():
    """The blocks, tiles, products and roundings modelled here are the
    ones the bf16 source declares, for every width pair the bf16 forward
    takes: TMA-fed wgmma with a producer warp and two consumer
    warpgroups, every sum in the tensor cores' accumulators, no float sum
    through an atomic and no f32 partial for the group."""
    src = (_build.CSRC / "attention_bwd_bf16.cu").read_text()
    common = (_build.CSRC / "sm90_common.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                             src).group(1))
    assert (const("kBKV"), const("kBQ"), const("kHalf")) == (
        KV_KEYS, Q_ROWS, HALF)
    assert (const("kKvStages"), const("kQStages")) == (KV_STAGES, Q_STAGES)
    assert "static constexpr int BQ = DQK + DV <= 256 ? 64 : 32;" in src
    assert ("static constexpr int BK = DQK == 128 && DV == 128 ? 128 : 64;"
            in src)
    assert '#include "sm90_common.cuh"' in src
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in common
    assert "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16" in common
    assert "cp.async.bulk.tensor.4d.shared::cluster.global" in common
    assert "setmaxnreg.dec.sync.aligned.u32 24" in src
    assert "setmaxnreg.inc.sync.aligned.u32 240" in src
    assert "wgmma_ss<BQ>" in src and "wgmma_ss<kBK>" in src
    assert "m64n128k16.f32.bf16.bf16" in src    # S and dP at BK = 128
    assert src.count("wgmma_rs_wide<") >= 3   # dV, dK and dQ, from registers
    assert "bf16x2_bits(__floats2bfloat162_rn(lo, hi))" in src
    assert "ex2(fmaf(" in src and "1.4426950408889634f" in src
    assert "atomicAdd" not in src and "atom." not in src
    assert "part" not in re.sub(r"//.*", "", src.split('extern "C"')[1])
    assert fa.BWD_WIDTHS[BF16] == fa.WIDTHS[BF16]
    for d, dv in fa.BWD_WIDTHS[BF16]:
        assert f"REPRO_ATTENTION_BWD_BF16_CASE({d}, {dv})" in src
        assert max(_smem(d, dv)) <= SMEM
    assert _build.SOURCES["attention_bwd_bf16"] == ("attention_bwd_bf16.cu",)
    assert fa.BWD_PROGRAMS[BF16] == ("sm90_wgmma_tma", "attention_bwd_bf16",
                                     "repro_attention_bwd_bf16")
    assert "repro_attention_bwd_bf16" in _build.SIGNATURES[
        "attention_bwd_bf16"]


@pytest.mark.parametrize("rows,D,g", [(64, 768, 1), (40, 1601, 1),
                                      (24, 4096, 4)])
def test_rmsnorm_bwd_bf16_matches_the_references_bf16_norm(rows, D, g):
    rng = np.random.default_rng(rows + D + g)
    x, dy = (torch.from_numpy(rng.standard_normal((rows, D)).astype(
        np.float32)).to(BF16) for _ in range(2))
    scale = torch.from_numpy((1.0 + 0.1 * rng.standard_normal((g, D)))
                             .astype(np.float32)).to(BF16)

    def f(x, scale):
        y = jax.vmap(lambda xs, s: rmsnorm_apply({"scale": s}, xs))(
            x.reshape(g, rows // g, D), scale)
        return y.reshape(rows, D)

    jx, jdy, js = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                   for t in (x, dy, scale))
    _, vjp = jax.vjp(f, jx, js)
    want = [np.asarray(t).astype(np.float32) for t in vjp(jdy)]
    dx, ds = rmsnorm_bwd_model(x.float(), scale.float(), dy.float(), 1e-5,
                               BF16)
    for got, w in zip((dx.to(BF16), ds.to(BF16)), want):
        assert float(np.abs(got.float().numpy() - w).max()) <= \
            2.0 ** -8 * float(np.abs(w).max())


# ------------------------------------------------------------- routes

class Bf16StandIns(StandIns):
    """``StandIns`` with the SSD forward as the bf16 kernel computes it
    (bf16 in, f32 inside, y in bf16), recording the dtypes each backward
    stand-in receives."""

    def __init__(self, monkeypatch):
        self.bwd_dtypes = {"attn_bwd": set(), "norm_bwd": set(),
                           "ssd_bwd": set()}
        super().__init__(monkeypatch)     # installs the methods below

    def ssd(self, x, dt, a, b, c, chunk):
        y, h, states = super().ssd(*(t.float() for t in (x, dt, a, b, c)),
                                   chunk)
        return y.to(x.dtype), h, states

    def ssd_bwd(self, x, dt, a, b, c, states, dy, dh, chunk):
        self.bwd_dtypes["ssd_bwd"] |= {x.dtype, dt.dtype, b.dtype, dy.dtype}
        return super().ssd_bwd(x, dt, a, b, c, states, dy, dh, chunk)

    def attn_bwd(self, q, k, v, o, lse, do, causal, window, scale):
        self.bwd_dtypes["attn_bwd"] |= {q.dtype, k.dtype, o.dtype, do.dtype}
        return super().attn_bwd(q, k, v, o, lse, do, causal, window, scale)

    def norm_bwd(self, x, scale, dy, eps):
        self.bwd_dtypes["norm_bwd"] |= {x.dtype, scale.dtype, dy.dtype}
        return super().norm_bwd(x, scale, dy, eps)


def _block(p, x):
    """A norm, grouped causal attention and its banded form, then an SSD
    over the heads, on x (B, S, 64) bf16."""
    y = ops.rmsnorm(x, p["scale"])
    B, S, _ = y.shape
    q = (y @ p["wq"]).reshape(B, S, 4, 32)
    k = (y @ p["wk"]).reshape(B, S, 2, 32)
    v = (y @ p["wv"]).reshape(B, S, 2, 32)
    a = ops.flash_attention_gqa(q, k, v) + ops.swa_attention(q, k, v,
                                                             window=8)
    u = a.permute(0, 2, 1, 3).reshape(B * 4, S, 32)
    dt = torch.nn.functional.softplus(u[..., 0].float()).to(u.dtype)
    bc = (y @ p["wbc"]).reshape(B, S, 2, 16).permute(0, 2, 1, 3)
    out, _ = ops.ssd_scan(u, dt, p["a"], bc[:, 0].contiguous(),
                          bc[:, 1].contiguous(), chunk=8)
    return out.float().square().mean()


def _params(rng, m=None):
    lead = () if m is None else (m,)

    def f(*s, scale=0.2):
        return torch.from_numpy(scale * rng.standard_normal(lead + s)
                                .astype(np.float32))
    p = {"scale": 1 + f(64, scale=0.1), "wq": f(64, 128), "wk": f(64, 64),
         "wv": f(64, 64), "wbc": f(64, 32)}
    p = {k_: v_.to(BF16) for k_, v_ in p.items()}
    p["a"] = -f(8, scale=1.0).abs() - 0.1        # f32, as the models keep it
    return p


@pytest.mark.parametrize("m", [1, 3])
def test_bf16_vmap_grad_one_call_per_op_whatever_m(m, monkeypatch):
    rng = np.random.default_rng(m)
    p = _params(rng, m)
    x = torch.from_numpy(rng.standard_normal((m, 2, 24, 64)).astype(
        np.float32)).to(BF16)
    want = torch.func.vmap(torch.func.grad(_block))(p, x)   # plain route
    stand = Bf16StandIns(monkeypatch)
    _kernel_route(monkeypatch)
    got = torch.func.vmap(torch.func.grad(_block))(p, x)
    assert stand.calls == {"ssd": 1, "ssd_bwd": 1, "attn": 2,
                           "attn_bwd": 2, "norm": 1, "norm_bwd": 1}
    assert stand.bwd_dtypes == {"attn_bwd": {BF16}, "norm_bwd": {BF16},
                                "ssd_bwd": {torch.float32}}
    for k_ in p:
        assert got[k_].dtype == p[k_].dtype, k_
        w = want[k_].float()
        assert float((got[k_].float() - w).abs().max()) <= \
            2.0 ** -7 * float(w.abs().max()), k_


def test_bf16_backward_equals_func_grad(monkeypatch):
    rng = np.random.default_rng(7)
    p = _params(rng)
    x = torch.from_numpy(rng.standard_normal((2, 24, 64)).astype(
        np.float32)).to(BF16)
    stand = Bf16StandIns(monkeypatch)
    _kernel_route(monkeypatch)
    want = torch.func.grad(_block)(p, x)
    tracked = {k_: v_.clone().requires_grad_() for k_, v_ in p.items()}
    _block(tracked, x).backward()
    assert stand.calls["attn_bwd"] == 4 and stand.calls["ssd_bwd"] == 2
    for k_ in p:
        # a leaf's terms added in another order, in its dtype
        g, w = tracked[k_].grad, want[k_]
        assert g.dtype == p[k_].dtype
        assert float((g.float() - w.float()).abs().max()) <= \
            2.0 ** -8 * float(w.float().abs().max()), k_
