"""The bf16 backward kernels' arithmetic and their autograd routes, on the
CPU, against the JAX package.

* ``attention_bwd`` in bf16 (``csrc/attention_bwd_bf16.cu``), modelled
  in plain PyTorch: the f32 program's passes and tiles (delta; the dk/dv
  pass, blocks of 16 P keys of one query head walking the 32-row query
  tiles of the range the kernel bounds, P = 6 warp pairs at equal widths,
  4 at MLA's (192, 128), the query heads' f32 partials then summed over
  each kv head's group in head order; the dq pass, blocks of 16 P query
  rows walking the 32-key tiles of the forward's range), every product
  one bf16 product with f32 sums: S and dP from the bf16 inputs, each
  warp of a pair over half of each width; P and dS rounded to bf16 once,
  to nearest even, as the A operand of dV, dK and dQ, each tile's product
  added to the running sums in f32; dq, dk and dv rounded to bf16 once.
  The per-pair shortcuts are checked on every tile and every kept (query,
  key, head) triple is visited once per pass. Held against ``jax.vjp`` of
  the reference's bf16 attention (``repro.models.attention._sdpa``, which
  rounds the scores and the probabilities to bf16): dq, dk and dv within
  ``BF16_REF_FACTOR`` times the reference's own gap, its bf16 gradient
  against its f32 gradient at the same (bf16) inputs, each gradient's max
  |diff| over its max. Cases: ragged S, GQA groups 1 and 4, head widths
  32, 64 and 128, a window, non-causal with Sk != Sq, a right-aligned
  diagonal, MLA's (192, 128).
* ``rmsnorm_bwd`` in bf16: the f32 kernel's arithmetic
  (``test_torch_backward_tiles.rmsnorm_bwd_model``) on the bf16 values,
  dx and dscale rounded to bf16 once, against ``jax.vjp`` of the
  reference's norm (``repro.models.layers.rmsnorm_apply``, f32 inside,
  the result cast) in bf16: within one bf16 step of each gradient's max.
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
    BT, LOG2E, SMEM, WARP, _fma_f32, _kept, _rows, _warps,
    rmsnorm_bwd_model,
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


def _plan(d, dv):
    """The kernel's Plan<d, dv>: (warp pairs a block, its shared-memory
    bytes): 6 pairs at equal widths up to 128, 4 at (192, 128)."""
    pairs = 6 if d + dv <= 256 else 4
    ldq, ldv = d + 8, dv + 8
    nbytes = (2 * (16 * pairs * (ldq + ldv) + 2 * BT * (ldq + ldv))
              + 4 * (2 * 2 * BT + 2 * pairs * 2 * BT * 16))
    return pairs, nbytes


def attention_bwd_bf16_model(q, k, v, o, lse, do, causal, window):
    """The kernel's passes on bf16 tensors q (B, Sq, H, d), k (B, Sk, Hkv,
    d), v (B, Sk, Hkv, dv), o and do (B, Sq, H, dv) and the f32 lse:
    (dq, dk, dv) in bf16 and the visits of each pass, (B, H, Sq, Sk)
    counts of the pairs it computed that the mask keeps."""
    B, Sq, H, d = q.shape
    Sk, Hkv, dw = k.shape[1], k.shape[2], v.shape[3]
    BR = WARP * _plan(d, dw)[0]
    G, off = H // Hkv, Sk - Sq
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    sl2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    qf, of, dof = (x.float().permute(0, 2, 1, 3) for x in (q, o, do))
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    delta = (dof * of).sum(-1)                                 # (B, H, Sq)
    lse2 = torch.where(torch.isinf(lse), torch.tensor(math.inf),
                       lse * torch.tensor(LOG2E, dtype=torch.float32))
    seen_kv = torch.zeros((B, H, Sq, Sk), dtype=torch.int32)
    seen_q = torch.zeros_like(seen_kv)

    def pair(a, b):
        """a @ b^T over their width as a warp pair sums it: each warp over
        its half (bf16 values, exact products, f32 sums), half 0's plus
        half 1's."""
        h = a.shape[-1] // 2
        return (a[..., :h] @ b[..., :h].transpose(-1, -2)
                + a[..., h:] @ b[..., h:].transpose(-1, -2))

    # dk, dv: blocks of BR keys of one query head, f32 partials
    part_k = torch.zeros((B, H, Sk, d))
    part_v = torch.zeros((B, H, Sk, dw))
    for k0 in range(0, Sk, BR):
        i_lo = max(0, k0 - off) if causal else 0
        i_hi = min(Sq, k0 + BR - 1 + window - off) if window > 0 else Sq
        t_lo = i_lo // BT
        n_t = -(-i_hi // BT) - t_lo if i_hi > i_lo else 0
        nk = min(BR, Sk - k0)
        kpos = torch.arange(k0, k0 + BR)[:, None]
        kt, vt = _rows(kf, k0, BR, Sk), _rows(vf, k0, BR, Sk)
        acc_k = torch.zeros((B, H, BR, d))
        acc_v = torch.zeros((B, H, BR, dw))
        for t in range(t_lo, t_lo + n_t):
            q0 = t * BT
            qt, dot = _rows(qf, q0, BT, Sq), _rows(dof, q0, BT, Sq)
            l2 = _rows(lse2[..., None], q0, BT, Sq, math.inf)[..., 0]
            dl = _rows(delta[..., None], q0, BT, Sq)[..., 0]
            lo, hi = q0 + off, q0 + off + BT - 1
            keep = _kept(torch.arange(lo, hi + 1)[None, :], kpos, Sk, causal,
                         window)
            active = _warps(
                keep, nk, range(k0, k0 + BR, WARP),
                lambda r: r >= Sk or (causal and r > hi) or (
                    window > 0 and r + WARP - 1 <= lo - window),
                lambda r: r + WARP - 1 >= Sk or (
                    causal and r + WARP - 1 > lo) or (
                    window > 0 and r <= hi - window))
            on = keep & active[:, None]
            st, dpt = pair(kt, qt), pair(vt, dot)
            p = torch.exp2(_fma_f32(st, sl2, -l2[..., None, :]))
            p = torch.where(on, p, torch.zeros(()))
            ds = p * (dpt - dl[..., None, :])
            acc_v = acc_v + _bf16(p) @ dot
            acc_k = acc_k + _bf16(ds) @ qt
            nq = min(BT, Sq - q0)
            seen_kv[:, :, q0:q0 + nq, k0:k0 + nk] += on[:nk, :nq].T.int()
        part_k[:, :, k0:k0 + nk] = acc_k[:, :, :nk]
        part_v[:, :, k0:k0 + nk] = acc_v[:, :, :nk]
    # the fourth launch: each group's partials summed in head order, dk
    # scaled, both rounded to bf16 once
    dk, dv = part_k[:, ::G].clone(), part_v[:, ::G].clone()
    for hh in range(1, G):
        dk = dk + part_k[:, hh::G]
        dv = dv + part_v[:, hh::G]
    dk, dv = (dk * scale).to(BF16), dv.to(BF16)

    # dq: blocks of BR query rows walking BT-key tiles
    dq = torch.zeros((B, H, Sq, d), dtype=BF16)
    for q0 in range(0, Sq, BR):
        q_last = min(q0 + BR, Sq) - 1
        k_hi = min(Sk, off + q_last + 1) if causal else Sk
        k_lo = max(0, off + q0 - window + 1) if window > 0 else 0
        t_lo = k_lo // BT
        n_t = -(-k_hi // BT) - t_lo if k_hi > k_lo else 0
        nq = min(BR, Sq - q0)
        qt, dot = _rows(qf, q0, BR, Sq), _rows(dof, q0, BR, Sq)
        l2 = _rows(lse2[..., None], q0, BR, Sq, math.inf)
        dl = _rows(delta[..., None], q0, BR, Sq)
        qpos = torch.arange(q0, q0 + BR)[:, None] + off
        acc = torch.zeros((B, H, BR, d))
        for t in range(t_lo, t_lo + n_t):
            k0 = t * BT
            kt, vt = _rows(kf, k0, BT, Sk), _rows(vf, k0, BT, Sk)
            keep = _kept(qpos, torch.arange(k0, k0 + BT)[None, :], Sk,
                         causal, window)
            active = _warps(
                keep, nq, range(q0, q0 + BR, WARP),
                lambda r: r >= Sq or (causal and k0 > r + off + WARP - 1) or (
                    window > 0 and k0 + BT - 1 <= r + off - window),
                lambda r: k0 + BT > Sk or (causal and k0 + BT - 1 > r + off)
                or (window > 0 and k0 <= r + off + WARP - 1 - window))
            on = keep & active[:, None]
            s, dp = pair(qt, kt), pair(dot, vt)
            p = torch.where(on, torch.exp2(_fma_f32(s, sl2, -l2)),
                            torch.zeros(()))
            acc = acc + _bf16(p * (dp - dl)) @ kt
            nk = min(BT, Sk - k0)
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
    takes; no float sum goes through an atomic."""
    src = (_build.CSRC / "attention_bwd_bf16.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                             src).group(1))
    assert const("kBT") == BT and const("kStages") == 2
    assert const("kMaxPairs") == 6 and const("kNarrowPairs") == 4
    assert const("kMaxSmem") == SMEM
    assert "constexpr int kSwap = 2 * kBT * 16;" in src
    assert ("DQK + DV <= 256 ? kMaxPairs : kNarrowPairs" in src
            and "static constexpr int LDQ = DQK + 8;" in src)
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in src
    assert "__floats2bfloat162_rn" in src
    assert "exp2f(fmaf(" in src and "1.4426950408889634f" in src
    assert "atomicAdd" not in src and "atom." not in src
    assert fa.BWD_WIDTHS[BF16] == fa.WIDTHS[BF16]
    for d, dv in fa.BWD_WIDTHS[BF16]:
        assert f"REPRO_ATTENTION_BWD_BF16_CASE({d}, {dv})" in src
        assert _plan(d, dv)[1] <= SMEM
    assert _build.SOURCES["attention_bwd_bf16"] == ("attention_bwd_bf16.cu",)
    assert fa.BWD_PROGRAMS[BF16][1:] == ("attention_bwd_bf16",
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
    dx, ds = rmsnorm_bwd_model(x.float(), scale.float(), dy.float(), 1e-5)
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
