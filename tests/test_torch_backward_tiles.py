"""The two backward kernels' arithmetic, modelled in plain PyTorch on the
CPU and held against ``jax.grad`` of the JAX package's jnp attention and
RMS norm, and the autograd / vmap plumbing around them.

* ``attention_bwd`` (``csrc/attention_bwd.cu``): delta = rowsum(do o);
  the dk/dv pass, one block per (batch, kv head, 64-key tile), walking
  its group's query heads in order and, for each, the 64-row query tiles
  the kernel's range bounds give, in order; the dq pass, one block per
  (batch, head, 64-row query tile), walking the key tiles of the
  forward's range. p = exp2(s scale log2(e) - lse log2(e)) with the
  masks applied, lse the forward's log-sum-exp (+inf in log2 units for
  a row that keeps nothing). The model also checks the ranges: the
  kept (query, key, head) triples it visits are every kept triple, each
  once, in each pass. Cases: ragged S (100, 130), GQA groups 1 and 4,
  head dims 32, 64 and 128, a window, non-causal with Sk != Sq.
  Tolerance: dq, dk and dv within ``GRAD_TOL`` of the largest entry
  of each (f32 on both sides, summed in other orders).
* ``rmsnorm_bwd`` (``csrc/rmsnorm_bwd.cu``): ``rmsnorm.bwd_plan``'s
  partition (chunks of rows within a group, threads of 4 columns), each
  thread's strided column sums in order with f32 multiply-adds, the
  warps' xor butterflies and the warp sums in warp order, the chunk's
  dscale partial and each group's partials summed in chunk order,
  against ``jax.grad`` of the reference's jnp norm with a scale per
  group: D 768, 1,601 (no multiple of 4) and 4,096; 1 and 4 groups.
  The model does not claim the kernel's last bits (nvcc contracts its
  multiply-adds its own way); it holds the partition and the orders.
* The plumbing: ``AttentionFn`` and ``RMSNormFn`` called directly with
  their launch functions replaced by stand-ins (the plain versions) that
  assert they receive plain, unwrapped tensors and count their calls:
  ``vmap(grad_and_value)`` over m = 3 learners equals the plain versions'
  result, with one forward and one backward call per op whatever m,
  and ``loss.backward()`` equals ``torch.func.grad``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

GRAD_TOL = 1e-5
TILE = 64
LOG2E = 1.4426950408889634


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ attention

def _jax_gqa(q, k, v, causal, window):
    """The reference's jnp attention on the GQA layout (its ops' fold)."""
    B, Sq, H, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, d).transpose(0, 2, 3, 1, 4)
    qg = qg.reshape(B * H, Sq, d)
    kg = jnp.repeat(k.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, Sk, d)
    vg = jnp.repeat(v.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, Sk, d)
    o = jref.flash_attention_ref(qg, kg, vg, causal=causal, window=window)
    return o.reshape(B, Hkv, G, Sq, d).transpose(0, 3, 1, 2, 4).reshape(
        B, Sq, H, d)


def _kept(qpos, kpos, Sk, causal, window):
    keep = (kpos < Sk) & (qpos >= qpos.min())     # (queries, keys)
    if causal:
        keep = keep & (kpos <= qpos)
    if window > 0:
        keep = keep & (kpos > qpos - window)
    return keep


def _tile_p_ds(qt, dot, kt, vt, lse2, delta, q0, k0, off, Sk, causal,
               window, sl2):
    """p and ds of one (query tile, key tile), rows past Sq carrying
    lse2 = +inf (so p = 0), as the kernel's ``p_ds``."""
    qpos = torch.arange(q0, q0 + TILE)[:, None] + off
    kpos = torch.arange(k0, k0 + TILE)[None, :]
    keep = _kept(qpos, kpos, Sk, causal, window)
    s = qt @ kt.T
    dp = dot @ vt.T
    p = torch.where(keep, torch.exp2(s * sl2 - lse2[:, None]),
                    torch.zeros(()))
    return p, p * (dp - delta[:, None]), keep & torch.isfinite(lse2)[:, None]


def _tile(x, r0, n_rows):
    """Rows [r0, r0 + TILE) of x (rows, d), zero past n_rows."""
    out = torch.zeros((TILE, x.shape[1]))
    hi = min(r0 + TILE, n_rows)
    if hi > r0:
        out[:hi - r0] = x[r0:hi]
    return out


def attention_bwd_model(q, k, v, o, lse, do, causal, window):
    """The kernel's three passes on (B, S, heads, d) f32 tensors; also
    returns the kept triples each pass visited."""
    B, Sq, H, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G, off = H // Hkv, Sk - Sq
    scale = 1.0 / math.sqrt(d)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    delta = (do * o).sum(-1).permute(0, 2, 1)              # (B, H, Sq)
    lse2 = torch.where(torch.isinf(lse), torch.tensor(math.inf),
                       lse * LOG2E)
    pad = lambda t: torch.cat([t, torch.full((TILE,), math.inf)])  # noqa
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    seen_kv, seen_q = 0, 0
    for b in range(B):
        for hk in range(Hkv):
            for kt0 in range(0, Sk, TILE):
                i_lo, i_hi = 0, Sq
                if causal:
                    i_lo = max(0, kt0 - off)
                if window > 0:
                    i_hi = min(Sq, kt0 + TILE - 1 + window - off)
                t_lo = i_lo // TILE
                t_hi = -(-i_hi // TILE) if i_hi > i_lo else t_lo
                kt = _tile(k[b, :, hk], kt0, Sk)
                vt = _tile(v[b, :, hk], kt0, Sk)
                acc_k = torch.zeros((TILE, d))
                acc_v = torch.zeros((TILE, d))
                for hh in range(G):
                    h = hk * G + hh
                    for qi in range(t_lo, t_hi):
                        q0 = qi * TILE
                        p, ds, kept = _tile_p_ds(
                            _tile(q[b, :, h], q0, Sq),
                            _tile(do[b, :, h], q0, Sq), kt, vt,
                            pad(lse2[b, h])[q0:q0 + TILE],
                            torch.cat([delta[b, h], torch.zeros(TILE)])[
                                q0:q0 + TILE],
                            q0, kt0, off, Sk, causal, window, sl2)
                        seen_kv += int(kept[:max(0, min(TILE, Sq - q0))]
                                       .sum())
                        acc_v += p.T @ _tile(do[b, :, h], q0, Sq)
                        acc_k += ds.T @ _tile(q[b, :, h], q0, Sq)
                n = min(TILE, Sk - kt0)
                dv[b, kt0:kt0 + n, hk] = acc_v[:n]
                dk[b, kt0:kt0 + n, hk] = acc_k[:n] * scale
        for h in range(H):
            hk = h // G
            for q0 in range(0, Sq, TILE):
                q_last = min(q0 + TILE, Sq) - 1
                k_lo, k_hi = 0, Sk
                if causal:
                    k_hi = min(Sk, off + q_last + 1)
                if window > 0:
                    k_lo = max(0, off + q0 - window + 1)
                t_lo = k_lo // TILE
                t_hi = -(-k_hi // TILE) if k_hi > k_lo else t_lo
                qt = _tile(q[b, :, h], q0, Sq)
                dot = _tile(do[b, :, h], q0, Sq)
                l2 = pad(lse2[b, h])[q0:q0 + TILE]
                dl = torch.cat([delta[b, h], torch.zeros(TILE)])[q0:q0 + TILE]
                acc = torch.zeros((TILE, d))
                for ki in range(t_lo, t_hi):
                    kt = _tile(k[b, :, hk], ki * TILE, Sk)
                    vt = _tile(v[b, :, hk], ki * TILE, Sk)
                    _, ds, kept = _tile_p_ds(qt, dot, kt, vt, l2, dl, q0,
                                             ki * TILE, off, Sk, causal,
                                             window, sl2)
                    seen_q += int(kept[:max(0, min(TILE, Sq - q0))].sum())
                    acc += ds @ kt
                n = min(TILE, Sq - q0)
                dq[b, q0:q0 + n, h] = acc[:n] * scale
    return (dq, dk, dv), (seen_kv, seen_q)


ATTN_CASES = [  # B, Sq, Sk, H, Hkv, d, causal, window
    (2, 100, 100, 4, 4, 64, True, 0),      # ragged S, group 1
    (1, 130, 130, 8, 2, 128, True, 0),     # ragged past two tiles, group 4
    (1, 150, 150, 4, 1, 64, True, 40),     # a window, group 4
    (2, 70, 100, 2, 2, 32, False, 0),      # non-causal, Sk != Sq
    (1, 90, 200, 4, 1, 128, True, 0),      # right-aligned diagonal
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_bwd_model_matches_jax_grad(case):
    B, Sq, Sk, H, Hkv, d, causal, window = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v, do = (_rand(rng, B, Sq, H, d), _rand(rng, B, Sk, Hkv, d),
                   _rand(rng, B, Sk, Hkv, d), _rand(rng, B, Sq, H, d))
    o, vjp = jax.vjp(lambda *a: _jax_gqa(*a, causal, window), q, k, v)
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    o = np.array(o)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    lse = ref.attention_lse_ref(tq, tk, causal=causal, window=window)
    got, (seen_kv, seen_q) = attention_bwd_model(
        tq, tk, tv, torch.from_numpy(o), lse, tdo, causal,
        window)
    qpos = np.arange(Sq)[:, None] + Sk - Sq
    kpos = np.arange(Sk)[None, :]
    kept = int(_kept(torch.from_numpy(qpos), torch.from_numpy(kpos), Sk,
                     causal, window).sum()) * B * H
    assert seen_kv == seen_q == kept
    for g, w in zip(got, want):
        assert float(np.abs(g.numpy() - w).max()) <= \
            GRAD_TOL * float(np.abs(w).max())


# -------------------------------------------------------------- rmsnorm

def _fma(a, b, c):
    """f32 fused multiply-add, rounded once (via f64, exact products)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(v):
    """The xor butterfly over a warp's 32 lanes (the last axis)."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v


def rmsnorm_bwd_model(x, scale, dy, eps):
    """dx and dscale (g, D) as the kernel partitions and orders them."""
    rows, D = x.shape
    g = scale.shape[0]
    R = rows // g
    threads, chunk, chunks = rn.bwd_plan(rows, D, g)
    cols = -(-D // threads)
    idx = torch.arange(threads)[:, None] + threads * torch.arange(cols)
    valid = idx < D
    idx = idx.clamp(max=D - 1)
    eps32 = torch.tensor(eps, dtype=torch.float32)
    dx = torch.empty_like(x)
    partial = torch.zeros((g * chunks, D))
    for c in range(g * chunks):
        gi, ci = divmod(c, chunks)
        s = scale[gi]
        for r in range(gi * R + ci * chunk, gi * R + min(R, (ci + 1) * chunk)):
            xv, gv, sv = x[r][idx], dy[r][idx], s[idx]
            a = torch.zeros(threads)
            b = torch.zeros(threads)
            for j in range(cols):
                on = valid[:, j]
                a = torch.where(on, _fma(gv[:, j] * sv[:, j], xv[:, j], a), a)
                b = torch.where(on, _fma(xv[:, j], xv[:, j], b), b)
            wa = _butterfly(a.view(-1, 32))[:, 0]
            wb = _butterfly(b.view(-1, 32))[:, 0]
            sa = torch.zeros(())
            sb = torch.zeros(())
            for w in range(threads // 32):
                sa = sa + wa[w]
                sb = sb + wb[w]
            rr = 1.0 / torch.sqrt(sb / D + eps32)
            coef = sa * (rr * rr * rr) / D
            dx[r] = dy[r] * s * rr - x[r] * coef
            partial[c] = _fma(dy[r], x[r] * rr, partial[c])
    dscale = torch.zeros((g, D))
    for gi in range(g):
        for k in range(chunks):
            dscale[gi] = dscale[gi] + partial[gi * chunks + k]
    return dx, dscale


@pytest.mark.parametrize("rows,D,g", [(64, 768, 1), (64, 768, 4),
                                      (40, 1601, 1), (24, 4096, 4)])
def test_rmsnorm_bwd_model_matches_jax_grad(rows, D, g):
    rng = np.random.default_rng(rows + D + g)
    x, dy = _rand(rng, rows, D), _rand(rng, rows, D)
    scale = 1.0 + 0.1 * _rand(rng, g, D)

    def f(x, scale):
        y = jax.vmap(lambda xs, s: jref.rmsnorm_ref(xs, s))(
            x.reshape(g, rows // g, D), scale)
        return y.reshape(rows, D)

    _, vjp = jax.vjp(f, x, scale)
    want_dx, want_ds = (np.asarray(t) for t in vjp(jnp.asarray(dy)))
    dx, ds = rmsnorm_bwd_model(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(dy), 1e-5)
    for got, want in ((dx, want_dx), (ds, want_ds)):
        assert float(np.abs(got.numpy() - want).max()) <= \
            GRAD_TOL * float(np.abs(want).max())


def test_bwd_plan_partitions_the_rows():
    for rows, D, g in [(1, 7, 1), (4096, 4096, 1), (4096, 4096, 4),
                       (2048, 768, 4), (300, 100, 3), (8, 16_384, 8)]:
        threads, chunk, chunks = rn.bwd_plan(rows, D, g)
        assert threads % 32 == 0 and 32 <= threads <= rn.BWD_THREADS
        R = rows // g
        assert 1 <= chunk <= R and (chunks - 1) * chunk < R <= chunks * chunk
        assert g * chunks <= rn.BWD_BLOCKS * 2


# ------------------------------------------------------------- plumbing

class StandIns:
    """Plain-version launch functions that refuse wrapped tensors."""

    def __init__(self, monkeypatch):
        self.calls = {"attn": 0, "attn_bwd": 0, "norm": 0, "norm_bwd": 0}
        for mod, name, fn in (
                (fa, "launch_forward", self.attn),
                (fa, "launch_backward", self.attn_bwd),
                (rn, "launch_forward", self.norm),
                (rn, "launch_backward", self.norm_bwd)):
            monkeypatch.setattr(mod, name, fn)

    @staticmethod
    def _plain(*tensors):
        from torch._C._functorch import is_functorch_wrapped_tensor
        for t in tensors:
            assert not is_functorch_wrapped_tensor(t), "a wrapped tensor"
            t.data_ptr()            # a plain tensor has its storage

    def attn(self, q, k, v, causal, window, scale):
        self._plain(q, k, v)
        self.calls["attn"] += 1
        o = ref.flash_attention_gqa_ref(q, k, v, causal=causal,
                                        window=window, scale=scale)
        return o, ref.attention_lse_ref(q, k, causal=causal, window=window,
                                        scale=scale)

    def attn_bwd(self, q, k, v, o, lse, do, causal, window, scale):
        self._plain(q, k, v, o, lse, do)
        self.calls["attn_bwd"] += 1
        return ref.flash_attention_gqa_bwd_ref(q, k, v, do, causal=causal,
                                               window=window, scale=scale)

    def norm(self, x, scale, eps):
        self._plain(x, scale)
        self.calls["norm"] += 1
        return ref.rmsnorm_ref(x, scale, eps)

    def norm_bwd(self, x, scale, dy, eps):
        self._plain(x, scale, dy)
        self.calls["norm_bwd"] += 1
        D = x.shape[-1]
        dx, ds = ref.rmsnorm_bwd_ref(x.reshape(-1, D), scale,
                                     dy.reshape(-1, D), eps)
        return dx.reshape(x.shape), ds


def _block(p, x, norm, attn):
    """A norm then grouped causal attention over x (B, S, 4 * 16)."""
    y = norm(x, p["scale"])
    B, S, _ = y.shape
    q = (y @ p["wq"]).reshape(B, S, 4, 16)
    k = (y @ p["wk"]).reshape(B, S, 2, 16)
    v = (y @ p["wv"]).reshape(B, S, 2, 16)
    return attn(q, k, v).square().mean()


def _kernel_loss(p, x):
    return _block(p, x, lambda x, s: rn.RMSNormFn.apply(x, s, 1e-5),
                  lambda q, k, v: fa.AttentionFn.apply(q, k, v, True, 0,
                                                       None)[0])


def _plain_loss(p, x):
    return _block(p, x, lambda x, s: ref.rmsnorm_ref(x, s, 1e-5),
                  lambda q, k, v: ref.flash_attention_gqa_ref(q, k, v))


def _params(rng, m=None):
    lead = () if m is None else (m,)
    return {"scale": torch.from_numpy(1 + 0.1 * _rand(rng, *lead, 64)),
            "wq": torch.from_numpy(0.2 * _rand(rng, *lead, 64, 64)),
            "wk": torch.from_numpy(0.2 * _rand(rng, *lead, 64, 32)),
            "wv": torch.from_numpy(0.2 * _rand(rng, *lead, 64, 32))}


@pytest.mark.parametrize("m", [1, 3])
def test_vmap_grad_one_call_per_op_whatever_m(m, monkeypatch):
    stand = StandIns(monkeypatch)
    rng = np.random.default_rng(m)
    p = _params(rng, m)
    x = torch.from_numpy(_rand(rng, m, 2, 24, 64))
    fleet = torch.func.vmap(torch.func.grad_and_value(_kernel_loss))
    grads, losses = fleet(p, x)
    assert stand.calls == {"attn": 1, "attn_bwd": 1, "norm": 1,
                           "norm_bwd": 1}
    want_g, want_l = torch.func.vmap(torch.func.grad_and_value(
        _plain_loss))(p, x)
    torch.testing.assert_close(losses, want_l, rtol=1e-6, atol=1e-7)
    for k in want_g:
        torch.testing.assert_close(grads[k], want_g[k], rtol=1e-5,
                                   atol=1e-7)


def test_backward_equals_func_grad(monkeypatch):
    stand = StandIns(monkeypatch)
    rng = np.random.default_rng(9)
    p = _params(rng)
    x = torch.from_numpy(_rand(rng, 2, 24, 64))
    want = torch.func.grad(_kernel_loss)(p, x)
    tracked = {k: v.clone().requires_grad_() for k, v in p.items()}
    loss = _kernel_loss(tracked, x)
    assert loss.grad_fn is not None
    loss.backward()
    assert stand.calls == {"attn": 2, "attn_bwd": 2, "norm": 2,
                           "norm_bwd": 2}
    for k in p:
        torch.testing.assert_close(tracked[k].grad, want[k], rtol=1e-6,
                                   atol=1e-8)
        assert float(tracked[k].grad.abs().sum()) > 0
    plain = torch.func.grad(_plain_loss)(p, x)
    for k in p:
        torch.testing.assert_close(want[k], plain[k], rtol=1e-5, atol=1e-7)


def test_no_second_derivative(monkeypatch):
    StandIns(monkeypatch)
    rng = np.random.default_rng(4)
    p = _params(rng)
    x = torch.from_numpy(_rand(rng, 2, 24, 64))
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.func.grad(lambda p: torch.func.grad(_kernel_loss)(
            p, x)["scale"].sum())(p)
