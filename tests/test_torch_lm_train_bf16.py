"""bf16 LM training in the port against the JAX package on the CPU.

Every published config of the reference is bf16, and the JAX package
differentiates its models in bf16. The port's plain versions do the same
on the CPU; on the card its bf16 gradient runs through hand-written
kernels (``csrc/attention_bwd_bf16.cu``, the bf16 form of
``csrc/rmsnorm_bwd.cu``; ``chip_smoke.py`` holds them there).

* ``lm_loss``'s gradient at bf16 weights, every smoke config
  (``ASSIGNED_ARCHS``) on the reference's own weights cast to bf16 (both
  packages round to nearest even) and the batch of
  ``tests/test_torch_lm_train.py``, by ``torch.func.grad`` against
  ``jax.grad``: the port's worst leaf (max |diff| over max |leaf|) lies
  within ``BF16_GAP`` times the reference's own bf16-vs-f32 worst-leaf gap
  (its bf16 gradient against its f32 gradient of the same weights,
  upcast), computed here. Seen on jax 0.9.0 and torch 2.13 on the CPU:
  the port 1.67e-2 to 3.70e-2 from the reference's bf16 gradient, the
  reference 1.79e-2 to 3.22e-2 from its f32 one; the closest,
  hymba-1.5b, 3.70e-2 against 2.95e-2 (a ratio of 1.25), deepseek-v2-236b
  2.48e-2 against 2.19e-2. Against the f32 gradient of the original f32
  weights instead, a looser yardstick, the reference's gap is larger
  (hymba-1.5b 3.78e-2, mamba2-2.7b 6.00e-2, llama3-8b 2.17e-2).
* The launcher's ``train`` program (sgd at lr 0.1, remat) in bf16 at
  smoke size, ``materialize``d from a seed, against the reference's jitted
  one on a (1, 1) mesh of the one CPU device from the same values, as
  ``tests/test_torch_launch.py`` does in f32, held to the same bound: the
  port's update (new weights less old, over the whole tree, relative L2)
  against the reference's bf16 and f32 updates within ``BF16_GAP`` times
  the reference's own bf16-vs-f32 gap, and the loss likewise. An update
  is measured in L2 because one sgd step moves a weight by about one bf16
  step of it, so two near-equal gradients round a few weights to
  neighbouring bf16 values (4% of them at llama3-8b-smoke), which a
  leaf's max would read as the whole update.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.config import ShapeConfig as JShape  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.model import init_lm_params as jinit  # noqa: E402
from repro.models.model import lm_loss as jlm_loss  # noqa: E402
from repro_torch.config import ShapeConfig, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.flatten import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models.model import lm_loss  # noqa: E402
from test_torch_lm_train import _loss_batch, _np, _torch_batch  # noqa: E402

# the port's bf16 gap against the reference's bf16 result, at most this
# many times the reference's own gap from its f32 result
BF16_GAP = 1.5


def _bf16(tree):
    """Floating leaves of a numpy tree as jax bf16 (round to nearest
    even, as torch's cast)."""
    return jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16)
                        if np.issubdtype(np.asarray(x).dtype, np.floating)
                        else jnp.asarray(x), tree)


def _worst_leaf(got: list, want: list) -> float:
    """The worst leaf's max |got - want| over max |want|, in f32."""
    gaps = []
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        gaps.append(float(np.abs(g - w).max() / max(np.abs(w).max(),
                                                     1e-30)))
    return max(gaps)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_bf16_lm_grad_within_the_references_bf16_noise(arch):
    jcfg = jget_arch(arch, smoke=True)
    cfg = get_arch(arch, smoke=True)
    params_np = _np(jinit(jcfg, jax.random.PRNGKey(0)))
    batch = _np(_loss_batch(jcfg, jax.random.PRNGKey(1)))
    jbatch = jax.tree.map(jnp.asarray, batch)
    jp16 = _bf16(params_np)
    jp32 = jax.tree.map(lambda x: x.astype(jnp.float32), jp16)
    jgrad = jax.jit(jax.grad(lambda p: jlm_loss(jcfg, p, jbatch)))
    want16 = [np.asarray(g).astype(np.float32)
              for g in jax.tree.leaves(jgrad(jp16))]
    want32 = [np.asarray(g) for g in jax.tree.leaves(jgrad(jp32))]

    params = tree_map(lambda t: t.to(torch.bfloat16),
                      params_from_numpy(params_np, device="cpu"))
    got = torch.func.grad(lambda p: lm_loss(cfg, p, _torch_batch(batch)))(
        params)
    got = tree_leaves(got)
    assert all(g.dtype == torch.bfloat16 for g in got)
    own = _worst_leaf(want16, want32)
    port = _worst_leaf([g.float().numpy() for g in got], want16)
    assert port <= BF16_GAP * own, (arch, port, own)


def _l2(a: list, b: list, base: list) -> float:
    """|| a - b || over || base ||, every leaf together."""
    num = sum(float(np.square(x - y).sum()) for x, y in zip(a, b))
    return (num / sum(float(np.square(z).sum()) for z in base)) ** 0.5


@pytest.mark.parametrize("arch", ["llama3-8b"])
def test_bf16_train_program_matches_the_reference(arch):
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    shape = ShapeConfig("smoke", 32, 4, "train")
    cfg = dataclasses.replace(get_arch(arch, smoke=True), dtype="bfloat16")
    jcfg = dataclasses.replace(jget_arch(arch, smoke=True), dtype="bfloat16")
    tprog = specs.materialize(specs.build_program(
        cfg, shape, AbstractMesh((1, 1), ("data", "model")), "train"),
        seed=3, device="cpu")
    state, batch = tprog.args
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(state.params))
    jprog = jspecs.build_program(
        jcfg, JShape(shape.name, shape.seq_len, shape.global_batch,
                     shape.kind), mesh, "train")
    old = params_to_numpy(tree_map(lambda t: t.float(), state.params))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def reference(dtype):
        jstate = jprog.args[0]._replace(
            params=jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), old),
            opt_state=jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   jprog.args[0].opt_state),
            step=jnp.zeros((), jnp.int32))
        with mesh:
            new, metrics = jax.jit(
                jprog.fn, in_shardings=jprog.in_shardings,
                out_shardings=jprog.out_shardings)(jstate, jbatch)
        return ([np.asarray(x).astype(np.float32) - o for x, o in zip(
            jax.tree.leaves(new.params), jax.tree.leaves(old))],
            float(metrics["loss"]))

    new, metrics = tprog.fn(state, batch)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(new.params))
    got = [t.float().numpy() - o for t, o in zip(tree_leaves(new.params),
                                                 jax.tree.leaves(old))]
    (want16, loss16), (want32, loss32) = (reference(t) for t in (
        jnp.bfloat16, jnp.float32))
    own = _l2(want16, want32, want32)
    assert _l2(got, want16, want32) <= BF16_GAP * own, arch
    assert _l2(got, want32, want32) <= BF16_GAP * own, arch
    loss = float(metrics["loss"])
    assert abs(loss - loss16) <= BF16_GAP * abs(loss16 - loss32), arch
    assert int(new.step) == 1
