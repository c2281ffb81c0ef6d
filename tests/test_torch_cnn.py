"""The port's models and optimizers against the reference.

Reference-drawn parameters (``init_cnn_params``) and batches (the
reference's data sources) go through both packages. Forward passes
(logits, ``cnn_loss``) agree to rtol 1e-5 / atol 1e-6; gradients from
autograd and ``jax.grad`` to rtol 1e-4 / atol 1e-6 (the backward pass
sums over the batch and the spatial taps in another order). Each
optimizer takes two steps on a plane with weight decay and is held
against ``repro.optim`` at rtol 1e-6 / atol 1e-7.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.data.synthetic import GraphicalModelStream, SyntheticMNIST  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch.config import TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.flatten import tree_leaves  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402

CASES = [("mnist_cnn", True, 8), ("drift_mlp", False, 8),
         ("mnist_cnn", False, 4)]


def _case(name, smoke, batch):
    jcfg = jget_arch(name, smoke=smoke)
    cfg = get_arch(name, smoke=smoke)
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    jparams = jcnn.init_cnn_params(jcfg, k1)
    if name == "drift_mlp":
        src = GraphicalModelStream(seed=0, drift_prob=0.0)
    else:
        src = SyntheticMNIST(seed=0, image_size=jcfg.input_shape[0])
    jbatch = src.sample(k2, batch)
    np_params = jax.tree.map(np.asarray, jparams)
    np_batch = jax.tree.map(np.asarray, jbatch)
    params = params_from_numpy(np_params, device="cpu")
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}
    return jcfg, cfg, jparams, jbatch, params, tbatch


@pytest.mark.parametrize("name,smoke,batch", CASES)
def test_forward_matches_reference(name, smoke, batch):
    jcfg, cfg, jparams, jbatch, params, tbatch = _case(name, smoke, batch)
    want = np.asarray(jcnn.cnn_apply(jcfg, jparams, jbatch["x"]))
    got = cnn.cnn_apply(cfg, params, tbatch["x"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(cnn.cnn_loss(cfg, params, tbatch)),
        float(jcnn.cnn_loss(jcfg, jparams, jbatch)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(cnn.cnn_accuracy(cfg, params, tbatch)),
        float(jcnn.cnn_accuracy(jcfg, jparams, jbatch)), rtol=0, atol=0)


@pytest.mark.parametrize("name,smoke,batch", CASES)
def test_gradients_match_reference(name, smoke, batch):
    jcfg, cfg, jparams, jbatch, params, tbatch = _case(name, smoke, batch)
    want = jax.grad(lambda p: jcnn.cnn_loss(jcfg, p, jbatch))(jparams)
    got = torch.func.grad(lambda p: cnn.cnn_loss(cfg, p, tbatch))(params)
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def test_init_shapes_and_weight_count():
    """The port's own init draws the reference's shapes: Table 1's
    1,199,882 weights for mnist_cnn."""
    cfg = get_arch("mnist_cnn")
    gen = torch.Generator().manual_seed(0)
    params = cnn.init_cnn_params(cfg, gen)
    jparams = jax.eval_shape(
        lambda k: jcnn.init_cnn_params(jget_arch("mnist_cnn"), k),
        jax.random.PRNGKey(0))
    got = [tuple(x.shape) for x in tree_leaves(params)]
    assert got == [x.shape for x in jax.tree.leaves(jparams)]
    assert sum(x.numel() for x in tree_leaves(params)) == 1_199_882
    conv_w = params["layers"][0]["w"]
    lim = (6.0 / (3 * 3 * (1 + 32))) ** 0.5
    assert float(conv_w.abs().max()) <= lim


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam", "rmsprop"])
def test_optimizer_steps_match_reference(opt):
    """Two steps on an (m, P) plane with weight decay."""
    rng = np.random.default_rng(5)
    X0 = rng.standard_normal((3, 257), dtype=np.float32)
    grads = [rng.standard_normal((3, 257), dtype=np.float32)
             for _ in range(2)]
    kw = dict(optimizer=opt, learning_rate=0.05, momentum=0.8,
              weight_decay=1e-3)
    jopt = jmake_optimizer(JTrainConfig(**kw))
    jX = jnp.asarray(X0)
    jstate = jopt.init(jX)
    topt = make_optimizer(TrainConfig(**kw))
    X = torch.from_numpy(X0.copy())
    state = topt.init(X)
    for g in grads:
        jX, jstate = jopt.update(jX, jnp.asarray(g), jstate)
        X, state = topt.update(X, torch.from_numpy(g.copy()), state)
    assert state.step == int(jstate.step) == 2
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=1e-6,
                               atol=1e-7)
    for name in ("mu", "nu"):
        a, b = getattr(state, name), getattr(jstate, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_optimizer_updates_the_plane_in_place():
    X = torch.ones(2, 4)
    views = X[:, 1:3]
    opt = make_optimizer(TrainConfig(optimizer="momentum",
                                     learning_rate=0.5))
    state = opt.init(X)
    X2, state = opt.update(X, torch.ones(2, 4), state)
    assert X2 is X
    assert torch.equal(views, torch.full((2, 2), 0.5))
