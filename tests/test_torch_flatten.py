"""The port's fleet plane and weight carrier against the reference.

The plane's column order and offsets must equal the reference's
``FleetAdapter`` (``jax.tree`` leaf order, HWIO conv weights), so planes
built from the same weights are equal bit for bit, and weights carried
across by ``repro_torch.convert`` come back unchanged.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core import flatten as jflatten  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import flatten  # noqa: E402

MODELS = [("mnist_cnn", False), ("mnist_cnn", True), ("drift_mlp", False)]


@functools.lru_cache(maxsize=None)
def _ref_fleet(name, smoke, m=3):
    """m reference-drawn models (one key each), stacked, as numpy (cached:
    callers only read them)."""
    cfg = jget_arch(name, smoke=smoke)
    keys = jax.random.split(jax.random.PRNGKey(7), m)
    models = [jinit(cfg, k) for k in keys]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *models)
    return stacked, jax.tree.map(np.asarray, stacked)


@pytest.mark.parametrize("name,smoke", MODELS)
def test_plane_layout_equals_reference(name, smoke):
    stacked, np_stacked = _ref_fleet(name, smoke)
    want = jflatten.fleet_adapter(stacked)
    model = params_from_numpy(jax.tree.map(lambda x: x[0], np_stacked),
                              device="cpu")
    got = flatten.fleet_adapter(model)
    assert got.offsets == want.offsets
    assert got.sizes == want.sizes
    assert got.shapes == want.shapes
    assert got.P == want.P
    assert got.plane_dtype == torch.float32


def test_mnist_cnn_plane_offsets():
    """Table 1's 1,199,882 weights; each layer's b before its w."""
    _, np_stacked = _ref_fleet("mnist_cnn", False, m=1)
    ad = flatten.fleet_adapter(
        params_from_numpy(jax.tree.map(lambda x: x[0], np_stacked),
                          device="cpu"))
    assert ad.offsets == (0, 32, 320, 384, 18816, 18944, 1198592, 1198602)
    assert ad.P == 1_199_882
    assert ad.shapes[:2] == ((32,), (3, 3, 1, 32))      # b, then HWIO w


@pytest.mark.parametrize("name,smoke", MODELS)
def test_plane_equals_reference_ravel_bitwise(name, smoke):
    stacked, np_stacked = _ref_fleet(name, smoke)
    want = np.asarray(jflatten.fleet_adapter(stacked).ravel(stacked))
    fleet = params_from_numpy(np_stacked, device="cpu")
    ad = flatten.fleet_adapter(jax.tree.map(lambda x: x[0], fleet))
    X = ad.ravel(fleet)
    np.testing.assert_array_equal(X.numpy(), want)
    row = ad.ravel_model(params_from_numpy(
        jax.tree.map(lambda x: x[1], np_stacked), device="cpu"))
    np.testing.assert_array_equal(row.numpy(), want[1])


def test_unravel_views_alias_the_plane():
    _, np_stacked = _ref_fleet("mnist_cnn", True)
    fleet = params_from_numpy(np_stacked, device="cpu")
    ad = flatten.fleet_adapter(jax.tree.map(lambda x: x[0], fleet))
    X = ad.ravel(fleet)
    views = ad.unravel(X)
    for got, want in zip(flatten.tree_leaves(views),
                         flatten.tree_leaves(fleet)):
        assert torch.equal(got, want)
    X.mul_(2.0)
    assert torch.equal(views["layers"][0]["w"], 2.0 * fleet["layers"][0]["w"])


@pytest.mark.parametrize("name,smoke", MODELS)
def test_weights_round_trip_bitwise(name, smoke):
    _, np_stacked = _ref_fleet(name, smoke)
    back = params_to_numpy(params_from_numpy(np_stacked, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(np_stacked)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_stacked)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_tree_walk_matches_jax_leaf_order():
    tree = {"z": [np.ones(2), {}, {"w": np.zeros(3), "b": np.full(1, 5.0)}],
            "a": (np.arange(4.0), None)}
    got = flatten.tree_leaves(tree)
    want = jax.tree.leaves(tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rebuilt = flatten.tree_unflatten(flatten.tree_structure(tree), got)
    assert jax.tree.structure(rebuilt) == jax.tree.structure(tree)


def test_mixed_dtypes_promote_and_round_trip():
    """bf16 + f32 leaves: an f32 plane, both packages; bf16 carried across
    by its bits and narrowed back exactly."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    jtree = {"a": jax.random.normal(k1, (2, 5), jnp.bfloat16),
             "b": jax.random.normal(k2, (2, 3), jnp.float32)}
    np_tree = jax.tree.map(np.asarray, jtree)
    fleet = params_from_numpy(np_tree, device="cpu")
    assert fleet["a"].dtype == torch.bfloat16
    ad = flatten.fleet_adapter(jax.tree.map(lambda x: x[0], fleet))
    assert ad.plane_dtype == torch.float32
    X = ad.ravel(fleet)
    want = np.asarray(jflatten.fleet_adapter(jtree).ravel(jtree))
    np.testing.assert_array_equal(X.numpy(), want)
    back = ad.unravel(X)
    assert back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"], fleet["a"])
    np.testing.assert_array_equal(params_to_numpy(back)["a"],
                                  np.asarray(jtree["a"], np.float32))


def test_non_float_leaves_are_rejected():
    with pytest.raises(TypeError, match="floating-point"):
        flatten.fleet_adapter({"w": torch.zeros(3),
                               "n": torch.zeros(2, dtype=torch.int32)})
    with pytest.raises(TypeError, match="floating-point"):
        jflatten.fleet_adapter({"w": jnp.zeros((1, 3)),
                                "n": jnp.zeros((1, 2), jnp.int32)})
