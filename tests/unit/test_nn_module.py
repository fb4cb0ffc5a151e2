"""The plain-JAX module system (models/nn.py): naming, random streams,
collections and lifted loops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from idiaptts_tpu.models import nn


class _Two(nn.Module):
    def __call__(self, x):
        return nn.Dense(3)(nn.Dense(4)(x))


class _Holder(nn.Module):
    inner: nn.Module
    parts: tuple

    def __call__(self, x):
        x = self.inner(x)
        for part in self.parts:
            x = part(x)
        return x


def test_submodule_names_follow_class_counters_and_fields():
    x = jnp.ones((2, 5))
    params = _Two().init(jax.random.PRNGKey(0), x)["params"]
    assert set(params) == {"Dense_0", "Dense_1"}
    holder = _Holder(inner=nn.Dense(4), parts=(nn.Dense(4), nn.Dense(2)))
    params = holder.init(jax.random.PRNGKey(0), x)["params"]
    assert set(params) == {"inner", "parts_0", "parts_1"}


def test_parameter_keys_fold_in_the_scope_path():
    """A parameter's key is the root key folded with the SHA-1 of
    (scope names..., per-scope counter).  Names count at construction:
    in ``Dense(3)(Dense(4)(x))`` the outer layer is built first."""
    key = jax.random.PRNGKey(7)
    params = _Two().init(key, jnp.ones((1, 5)))["params"]
    want = jax.nn.initializers.lecun_normal()(
        nn._fold_in_static(key, ("Dense_1", 1)), (5, 4), jnp.float32)
    np.testing.assert_array_equal(params["Dense_1"]["kernel"], want)


def test_apply_needs_every_parameter():
    model = _Two()
    params = model.init(jax.random.PRNGKey(0), jnp.ones((1, 5)))
    del params["params"]["Dense_1"]["bias"]
    with pytest.raises(ValueError, match="missing parameter"):
        model.apply(params, jnp.ones((1, 5)))


class _Sower(nn.Module):
    def __call__(self, x):
        self.sow("intermediates", "seen", x)
        return nn.BatchNorm(use_running_average=False)(x)


def test_collections_are_written_only_when_mutable():
    x = jnp.asarray(np.random.RandomState(0).randn(8, 3), jnp.float32)
    model = _Sower()
    variables = model.init(jax.random.PRNGKey(0), x)
    assert "intermediates" not in variables
    np.testing.assert_array_equal(
        variables["batch_stats"]["BatchNorm_0"]["mean"], np.zeros(3))
    out, updates = model.apply(variables, x,
                               mutable=["intermediates", "batch_stats"])
    assert updates["intermediates"]["seen"][0] is not None
    mean = updates["batch_stats"]["BatchNorm_0"]["mean"]
    np.testing.assert_allclose(mean, 0.01 * np.asarray(x).mean(axis=0),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="not mutable"):
        model.apply(variables, x)


class _Step(nn.Module):
    def __call__(self, carry, x):
        h = jnp.tanh(nn.Dense(carry.shape[-1], name="cell")(x) + carry)
        return h, h


def test_scan_shares_parameters_across_steps():
    scanned = nn.scan(_Step, in_axes=1, out_axes=1)

    class Loop(nn.Module):
        def __call__(self, xs):
            return scanned(name="loop")(jnp.zeros((xs.shape[0], 4)), xs)

    xs = jnp.asarray(np.random.RandomState(1).randn(2, 6, 3), jnp.float32)
    variables = Loop().init(jax.random.PRNGKey(0), xs)
    assert set(variables["params"]["loop"]) == {"cell"}
    _, ys = Loop().apply(variables, xs)
    p = variables["params"]["loop"]["cell"]
    h = np.zeros((2, 4), np.float32)
    for t in range(6):
        h = np.tanh(np.asarray(xs[:, t]) @ np.asarray(p["kernel"])
                    + np.asarray(p["bias"]) + h)
        np.testing.assert_allclose(np.asarray(ys[:, t]), h, atol=1e-5)


def test_dropout_draws_from_its_stream():
    class Drop(nn.Module):
        def __call__(self, x, training):
            return nn.Dropout(0.5, deterministic=not training)(x)

    x = jnp.ones((64,))
    assert np.array_equal(Drop().apply({}, x, False), x)
    a = Drop().apply({}, x, True, rngs={"dropout": jax.random.PRNGKey(1)})
    b = Drop().apply({}, x, True, rngs={"dropout": jax.random.PRNGKey(1)})
    np.testing.assert_array_equal(a, b)
    assert set(np.unique(np.asarray(a))) <= {0.0, 2.0}
    with pytest.raises(ValueError, match="PRNG"):
        Drop().apply({}, x, True)
