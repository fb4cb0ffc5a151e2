"""The MLPG substitution kernel (Triton route; interpret mode on the CPU)
against float64 scipy MLPG, and the choice between kernel and scans."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from idiaptts_tpu.ops import pallas_mlpg
from idiaptts_tpu.ops.mlpg import (_solve_banded, mlpg_factorise,
                                   mlpg_numpy, mlpg_solve)


def _problem(T, F, B, seed=0):
    rs = np.random.RandomState(seed)
    static = np.cumsum(rs.randn(B, T, F) * 0.1, axis=1)
    delta = np.gradient(static, axis=1) if T > 1 else np.zeros_like(static)
    delta2 = np.gradient(delta, axis=1) if T > 1 else np.zeros_like(static)
    feats = np.concatenate([static, delta, delta2], axis=-1)
    feats = (feats + rs.randn(*feats.shape) * 0.01).astype(np.float32)
    var = (rs.rand(3 * F) * 0.5 + 0.05).astype(np.float32)
    return feats, var


def _solve_with_kernel(monkeypatch, feats, var, F):
    """mlpg_solve forced through the kernel, run in interpret mode."""
    T = feats.shape[1]
    monkeypatch.setattr(pallas_mlpg, "solve_banded_pallas", functools.partial(
        pallas_mlpg.solve_banded_pallas, interpret=True))
    factors, tau = mlpg_factorise(jnp.asarray(var), F, T)
    return np.asarray(mlpg_solve.__wrapped__(jnp.asarray(feats), factors,
                                             tau, F, kernel=True))


# (T, F, B): T < 3; lane counts L = B*F below one 32-lane block, at
# it, and past it with a ragged (padded) last block.
@pytest.mark.parametrize("T,F,B", [
    (1, 3, 1), (2, 3, 2), (3, 5, 1), (17, 4, 3), (64, 22, 2),
    (33, 7, 5), (50, 16, 2), (40, 22, 4)])
def test_kernel_matches_mlpg_numpy(monkeypatch, T, F, B):
    feats, var = _problem(T, F, B, seed=T + F + B)
    got = _solve_with_kernel(monkeypatch, feats, var, F)
    assert got.shape == (B, T, F)
    cov = np.diag(var.astype(np.float64))
    ref = np.stack([mlpg_numpy(feats[b], cov, F) for b in range(B)])
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= 1e-4 * scale


def test_kernel_equals_scans_bit_for_bit():
    """Same operations in the same order as ``_solve_banded``."""
    T, D, B = 29, 6, 7
    rs = np.random.RandomState(3)
    var = jnp.asarray(np.abs(rs.randn(3 * D)).astype(np.float32) + 0.1)
    factors, _ = mlpg_factorise(var, D, T)
    l0, l1, l2 = (jnp.tile(factors[i], (1, B)) for i in range(3))
    b = jnp.asarray(rs.randn(T, B * D).astype(np.float32))
    got = pallas_mlpg.solve_banded_pallas(b, l0, l1, l2, interpret=True)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(_solve_banded(l0, l1, l2, b)))


def _fake_backend(monkeypatch, platform, count):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(jax, "device_count", lambda: count)


def test_plain_scans_on_cpu():
    assert jax.default_backend() == "cpu"
    assert not pallas_mlpg.use_solve_kernel()


def test_kernel_on_a_single_gpu(monkeypatch):
    _fake_backend(monkeypatch, "gpu", 1)
    assert pallas_mlpg.use_solve_kernel()


def test_plain_scans_on_several_gpus(monkeypatch):
    _fake_backend(monkeypatch, "gpu", 4)
    assert not pallas_mlpg.use_solve_kernel()


def test_plain_scans_under_cpu_default_device(monkeypatch):
    _fake_backend(monkeypatch, "gpu", 1)
    with jax.default_device(jax.devices("cpu")[0]):
        assert not pallas_mlpg.use_solve_kernel()


@pytest.mark.parametrize("gate", [True, False])
def test_mlpg_solve_follows_the_gate(monkeypatch, gate):
    calls = []
    real = pallas_mlpg.solve_banded_pallas

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, interpret=True, **kwargs)

    monkeypatch.setattr(pallas_mlpg, "use_solve_kernel", lambda: gate)
    monkeypatch.setattr(pallas_mlpg, "solve_banded_pallas", spy)
    feats, var = _problem(12, 3, 2)
    factors, tau = mlpg_factorise(jnp.asarray(var), 3, 12)
    got = mlpg_solve.__wrapped__(jnp.asarray(feats), factors, tau, 3)
    assert len(calls) == (1 if gate else 0)
    ref = mlpg_solve.__wrapped__(jnp.asarray(feats), factors, tau, 3,
                                 kernel=False)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.gpu
def test_compiled_kernel_matches_scans_on_gpu():
    feats, var = _problem(2048, 22, 9)
    factors, tau = mlpg_factorise(jnp.asarray(var), 22, 2048)
    got = mlpg_solve(jnp.asarray(feats), factors, tau, 22, kernel=True)
    ref = mlpg_solve(jnp.asarray(feats), factors, tau, 22, kernel=False)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
