import numpy as np

from idiaptts_tpu.ops.mlpg import MLPG, mlpg_jax, mlpg_numpy


def _make_problem(T=40, D=3, seed=0):
    rng = np.random.RandomState(seed)
    static = np.cumsum(rng.randn(T, D) * 0.1, axis=0)
    delta = np.gradient(static, axis=0)
    delta2 = np.gradient(delta, axis=0)
    features = np.concatenate([static, delta, delta2], axis=1)
    var = rng.rand(3 * D) * 0.5 + 0.1
    covariance = np.diag(var)
    return features.astype(np.float32), covariance.astype(np.float32)


def test_mlpg_numpy_against_dense_solve():
    """Banded scipy path equals an explicit dense product-of-experts
    solve built from the reference's window definitions."""
    T, D = 25, 2
    features, covariance = _make_problem(T, D, seed=3)
    out = mlpg_numpy(features, covariance, D)

    windows = [np.array([0.0, 1.0, 0.0]), np.array([-0.5, 0.0, 0.5]),
               np.array([1.0, -2.0, 1.0])]
    for d in range(D):
        P = np.zeros((T, T))
        b = np.zeros(T)
        var = [covariance[w * D + d, w * D + d] for w in range(3)]
        for w, coeff in enumerate(windows):
            W = np.zeros((T, T))
            for t in range(T):
                for k in (-1, 0, 1):
                    if 0 <= t + k < T:
                        W[t, t + k] = coeff[k + 1]
            tau = np.full(T, 1.0 / var[w])
            if w > 0:
                tau[0] = 1e-11
                tau[-1] = 1e-11
            mean = features[:, w * D + d].astype(np.float64)
            P += W.T @ np.diag(tau) @ W
            b += W.T @ (mean * tau)
        expected = np.linalg.solve(P, b)
        np.testing.assert_allclose(out[:, d], expected, rtol=1e-6, atol=1e-6)


def test_mlpg_jax_matches_numpy():
    features, covariance = _make_problem(T=60, D=4, seed=1)
    ref = mlpg_numpy(features, covariance, 4)
    var = np.ascontiguousarray(np.diagonal(covariance))
    got = np.asarray(mlpg_jax(features, var, 4))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_mlpg_smooths_noise():
    """MLPG with consistent deltas should reduce frame-to-frame jitter."""
    T = 100
    rng = np.random.RandomState(5)
    clean = np.sin(np.linspace(0, 6, T))[:, None]
    noisy = clean + rng.randn(T, 1) * 0.15
    delta = np.gradient(clean, axis=0)
    delta2 = np.gradient(delta, axis=0)
    features = np.concatenate([noisy, delta, delta2], axis=1)
    covariance = np.diag([0.05, 0.001, 0.001])
    out = MLPG().generation(features, covariance, 1, backend="numpy")
    jitter_in = np.mean(np.abs(np.diff(noisy[:, 0])))
    jitter_out = np.mean(np.abs(np.diff(out[:, 0])))
    assert jitter_out < jitter_in * 0.5
    # Stays close to the clean trajectory.
    assert np.sqrt(np.mean((out - clean) ** 2)) < \
        np.sqrt(np.mean((noisy - clean) ** 2))


def test_mlpg_class_api():
    features, covariance = _make_problem(T=30, D=2, seed=7)
    out = MLPG().generation(features, covariance, 2)
    assert out.shape == (30, 2)


def test_mlpg_factorised_solve_matches_numpy():
    """Precomputed-factor path (production synthesis) equals the full
    solve."""
    import jax.numpy as jnp
    from idiaptts_tpu.ops.mlpg import mlpg_factorise, mlpg_solve
    features, covariance = _make_problem(T=80, D=3, seed=11)
    var = np.ascontiguousarray(np.diagonal(covariance))
    factors, tau = mlpg_factorise(jnp.asarray(var), 3, 80)
    ref = mlpg_numpy(features, covariance, 3)
    # Single utterance.
    out1 = np.asarray(mlpg_solve(jnp.asarray(features), factors, tau, 3))
    np.testing.assert_allclose(out1, ref, atol=5e-3)
    # Batched path (batch folded into the scan lanes).
    batch = np.stack([features, features * 0.5])
    out2 = np.asarray(mlpg_solve(jnp.asarray(batch), factors, tau, 3))
    np.testing.assert_allclose(out2[0], ref, atol=5e-3)
    np.testing.assert_allclose(out2[1], np.asarray(out1) * 0.5,
                               atol=5e-3)


def test_solve_banded_pallas_matches_scan():
    """Substitution-only Triton kernel vs the scan solve (interpret
    mode on CPU), on a factor-once batched problem."""
    import jax.numpy as jnp
    from idiaptts_tpu.ops.mlpg import (_solve_banded, mlpg_factorise)
    from idiaptts_tpu.ops.pallas_mlpg import solve_banded_pallas

    T, D, B = 50, 4, 3
    rs = np.random.RandomState(7)
    var = np.abs(rs.randn(3 * D)).astype(np.float32) + 0.1
    factors, _ = mlpg_factorise(jnp.asarray(var), D, T)
    l0, l1, l2 = factors[0], factors[1], factors[2]
    b = jnp.asarray(rs.randn(T, B * D).astype(np.float32))
    l0_t = jnp.tile(l0, (1, B))
    l1_t = jnp.tile(l1, (1, B))
    l2_t = jnp.tile(l2, (1, B))
    ref = _solve_banded(l0_t, l1_t, l2_t, b)
    out = solve_banded_pallas(b, l0_t, l1_t, l2_t, interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
