"""Maximum-probability parameter generation (MLPG) trajectory smoothing.

Capability parity with the reference's bandmat-based implementation
(``idiaptts/misc/mlpg.py:29-127``): product-of-experts over the windows
``(1)``, ``(-0.5, 0, 0.5)`` and ``(1, -2, 1)`` with per-dimension diagonal
(co)variances and 1e11 boundary variances on the delta windows, solved via
a banded Cholesky factorisation.

Design: the precision matrix is symmetric pentadiagonal, so the
solve is a bandwidth-2 Cholesky factorisation plus forward/back
substitution expressed as ``lax.scan`` recurrences, vectorised over all
feature dimensions at once (the reference loops dimensions in Python and
re-factorises per dimension).  A scipy ``solveh_banded`` host
implementation is kept as the numerical reference for tests.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg

_WINDOWS = (
    np.array([0.0, 1.0, 0.0]),        # static
    np.array([-0.5, 0.0, 0.5]),       # delta (np.gradient convention)
    np.array([1.0, -2.0, 1.0]),       # delta-delta
)
_BOUNDARY_VAR = 1e11


def _window_variances(covariance, feature_dim, frames):
    """Per-window per-frame variances (frames, 3, D) with boundary
    overrides, from the diagonal of a (3D, 3D) covariance."""
    diag = np.diagonal(np.asarray(covariance, dtype=np.float64))
    var = np.empty((frames, 3, feature_dim))
    for w in range(3):
        var[:, w, :] = diag[w * feature_dim:(w + 1) * feature_dim]
    var[0, 1:, :] = _BOUNDARY_VAR
    var[-1, 1:, :] = _BOUNDARY_VAR
    return var


def _banded_precision_and_b(features, var):
    """Build the pentadiagonal precision (lower-banded storage) and b
    vector for every dimension at once.

    features: (T, 3, D) window means; var: (T, 3, D) variances.
    Returns ab (3, T, D) lower banded precision rows [diag, sub1, sub2]
    and b (T, D).
    """
    T, _, D = features.shape
    tau = 1.0 / var                       # precisions
    btau = features * tau                 # b-values
    ab = np.zeros((3, T, D))
    b = np.zeros((T, D))
    for w, coeff in enumerate(_WINDOWS):
        c = coeff  # offsets -1, 0, +1 relative to the frame
        # Window matrix W has W[t, t+k] = c[k+1] for k in (-1, 0, 1),
        # rows clipped at the boundaries.
        for k in (-1, 0, 1):
            rows = np.arange(max(0, -k), T - max(0, k))
            cols = rows + k
            b[cols] += c[k + 1] * btau[rows, w]
        # P += W^T diag(tau) W: band entries
        for i in (-1, 0, 1):
            for j in (-1, 0, 1):
                if j < i:
                    continue  # symmetric: store lower band only (j-i >= 0)
                band = j - i
                rows = np.arange(max(0, -i, -j), T - max(0, i, j))
                ab[band, rows + i] += c[i + 1] * c[j + 1] * tau[rows, w]
    return ab, b


def mlpg_numpy(features, covariance, feature_dim):
    """Host reference implementation via scipy.solveh_banded.

    features: (T, 3*feature_dim) as [static, delta, delta-delta];
    covariance: (3*feature_dim, 3*feature_dim).
    Returns the smoothed (T, feature_dim) trajectory.
    """
    features = np.asarray(features, dtype=np.float64)
    T = features.shape[0]
    feats = features.reshape(T, 3, feature_dim)
    var = _window_variances(covariance, feature_dim, T)
    ab, b = _banded_precision_and_b(feats, var)
    out = np.empty((T, feature_dim))
    for d in range(feature_dim):
        out[:, d] = scipy.linalg.solveh_banded(ab[:, :, d], b[:, d],
                                               lower=True)
    return out


# ---------------------------------------------------------------------------
# JAX path: batched bandwidth-2 Cholesky + substitutions as scans.
# ---------------------------------------------------------------------------

def _banded_system_jnp(features, variances):
    """jnp version of :func:`_banded_precision_and_b`.

    features: (T, 3, D); variances: (T, 3, D) -> ab (3, T, D), b (T, D).
    """
    T, _, D = features.shape
    tau = 1.0 / variances
    btau = features * tau

    def shift(x, k):
        """x[t] -> x[t - k] with zero fill (time axis 0)."""
        if k == 0:
            return x
        if k > 0:
            return jnp.concatenate([jnp.zeros((k,) + x.shape[1:], x.dtype),
                                    x[:-k]], axis=0)
        return jnp.concatenate([x[-k:],
                                jnp.zeros((-k,) + x.shape[1:], x.dtype)],
                               axis=0)

    b = jnp.zeros((T, D), btau.dtype)
    ab0 = jnp.zeros((T, D), btau.dtype)
    ab1 = jnp.zeros((T, D), btau.dtype)
    ab2 = jnp.zeros((T, D), btau.dtype)
    for w, coeff in enumerate(_WINDOWS):
        c = coeff
        for k in (-1, 0, 1):
            b = b + c[k + 1] * shift(btau[:, w], k)
        for i in (-1, 0, 1):
            for j in (-1, 0, 1):
                band = j - i
                if band < 0:
                    continue
                # Entry P[t+i, t+j] accumulates over window rows t:
                # stored at banded row `band`, index t+i.
                contrib = c[i + 1] * c[j + 1] * shift(tau[:, w], i)
                # Zero out rows where t or t+j were out of range.
                idx = jnp.arange(T)
                valid = ((idx - i >= 0) & (idx - i < T)
                         & (idx - i + j >= 0) & (idx - i + j < T))
                contrib = jnp.where(valid[:, None], contrib, 0.0)
                if band == 0:
                    ab0 = ab0 + contrib
                elif band == 1:
                    ab1 = ab1 + contrib
                else:
                    ab2 = ab2 + contrib
    return jnp.stack([ab0, ab1, ab2]), b


def _cholesky_banded_scan(ab):
    """Bandwidth-2 banded Cholesky, batched over trailing dim.

    ab: (3, T, D) lower-banded SPD rows -> L stored as (3, T, D):
    [diag, sub1, sub2] with L[t, t]=l0[t], L[t+1, t]=l1[t], L[t+2, t]=l2[t].
    """
    a0, a1, a2 = ab[0], ab[1], ab[2]
    D = a0.shape[1]

    def step(carry, inputs):
        # carry: (l1_prev, l2_prev, l0_prev, l0_prev2, l1_prev2)
        l1_pm1, l2_pm1, l0_pm1, l2_pm2 = carry
        a0t, a1t, a2t = inputs
        # d[t] = a0[t] - L[t,t-1]^2 - L[t,t-2]^2
        l0t = jnp.sqrt(jnp.maximum(a0t - l1_pm1 ** 2 - l2_pm2 ** 2, 1e-20))
        # L[t+1, t] = (a1[t] - L[t, t-1] * L[t+1, t-1]) / l0[t]
        l1t = (a1t - l1_pm1 * l2_pm1) / l0t
        l2t = a2t / l0t
        return (l1t, l2t, l0t, l2_pm1), (l0t, l1t, l2t)

    zeros = jnp.zeros((D,), a0.dtype)
    _, (l0, l1, l2) = jax.lax.scan(
        step, (zeros, zeros, zeros, zeros), (a0, a1, a2))
    return l0, l1, l2


def _solve_banded(l0, l1, l2, b):
    """Solve L L^T x = b via two scans; all (T, D)."""
    D = b.shape[1]
    zeros = jnp.zeros((D,), b.dtype)

    def fwd(carry, inputs):
        y_m1, y_m2 = carry
        bt, l0t, l1_m1, l2_m2 = inputs
        yt = (bt - l1_m1 * y_m1 - l2_m2 * y_m2) / l0t
        return (yt, y_m1), yt

    l1_shift = jnp.concatenate([jnp.zeros((1, D), b.dtype),
                                l1[:-1]])[:len(b)]
    # Clamp the 2-row zero pad for T < 3 so every scan input keeps the
    # same leading axis (single-frame utterances crashed otherwise).
    l2_shift = jnp.concatenate([jnp.zeros((2, D), b.dtype),
                                l2[:max(0, len(b) - 2)]])[:len(b)]
    _, y = jax.lax.scan(fwd, (zeros, zeros), (b, l0, l1_shift, l2_shift))

    def bwd(carry, inputs):
        x_p1, x_p2 = carry
        yt, l0t, l1t, l2t = inputs
        xt = (yt - l1t * x_p1 - l2t * x_p2) / l0t
        return (xt, x_p1), xt

    _, x_rev = jax.lax.scan(
        bwd, (zeros, zeros), (y[::-1], l0[::-1], l1[::-1], l2[::-1]))
    return x_rev[::-1]


@partial(jax.jit, static_argnames=("feature_dim",))
def mlpg_jax(features, variances, feature_dim):
    """On-device MLPG.

    features: (T, 3*feature_dim) [static, delta, delta-delta] means;
    variances: (3*feature_dim,) diagonal variances.
    Returns (T, feature_dim) smoothed trajectory.  All feature dims are
    solved simultaneously (single scan, D-vectorised inner ops).
    """
    T = features.shape[0]
    feats = features.reshape(T, 3, feature_dim).astype(jnp.float64
                                                       if jax.config.read("jax_enable_x64")
                                                       else jnp.float32)
    var_row = variances.reshape(3, feature_dim)
    var = jnp.broadcast_to(var_row[None], (T, 3, feature_dim))
    # Override delta/delta-delta variances at the first and last frame.
    var = var.at[0, 1:, :].set(_BOUNDARY_VAR)
    var = var.at[-1, 1:, :].set(_BOUNDARY_VAR)
    ab, b = _banded_system_jnp(feats, var)
    l0, l1, l2 = _cholesky_banded_scan(ab)
    return _solve_banded(l0, l1, l2, b)


# ---------------------------------------------------------------------------
# Fast path: factor once per (T, variances), solve with associative scans.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("feature_dim", "num_frames"))
def mlpg_factorise(variances, feature_dim, num_frames):
    """Precompute the banded Cholesky factors (3, T, D).

    The precision matrix depends only on the (time-invariant) variances
    and the frame count, NOT on the features — so production synthesis
    factorises once per length bucket and reuses the factors for every
    utterance/batch."""
    T = num_frames
    var_row = variances.reshape(3, feature_dim)
    var = jnp.broadcast_to(var_row[None], (T, 3, feature_dim))
    var = var.at[0, 1:, :].set(_BOUNDARY_VAR)
    var = var.at[-1, 1:, :].set(_BOUNDARY_VAR)
    ab, _ = _banded_system_jnp(jnp.zeros((T, 3, feature_dim)), var)
    l0, l1, l2 = _cholesky_banded_scan(ab)
    tau = 1.0 / var                                   # (T, 3, D)
    return jnp.stack([l0, l1, l2]), tau


@partial(jax.jit, static_argnames=("feature_dim", "kernel"))
def mlpg_solve(features, factors, tau, feature_dim, kernel=None):
    """MLPG with precomputed Cholesky factors: only the two
    substitutions run per utterance (the factorisation — a third of the
    sequential work — is amortised across the corpus).  On a single GPU
    they run as one Triton kernel (``ops/pallas_mlpg.py``), elsewhere as
    two ``lax.scan``s.

    features: (..., T, 3*feature_dim); factors: (3, T, D) from
    :func:`mlpg_factorise`.  Batched over leading dims.  ``kernel``:
    None chooses by backend, True/False forces the kernel or the scans.
    """
    l0, l1, l2 = factors[0], factors[1], factors[2]
    T = features.shape[-2]
    feats = features.reshape(features.shape[:-2] + (T, 3, feature_dim))
    btau = feats * tau

    def shift(x, k):
        pad = [(0, 0)] * (x.ndim - 2)
        if k > 0:
            return jnp.pad(x, pad + [(k, 0), (0, 0)])[..., :-k, :]
        if k < 0:
            return jnp.pad(x, pad + [(0, -k), (0, 0)])[..., -k:, :]
        return x

    b = jnp.zeros(feats.shape[:-2] + (feature_dim,), feats.dtype)
    for w, coeff in enumerate(_WINDOWS):
        for k in (-1, 0, 1):
            b = b + coeff[k + 1] * shift(btau[..., w, :], k)

    from idiaptts_tpu.ops import pallas_mlpg
    if b.ndim == 2:
        flat = b[None]
    else:
        flat = b.reshape(-1, T, feature_dim)
    B = flat.shape[0]
    # One solve with batch folded into the vector dim (fewer sequential
    # steps than vmap-of-scans): layout (T, B*D).
    moved = jnp.moveaxis(flat, 0, 1).reshape(T, B * feature_dim)
    l0_t = jnp.tile(l0, (1, B))
    l1_t = jnp.tile(l1, (1, B))
    l2_t = jnp.tile(l2, (1, B))
    if kernel is None:
        kernel = pallas_mlpg.use_solve_kernel()
    if kernel:
        solved = pallas_mlpg.solve_banded_pallas(moved, l0_t, l1_t, l2_t)
    else:
        solved = _solve_banded(l0_t, l1_t, l2_t, moved)
    return jnp.moveaxis(solved.reshape(T, B, feature_dim), 1,
                        0).reshape(b.shape)


class MLPG:
    """API-compatible front door (reference ``MLPG.generation``,
    mlpg.py:94-127)."""

    def generation(self, features, covariance, feature_dim, backend="jax"):
        if backend == "numpy":
            return mlpg_numpy(features, covariance, feature_dim)
        variances = np.ascontiguousarray(
            np.diagonal(np.asarray(covariance, dtype=np.float32)))
        out = mlpg_jax(jnp.asarray(features, dtype=jnp.float32),
                       jnp.asarray(variances), feature_dim)
        return np.asarray(out)
