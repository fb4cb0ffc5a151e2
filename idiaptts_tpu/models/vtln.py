"""Neural vocal tract length normalisation (VTLN): all-pass warping.

Capability parity with the reference's VTLN stack
(``layers/AllPassWarp.py`` :20-221 — closed-form 3-D polynomial tensor
``gen_w_matrix_3d`` :39-78, alpha-polynomial einsum warp matrix
:186-205, bmm application with c0 halving :148-173, alpha composition
law ((a1+a2)/(1+a1*a2)) :175-184; ``layers/AllPassWarpLayer.py``
:36-200 — per-frame alpha from linear+tanh layers x range, gradient
scaling, denorm -> warp -> renorm; ``pytorch/GradientScaling.py``
:13-41).

Design: the warp matrix per frame is one einsum between the
precomputed polynomial tensor ``W (n, n, 2n)`` and the alpha power
vector — matmul work, no per-frame Python.  The polynomial tensor is
built by the exact Oppenheim recursion on polynomial coefficients
(numerically stable, no factorials).
"""

from functools import lru_cache

from idiaptts_tpu.models import nn
import jax
import jax.numpy as jnp
import numpy as np

from idiaptts_tpu.models.config import ModelConfig
from idiaptts_tpu.models.named import merge_inputs


@lru_cache(maxsize=None)
def gen_w_matrix_3d(n):
    """Polynomial coefficient tensor W (n, n, 2n): the all-pass warp
    matrix is ``M(alpha)[r, c] = sum_k W[r, c, k] * alpha^k``.

    Built via the recursion m[r][c] = m[r-1][c-1]
    + alpha * (m[r-1][c] - m[r][c-1]) with m[r][0] = alpha^r
    (AllPassWarp.gen_warp_matrix_recursively :82-95 semantics), carried
    out on polynomial coefficients so it is exact."""
    max_poly = 2 * n
    W = np.zeros((n, n, max_poly))
    # m[r][c] polynomial coefficients.
    W[0, 0, 0] = 1.0
    for r in range(1, n):
        if r < max_poly:
            W[r, 0, r] = 1.0  # alpha^r
    for c in range(1, n):
        for r in range(1, n):
            poly = np.copy(W[r - 1, c - 1])
            shift = np.zeros(max_poly)
            diff = W[r - 1, c] - W[r, c - 1]
            shift[1:] = diff[:-1]  # multiply by alpha
            W[r, c] = poly + shift
    return W.astype(np.float32)


def alpha_powers(alphas, max_polynomial):
    """(..., 1) alphas -> (..., max_polynomial) [1, a, a^2, ...]."""
    a = jnp.cumprod(jnp.broadcast_to(
        alphas, alphas.shape[:-1] + (max_polynomial - 1,)), axis=-1)
    ones = jnp.ones(alphas.shape[:-1] + (1,), alphas.dtype)
    return jnp.concatenate([ones, a], axis=-1)


def get_warp_matrix(alphas, n):
    """alphas (..., 1) -> warp matrices (..., n, n) via one einsum.

    ``Precision.HIGHEST`` keeps the polynomial contraction in true f32
    (a default-precision bf16 or TF32 matmul breaks the exact
    identity warp at alpha=0); the op is tiny, the cost is nil."""
    W = jnp.asarray(gen_w_matrix_3d(n))          # (n, n, 2n)
    powers = alpha_powers(alphas, 2 * n)         # (..., 2n)
    return jnp.einsum("ijk,...k->...ij", W, powers,
                      precision=jax.lax.Precision.HIGHEST)


def combine_warping_parameters(alphas):
    """Composition law of successive all-pass warps
    (:175-184): (a1 + a2) / (1 + a1 * a2)."""
    if isinstance(alphas, (list, tuple)):
        out = alphas[0]
        for a in alphas[1:]:
            out = (out + a) / (1.0 + out * a)
        return out
    return alphas


def all_pass_warp(features, alphas, warp_matrix_size):
    """Warp cepstral features (B, T, K*n) by per-frame alphas (B, T, 1).

    Every consecutive block of n coefficients (e.g. statics, deltas,
    delta-deltas) is warped by the same per-frame matrix; c0-type
    entries are halved before and doubled after (single-sided
    spectrogram adaptation, :163-171)."""
    n = warp_matrix_size
    B, T, D = features.shape
    num_blocks = D // n
    warp = get_warp_matrix(alphas, n)            # (B, T, n, n)
    x = features
    # Halve the first coefficient of each block.
    c0_scale = jnp.ones(D).at[jnp.arange(0, min(3 * n, D), n)].set(0.5)
    x = x * c0_scale
    blocks = x[..., :num_blocks * n].reshape(B, T, num_blocks, n)
    warped = jnp.einsum("btkn,btnm->btkm", blocks, warp,
                        precision=jax.lax.Precision.HIGHEST)
    out = warped.reshape(B, T, num_blocks * n)
    if D > num_blocks * n:
        out = jnp.concatenate([out, x[..., num_blocks * n:]], axis=-1)
    out = out / c0_scale
    return out


@jax.custom_vjp
def grad_scale(x, lmbda):
    """Identity forward, gradient scaled by lmbda on backward
    (GradientScaling.py:13-41 role; used to boost alpha-layer
    gradients)."""
    return x


def _grad_scale_fwd(x, lmbda):
    return x, lmbda


def _grad_scale_bwd(lmbda, g):
    return g * lmbda, None


grad_scale.defvjp(_grad_scale_fwd, _grad_scale_bwd)


class AllPassWarpLayer(nn.Module):
    """Trainable VTLN layer: predicts per-frame alphas from named
    inputs, denormalises the cepstra, warps, renormalises
    (AllPassWarpLayer.py:36-200 role)."""

    warp_matrix_size: int
    alpha_layer_in_dims: tuple       # input dim per alpha sub-layer
    alpha_ranges: tuple              # tanh output scaling per sub-layer
    batch_first: bool = True
    mean: tuple = None               # denorm mean (feature dim,)
    std_dev: tuple = None
    grad_lambda: float = 200.0       # gradient boost for alpha layers

    def __call__(self, features, alpha_inputs, training=False):
        """features (B, T, D); alpha_inputs: list of (B, T, d_i)."""
        alphas = []
        for i, (inp, rng) in enumerate(zip(alpha_inputs,
                                           self.alpha_ranges)):
            pre = nn.Dense(1, name="alpha_layer_{}".format(i))(inp)
            alpha = jnp.tanh(pre) * rng
            alpha = grad_scale(alpha, self.grad_lambda)
            alphas.append(alpha)
        combined = combine_warping_parameters(alphas)

        x = features
        if self.mean is not None:
            mean = jnp.asarray(np.asarray(self.mean, np.float32))
            std = jnp.asarray(np.asarray(self.std_dev, np.float32))
            x = x * std + mean
        warped = all_pass_warp(x, combined, self.warp_matrix_size)
        if self.mean is not None:
            warped = (warped - mean) / std
        return warped, combined

    class Config(ModelConfig):
        def __init__(self, warp_matrix_size=None, alpha_ranges=(0.2,),
                     alpha_input_names=(), mean=None, std_dev=None,
                     grad_lambda=200.0, **kwargs):
            super().__init__(**kwargs)
            self.warp_matrix_size = warp_matrix_size
            self.alpha_ranges = tuple(alpha_ranges)
            self.alpha_input_names = tuple(alpha_input_names)
            self.mean = mean
            self.std_dev = std_dev
            self.grad_lambda = grad_lambda

        def create_model(self):
            return _AllPassWarpDictModule(config=self)

        def all_input_names(self):
            return tuple(self.input_names or ()) \
                + tuple(self.alpha_input_names or ())


class _AllPassWarpDictModule(nn.Module):
    """Dict-protocol wrapper: reads the pre-net output and alpha inputs
    by name, writes warped output + alphas."""

    config: AllPassWarpLayer.Config

    def __call__(self, data_dict, lengths=None, training=False):
        cfg = self.config
        features = merge_inputs(data_dict, cfg.input_names)
        T = features.shape[1]
        alpha_inputs = []
        for name in cfg.alpha_input_names:
            inp = jnp.asarray(data_dict[name])
            if inp.ndim == 2:
                inp = inp[:, None, :]
            if inp.shape[1] != T:
                # Utterance-level input (e.g. a speaker embedding that
                # the collate padded along time): broadcast frame 0.
                inp = jnp.broadcast_to(inp[:, :1],
                                       (inp.shape[0], T,
                                        inp.shape[-1]))
            alpha_inputs.append(inp)
        layer = AllPassWarpLayer(
            warp_matrix_size=cfg.warp_matrix_size,
            alpha_layer_in_dims=tuple(a.shape[-1]
                                      for a in alpha_inputs),
            alpha_ranges=cfg.alpha_ranges,
            mean=tuple(cfg.mean) if cfg.mean is not None else None,
            std_dev=tuple(cfg.std_dev)
            if cfg.std_dev is not None else None,
            grad_lambda=cfg.grad_lambda,
            name="all_pass_warp")
        warped, alphas = layer(features, alpha_inputs, training)
        out = dict(data_dict)
        out[cfg.output_names[0]] = warped
        if len(cfg.output_names) > 1:
            out[cfg.output_names[1]] = alphas
        else:
            out["alphas"] = alphas
        return out
