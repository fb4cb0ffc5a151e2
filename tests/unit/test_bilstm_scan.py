"""The plain ``lax.scan`` (Bi)LSTM layers of ``rnn_dyn`` against a float32
numpy LSTM: forward, masked lengths, the reverse direction, gradients.

The layers run their matmuls with bf16 operands (float32 sums, float32
state), so they are held to a bf16 tolerance against the float32
reference: relative to the output scale (|h| <= 1), 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from idiaptts_tpu.models.rnn_dyn import Config, LayerConfig, RNNDyn

BF16_TOL = 3e-2
# (B, T, D, F): shapes of the former fused-kernel tests plus odd ones.
SHAPES = [(2, 16, 8, 16), (3, 33, 12, 32), (8, 20, 40, 128),
          (1, 7, 5, 8)]


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _lstm_np(x, Wx, Wh, b):
    """One direction over x (T, D) from a zero state; gate order
    i, f, g, o with the +1 forget bias of ``rnn_dyn``."""
    F = Wh.shape[0]
    h = np.zeros(F, np.float32)
    c = np.zeros(F, np.float32)
    out = []
    for x_t in x:
        gates = x_t @ Wx + h @ Wh + b
        i, f, g, o = np.split(gates, 4)
        c = _sigmoid(f + 1.0) * c + _sigmoid(i) * np.tanh(g)
        h = _sigmoid(o) * np.tanh(c)
        out.append(h)
    return np.stack(out) if out else np.zeros((0, F), np.float32)


def _bilstm_np(x, lengths, p):
    """(B, T, D) -> (B, T, 2F) on the valid frames; zeros elsewhere."""
    B, T, _ = x.shape
    F = p["Wh"].shape[1]
    out = np.zeros((B, T, 2 * F), np.float32)
    for n in range(B):
        L = int(lengths[n])
        fwd = _lstm_np(x[n, :L], p["Wx"][0], p["Wh"][0], p["b"][0])
        bwd = _lstm_np(x[n, :L][::-1], p["Wx"][1], p["Wh"][1],
                       p["b"][1])[::-1]
        out[n, :L] = np.concatenate([fwd, bwd], axis=-1)
    return out


def _model(D, F, bidirectional=True):
    return RNNDyn(config=Config(in_dim=D, layer_configs=[
        LayerConfig("LSTM", out_dim=F, bidirectional=bidirectional)]))


def _setup(B, T, D, F, lengths=None, seed=0, bidirectional=True):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, D).astype(np.float32)
    if lengths is None:
        lengths = np.full(B, T, np.int32)
    model = _model(D, F, bidirectional)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                        lengths=jnp.asarray(lengths))
    out = np.asarray(model.apply(params, jnp.asarray(x),
                                 lengths=jnp.asarray(lengths)))
    return model, params, x, np.asarray(lengths), out


def _np_params(params):
    p = params["params"]["g0_LSTM"]["bi0"]
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


@pytest.mark.parametrize("B,T,D,F", SHAPES)
def test_bilstm_forward_matches_numpy(B, T, D, F):
    _, params, x, lengths, out = _setup(B, T, D, F)
    ref = _bilstm_np(x, lengths, _np_params(params))
    assert out.shape == (B, T, 2 * F)
    assert np.abs(out - ref).max() < BF16_TOL


@pytest.mark.parametrize("B,T,D,F", SHAPES)
def test_bilstm_masked_lengths_match_numpy(B, T, D, F):
    lengths = np.maximum(1, T - 3 * np.arange(B)).astype(np.int32)
    _, params, x, lengths, out = _setup(B, T, D, F, lengths=lengths,
                                        seed=1)
    ref = _bilstm_np(x, lengths, _np_params(params))
    mask = np.arange(T)[None, :, None] < lengths[:, None, None]
    assert np.abs((out - ref) * mask).max() < BF16_TOL


def test_reverse_direction_starts_at_the_true_end():
    """Packed-sequence semantics: the backward state at a sequence's
    last valid frame has seen only that frame, whatever the padding."""
    B, T, D, F = 2, 12, 6, 16
    lengths = np.array([12, 5], np.int32)
    model, params, x, _, out = _setup(B, T, D, F, lengths=lengths, seed=2)
    p = _np_params(params)
    for n, L in enumerate(lengths):
        one = _lstm_np(x[n, L - 1:L], p["Wx"][1], p["Wh"][1], p["b"][1])
        assert np.abs(out[n, L - 1, F:] - one[0]).max() < BF16_TOL
    # Changing the padding does not change the valid frames.
    x2 = x.copy()
    x2[1, 5:] = 100.0
    out2 = np.asarray(model.apply(params, jnp.asarray(x2),
                                  lengths=jnp.asarray(lengths)))
    np.testing.assert_array_equal(out2[1, :5], out[1, :5])


def test_unidirectional_lstm_matches_numpy():
    B, T, D, F = 3, 15, 7, 16
    _, params, x, lengths, out = _setup(B, T, D, F, seed=3,
                                        bidirectional=False)
    p = {k: np.asarray(v, np.float32)
         for k, v in params["params"]["g0_LSTM"]["fwd0"].items()}
    ref = np.stack([_lstm_np(x[n], p["Wx"], p["Wh"], p["b"])
                    for n in range(B)])
    assert out.shape == (B, T, F)
    assert np.abs(out - ref).max() < BF16_TOL


def _bilstm_jnp(x, p):
    """float32 jnp reference for gradients (full-length sequences)."""
    def direction(xs, Wx, Wh, b):
        F = Wh.shape[0]

        def step(carry, x_t):
            h, c = carry
            i, f, g, o = jnp.split(x_t @ Wx + h @ Wh + b, 4, axis=-1)
            c = jax.nn.sigmoid(f + 1.0) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
            h = jax.nn.sigmoid(o) * jnp.tanh(c)
            return (h, c), h

        zeros = jnp.zeros((xs.shape[0], F))
        _, hs = jax.lax.scan(step, (zeros, zeros), jnp.moveaxis(xs, 1, 0))
        return jnp.moveaxis(hs, 0, 1)

    fwd = direction(x, p["Wx"][0], p["Wh"][0], p["b"][0])
    bwd = direction(x[:, ::-1], p["Wx"][1], p["Wh"][1], p["b"][1])[:, ::-1]
    return jnp.concatenate([fwd, bwd], axis=-1)


@pytest.mark.parametrize("B,T,D,F", SHAPES[:2])
def test_bilstm_gradients_match_float32_reference(B, T, D, F):
    model, params, x, lengths, _ = _setup(B, T, D, F, seed=4)
    target = np.random.RandomState(5).randn(B, T, 2 * F).astype(np.float32)

    def loss(p):
        out = model.apply({"params": p}, jnp.asarray(x),
                          lengths=jnp.asarray(lengths))
        return jnp.mean((out - target) ** 2)

    def loss_ref(p):
        out = _bilstm_jnp(jnp.asarray(x), p["g0_LSTM"]["bi0"])
        return jnp.mean((out - target) ** 2)

    with jax.default_matmul_precision("highest"):
        want = jax.grad(loss_ref)(params["params"])
    got = jax.grad(loss)(params["params"])
    for name in ("Wx", "Wh", "b"):
        g = np.asarray(got["g0_LSTM"]["bi0"][name])
        w = np.asarray(want["g0_LSTM"]["bi0"][name])
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= BF16_TOL * np.abs(w).max() + 1e-6, \
            name
