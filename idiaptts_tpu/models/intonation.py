"""GCR intonation filters: trainable 2nd-order IIR banks + end-to-end
neural filter models.

Capability parity with ``models/IntonationFilters.py`` (:11-105 —
theta<->modulus conversion, Complex (conjugate pole pair) and Critical
(double real pole) filter banks with the learned-pole output
normalisation polynomial), ``models/NeuralFilters.py`` (:22-110 —
pre-trained atom model + trainable intonation filters; e2e LF0 =
filtered atom amplitudes) and ``models/PhraseNeuralFilters.py``
(:18-55 — adds a phrase-bias filter).

Design: the IIR recurrences run as a single ``lax.scan``
over time with all filters in the bank evaluated as one vector step
(state (B, 2, num_filters)); poles are learned in the stable domain via
sigmoid parametrisation.
"""

from idiaptts_tpu.models import nn
import jax
import jax.numpy as jnp
import numpy as np

from idiaptts_tpu.models.config import ModelConfig

# Output normalisation polynomial in the filter modulus
# (IntonationFilters.py:25-26 constants).
_NORM_WEIGHTS = np.array([38.43190559738741, -50.05233847007584,
                          25.07626762013403, 3.1930363795157106],
                         np.float32)
_NORM_BIAS = np.float32(48.95299158714191)


def theta_to_modulus(thetas, fs=200):
    return np.exp(-1.0 / (np.asarray(thetas) * fs))


def modulus_to_theta(modulus, fs=200):
    return -1.0 / (fs * np.log(np.asarray(modulus)))


def _modulus_normalisation(modulus):
    """Scalar gain per filter from the learned modulus
    (IntonationFilters.BaseModel.forward :38-48 semantics)."""
    feats = jnp.stack([modulus, jnp.exp(modulus), modulus ** 2,
                       jnp.exp(modulus) ** 2], axis=-1)
    return feats @ jnp.asarray(_NORM_WEIGHTS) + _NORM_BIAS


def _iir2_scan(x, a1, a2):
    """Bank of 2nd-order IIR filters: y[n] = x[n] + a1*y[n-1]
    + a2*y[n-2]; x (B, T, F), a1/a2 (F,) -> y (B, T, F)."""
    B, T, F = x.shape

    def step(carry, x_t):
        y1, y2 = carry
        y = x_t + a1 * y1 + a2 * y2
        return (y, y1), y

    zeros = jnp.zeros((B, F), x.dtype)
    _, y = jax.lax.scan(step, (zeros, zeros),
                        jnp.moveaxis(x, 1, 0))
    return jnp.moveaxis(y, 0, 1)


class CriticalFilterBank(nn.Module):
    """Critically damped double-real-pole bank (NeuralFilter2CD role):
    poles at (r, r) -> a1 = 2r, a2 = -r^2; r learned via sigmoid."""

    init_moduli: tuple

    def __call__(self, x, sum_filters=True):
        init = np.asarray(self.init_moduli, np.float32)
        logit = self.param(
            "pole_logit",
            lambda rng: jnp.asarray(np.log(init / (1 - init))))
        r = jax.nn.sigmoid(logit)
        y = _iir2_scan(x, 2.0 * r, -(r ** 2))
        norm = _modulus_normalisation(r)
        y = y * norm
        if sum_filters:
            return jnp.sum(y, axis=-1, keepdims=True)
        return y


class ComplexFilterBank(nn.Module):
    """Conjugate complex pole pair bank (NeuralFilter2CC role): poles
    r*e^{+-i phi} -> a1 = 2r cos(phi), a2 = -r^2."""

    init_moduli: tuple
    phase_init: float = 0.0

    def __call__(self, x, sum_filters=True):
        init = np.asarray(self.init_moduli, np.float32)
        logit = self.param(
            "pole_logit",
            lambda rng: jnp.asarray(np.log(init / (1 - init))))
        phase = self.param(
            "phase",
            lambda rng: jnp.full((len(init),), self.phase_init,
                                 jnp.float32))
        r = jax.nn.sigmoid(logit)
        y = _iir2_scan(x, 2.0 * r * jnp.cos(phase), -(r ** 2))
        norm = _modulus_normalisation(r)
        y = y * norm
        if sum_filters:
            return jnp.sum(y, axis=-1, keepdims=True)
        return y


class NeuralFilters(nn.Module):
    """End-to-end LF0 model: a (pre-trained) atom model produces
    [amps..., pos, vuv] frames (this package's
    AtomVUVDistPosLabelGen.preprocess layout; the reference orders it
    [vuv, amps..., pos] — NeuralFilters.py:57-82); the filter bank
    turns amplitude spikes into the LF0 curve.  Output is
    [lf0, vuv, amps...]."""

    atom_model: nn.Module
    thetas: tuple
    complex_poles: bool = True
    phase_init: float = 0.0

    def __call__(self, data_dict, lengths=None, training=False):
        out = self.atom_model(data_dict, lengths=lengths,
                              training=training)
        atoms_out = out[self._atom_output_name(out)]
        num_thetas = len(self.thetas)
        amps = atoms_out[..., :num_thetas]
        vuv = atoms_out[..., -1:]
        moduli = tuple(theta_to_modulus(np.asarray(self.thetas)))
        if self.complex_poles:
            bank = ComplexFilterBank(moduli, self.phase_init,
                                     name="intonation_filters")
        else:
            bank = CriticalFilterBank(moduli,
                                      name="intonation_filters")
        lf0 = bank(amps)
        e2e = jnp.concatenate([lf0, vuv, amps], axis=-1)
        out = dict(out)
        out["pred_intonation"] = e2e
        return out

    @staticmethod
    def _atom_output_name(out):
        for key in ("pred_atoms", "pred"):
            if key in out:
                return key
        raise KeyError("Atom model output not found in dict.")

    class Config(ModelConfig):
        def __init__(self, atom_model_config=None, thetas=(),
                     complex_poles=True, phase_init=0.0, **kwargs):
            super().__init__(**kwargs)
            self.atom_model_config = atom_model_config
            self.thetas = tuple(thetas)
            self.complex_poles = complex_poles
            self.phase_init = phase_init

        def create_model(self):
            return NeuralFilters(
                atom_model=self.atom_model_config.create_model(),
                thetas=self.thetas, complex_poles=self.complex_poles,
                phase_init=self.phase_init)


class PhraseNeuralFilters(nn.Module):
    """NeuralFilters + a trainable phrase-bias filter
    (PhraseNeuralFilters.py:18-55 role): the phrase component is one
    extra critically damped filter plus a bias added to the LF0."""

    neural_filters: NeuralFilters
    phrase_theta_init: float = 0.05
    phrase_bias_init: float = 4.5

    def __call__(self, data_dict, lengths=None, training=False):
        out = self.neural_filters(data_dict, lengths=lengths,
                                  training=training)
        e2e = out["pred_intonation"]
        lf0_flat, vuv, amps = e2e[..., :1], e2e[..., 1:2], e2e[..., 2:]
        phrase_mod = float(theta_to_modulus(self.phrase_theta_init))
        bank = CriticalFilterBank((phrase_mod,), name="phrase_filter")
        phrase_amp = jnp.sum(amps, axis=-1, keepdims=True)
        phrase = bank(phrase_amp)
        bias = self.param("phrase_bias",
                          lambda rng: jnp.asarray(
                              self.phrase_bias_init, jnp.float32))
        lf0 = lf0_flat + phrase + bias
        out = dict(out)
        out["pred_intonation_phrase"] = jnp.concatenate(
            [lf0, vuv, amps], axis=-1)
        return out

    class Config(ModelConfig):
        def __init__(self, neural_filters_config=None,
                     phrase_theta_init=0.05, phrase_bias_init=4.5,
                     **kwargs):
            super().__init__(**kwargs)
            self.neural_filters_config = neural_filters_config
            self.phrase_theta_init = phrase_theta_init
            self.phrase_bias_init = phrase_bias_init

        def create_model(self):
            return PhraseNeuralFilters(
                neural_filters=self.neural_filters_config.create_model(),
                phrase_theta_init=self.phrase_theta_init,
                phrase_bias_init=self.phrase_bias_init)
