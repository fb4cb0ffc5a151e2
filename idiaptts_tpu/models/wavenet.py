"""WaveNet vocoder: dilated causal convolutions with gated residual
blocks, mu-law categorical or mixture-of-logistics output.

Capability parity with the reference's r9y9 integration
(``models/WaveNetWrapper.py`` :25-141 — teacher-forced training forward
vs ``incremental_forward`` generation :110-132) — re-implemented
natively in JAX instead of wrapping an external package.

Design: training is fully parallel (dilated convs over the whole
sequence); generation is a ``lax.scan`` over samples with per-layer
ring-buffer caches carried in the scan state (the incremental-decode
equivalent), jit-compiled once.
"""

from idiaptts_tpu.models import nn
import jax
import jax.numpy as jnp
import numpy as np

from idiaptts_tpu.models.config import ModelConfig
from idiaptts_tpu.ops.mulaw import inv_mulaw_quantize, mulaw_quantize
from idiaptts_tpu.utils import serialization


class ResidualBlock(nn.Module):
    residual_channels: int
    gate_channels: int
    skip_channels: int
    kernel_size: int
    dilation: int

    def __call__(self, x, cond):
        # Causal dilated conv: left-pad so output depends on past only.
        pad = (self.kernel_size - 1) * self.dilation
        h = jnp.pad(x, ((0, 0), (pad, 0), (0, 0)))
        h = nn.Conv(self.gate_channels, (self.kernel_size,),
                    kernel_dilation=(self.dilation,), padding="VALID",
                    dtype=jnp.bfloat16, name="dilated")(h)
        if cond is not None:
            h = h + nn.Dense(self.gate_channels, dtype=jnp.bfloat16,
                             name="cond")(cond)
        a, b = jnp.split(h, 2, axis=-1)
        z = jnp.tanh(a) * jax.nn.sigmoid(b)
        skip = nn.Dense(self.skip_channels, dtype=jnp.bfloat16,
                        name="skip")(z)
        res = nn.Dense(self.residual_channels, dtype=jnp.bfloat16,
                       name="res")(z)
        return (x + res) * np.float32(1.0 / np.sqrt(2.0)), skip


class WaveNet(nn.Module):
    """Teacher-forced parallel WaveNet."""

    out_channels: int = 256          # mu-law classes (or 3*K for MoL)
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64
    num_layers: int = 20
    num_stacks: int = 2
    kernel_size: int = 2
    cond_channels: int = 63

    def dilations(self):
        return list(_dilations(self))

    def __call__(self, x_quantised, cond=None, lengths=None,
                 training=False):
        """x_quantised: (B, T) int mu-law samples (inputs, shifted);
        cond: (B, T, C) upsampled conditioning.  Returns (B, T, out)."""
        x = nn.Embed(self.out_channels, self.residual_channels,
                     name="input_embed")(x_quantised)
        skips = 0.0
        for i, dilation in enumerate(self.dilations()):
            x, skip = ResidualBlock(
                self.residual_channels, self.gate_channels,
                self.skip_channels, self.kernel_size, dilation,
                name="block_{}".format(i))(x, cond)
            skips = skips + skip
        h = nn.relu(skips)
        h = nn.Dense(self.skip_channels, dtype=jnp.bfloat16,
                     name="post1")(h)
        h = nn.relu(h)
        return nn.Dense(self.out_channels, name="post2")(
            h).astype(jnp.float32)


class WaveNetWrapper(nn.Module):
    """Dict-protocol wrapper (WaveNetWrapper.py role): reads quantised
    waveform input + conditioning, writes logits."""

    config: "WaveNetWrapper.Config"

    def __call__(self, data_dict, lengths=None, training=False):
        from idiaptts_tpu.models.named import select_lengths
        cfg = self.config
        # Multi-rate batch: masking runs at the waveform rate, so the
        # target's lengths (not the frame-rate conditioning's) apply.
        lengths = select_lengths(lengths, cfg.target_name,
                                 *(cfg.input_names or ()))
        cond = jnp.asarray(data_dict[cfg.input_names[0]]) \
            if cfg.input_names else None
        if cfg.target_name not in data_dict:
            # Inference without a teacher target (trainer.synth):
            # waveform generation is autoregressive and happens in
            # gen_waveform via ``generate()`` (the reference's
            # incremental_forward split, WaveNetWrapper.py:110-132);
            # emit placeholder logits so the dict protocol holds.
            if cond is None:
                raise ValueError(
                    "WaveNetWrapper inference needs either the teacher "
                    "target '%s' or conditioning inputs to define the "
                    "output length" % cfg.target_name)
            out = dict(data_dict)
            out[cfg.output_names[0]] = jnp.zeros(
                cond.shape[:2] + (cfg.out_channels,), jnp.float32)
            return out
        target = jnp.asarray(data_dict[cfg.target_name])
        if target.ndim == 3:
            target = target[..., 0]
        quantised = target.astype(jnp.int32)
        # Teacher forcing: inputs are the previous samples.
        inputs = jnp.pad(quantised, ((0, 0), (1, 0)),
                         constant_values=cfg.out_channels // 2)[:, :-1]
        net = WaveNet(out_channels=cfg.out_channels,
                      residual_channels=cfg.residual_channels,
                      gate_channels=cfg.gate_channels,
                      skip_channels=cfg.skip_channels,
                      num_layers=cfg.num_layers,
                      num_stacks=cfg.num_stacks,
                      kernel_size=cfg.kernel_size,
                      name="wavenet")
        logits = net(inputs, cond, lengths, training)
        out = dict(data_dict)
        out[cfg.output_names[0]] = logits
        return out

    class Config(ModelConfig):
        def __init__(self, target_name="target_quantised",
                     out_channels=256, residual_channels=64,
                     gate_channels=128, skip_channels=64, num_layers=20,
                     num_stacks=2, kernel_size=2, **kwargs):
            super().__init__(**kwargs)
            self.target_name = target_name
            self.out_channels = out_channels
            self.residual_channels = residual_channels
            self.gate_channels = gate_channels
            self.skip_channels = skip_channels
            self.num_layers = num_layers
            self.num_stacks = num_stacks
            self.kernel_size = kernel_size

        def create_model(self):
            return WaveNetWrapper(config=self)


def _generate_scan(wrapper_params, dilations, config, cond, rng,
                   temperature, forced=None, want_logits=False):
    """Jittable core: cond (B, T, C) -> samples (B, T) int32, and with
    ``want_logits`` also the per-step logits (B, T, out_channels).

    ``temperature == 0`` samples greedily (argmax).  ``forced`` (B, T)
    int32 feeds those samples back instead of the drawn ones (teacher
    forcing), so the logits can be checked against the parallel net.

    Design: per-layer ring buffers written in place with
    ``dynamic_update_index_in_dim`` (O(1) per step instead of an
    O(dilation) shift copy), and a batch dimension that turns every
    per-step matvec into a matmul so multiple utterances amortise the
    sequential scan (the r9y9 incremental_forward has neither)."""
    B, T = cond.shape[0], cond.shape[1]
    R = config.residual_channels

    # Ring slots: h_t written at t % (d+1); h_{t-d} read at
    # (t+1) % (d+1) since (t-d) == (t+1) mod (d+1).
    buffers = [jnp.zeros((B, d + 1, R)) for d in dilations]
    table = wrapper_params["input_embed"]["embedding"]

    def step(carry, t):
        x_prev, buffers, rng = carry            # x_prev: (B,) int32
        # f32 activations regardless of param dtype (params may be
        # cast to bf16 to halve the per-step weight streaming).
        h = table[x_prev].astype(jnp.float32)   # (B, R)
        c_t = jax.lax.dynamic_index_in_dim(cond, t, axis=1,
                                           keepdims=False)  # (B, C)
        skips = 0.0
        new_buffers = []
        for i, d in enumerate(dilations):
            bp = wrapper_params["block_{}".format(i)]
            buf = buffers[i]
            size = d + 1
            past = jax.lax.dynamic_index_in_dim(
                buf, (t + 1) % size, axis=1, keepdims=False)
            kernel = bp["dilated"]["kernel"]          # (k, in, out)
            pre = (past @ kernel[0].astype(jnp.float32)
                   + h @ kernel[1].astype(jnp.float32)
                   + bp["dilated"]["bias"])
            pre = pre + c_t @ bp["cond"]["kernel"].astype(jnp.float32) \
                + bp["cond"]["bias"]
            a, b = jnp.split(pre, 2, axis=-1)
            z = jnp.tanh(a) * jax.nn.sigmoid(b)
            skip = z @ bp["skip"]["kernel"].astype(jnp.float32) \
                + bp["skip"]["bias"]
            res = z @ bp["res"]["kernel"].astype(jnp.float32) \
                + bp["res"]["bias"]
            out_h = (h + res) * np.float32(1.0 / np.sqrt(2.0))
            new_buffers.append(jax.lax.dynamic_update_index_in_dim(
                buf, h, t % size, axis=1))
            skips = skips + skip
            h = out_h
        hh = nn.relu(skips)
        hh = hh @ wrapper_params["post1"]["kernel"].astype(jnp.float32) \
            + wrapper_params["post1"]["bias"]
        hh = nn.relu(hh)
        logits = hh @ wrapper_params["post2"]["kernel"] \
            + wrapper_params["post2"]["bias"]
        rng, sub = jax.random.split(rng)
        if temperature == 0:
            sample = jnp.argmax(logits, axis=-1)
        else:
            sample = jax.random.categorical(sub, logits / temperature,
                                            axis=-1)             # (B,)
        sample = sample.astype(jnp.int32)
        x_next = sample if forced is None else forced[:, t]
        out = (sample, logits) if want_logits else sample
        return (x_next, new_buffers, rng), out

    init = (jnp.full((B,), config.out_channels // 2, jnp.int32),
            buffers, rng)
    _, out = jax.lax.scan(step, init, jnp.arange(T))
    if want_logits:
        samples, logits = out
        return samples.T, jnp.moveaxis(logits, 0, 1)
    return out.T                                              # (B, T)


_generate_scan_jit = jax.jit(_generate_scan,
                             static_argnames=("dilations", "config",
                                              "temperature",
                                              "want_logits"))


def _dilations(config):
    per_stack = config.num_layers // config.num_stacks
    return tuple(2 ** (i % per_stack) for i in range(config.num_layers))


def teacher_forced_logits(params, config, cond, forced):
    """Logits (B, T, out_channels) of the incremental generator when the
    samples ``forced`` (B, T) are fed back: they equal the parallel
    net's on the same history, which checks the ring buffers."""
    _, logits = _generate_scan_jit(
        params["params"]["wavenet"], _dilations(config), config,
        jnp.asarray(cond, jnp.float32), jax.random.PRNGKey(0), 0.0,
        forced=jnp.asarray(forced, jnp.int32), want_logits=True)
    return logits


def generate(params, config, cond, rng=None, temperature=1.0,
             device_output=False):
    """Autoregressive generation (the incremental_forward equivalent).

    Runs the lax.scan generator with ring-buffer caches, jit-compiled
    once per shape.

    params: wrapper params; cond: (T, C) for a single utterance or
    (B, T, C) for batched generation (B utterances amortise the
    sequential loop — per-step matvecs become matmuls).
    Returns (T,) or (B, T) float waveform in [-1, 1].
    """
    wrapper_params = params["params"]["wavenet"]
    dilations = _dilations(config)
    rng = rng if rng is not None else jax.random.PRNGKey(0)
    cond = jnp.asarray(cond, jnp.float32)
    single = cond.ndim == 2
    if single:
        cond = cond[None]

    samples = _generate_scan_jit(wrapper_params, dilations, config, cond,
                                 rng, temperature)
    wav = inv_mulaw_quantize(samples, config.out_channels - 1)
    if not device_output:
        # One device->host transfer; with device_output the caller
        # keeps the waveform on device (e.g. loudness-norm + PCM16
        # encode fused into a downstream jit, as trainer.synth does).
        wav = np.asarray(wav)
    return wav[0] if single else wav


class WaveNetVocoder:
    """Checkpointed WaveNet usable as a Synthesiser backend
    (Synthesiser.run_wavenet_vocoder :244-319 role)."""

    def __init__(self, config, variables):
        self.config = config
        self.variables = variables

    @classmethod
    def load(cls, checkpoint_path, hparams=None):
        import os
        from idiaptts_tpu.models.config import ModelConfig
        nn_dir = checkpoint_path
        with open(os.path.join(nn_dir, "config.json")) as f:
            config = ModelConfig.from_json(f.read())
        import glob
        params_files = glob.glob(os.path.join(nn_dir, "params_*"))
        newest = max(params_files, key=os.path.getctime)
        with open(newest, "rb") as f:
            state = serialization.msgpack_restore(f.read())
        return cls(config, {"params": state["params"]})

    def generate(self, cond, seed=0):
        import jax
        return generate(self.variables, self.config,
                        jnp.asarray(cond, jnp.float32),
                        rng=jax.random.PRNGKey(seed))
