"""Config-built feed-forward / convolutional / recurrent stacks.

Capability parity with the reference's ``rnn_dyn`` family
(``models/rnn_dyn/RNNDyn.py`` :26-412 — layer-group container with
per-group embedding concatenation, the legacy model-string parser
:150-357 and named presets :379-412; ``Config.py`` :40-111 LayerConfig /
EmbeddingConfig; ``FFWrapper.py`` / ``RNNWrapper.py`` / ``CNNWrapper.py``
layer builders; ``Pooling.py`` / ``VanillaVAE`` / ``AlwaysDropout``).

Design: batch-first (B, T, D) tensors throughout; recurrent layers are
``lax.scan``s with ``seq_lengths`` masking (which reproduces
packed-sequence semantics incl. the reverse direction of BiLSTMs
starting at each sequence's true end); Conv1d via ``nn.Conv``;
dropout/BatchNorm driven by the ``training`` flag.
"""

import re

from idiaptts_tpu.models import nn
import jax
import jax.numpy as jnp
import numpy as np

from idiaptts_tpu.models.config import ModelConfig
from idiaptts_tpu.models.named import merge_inputs, write_outputs

IDENTIFIER = "RNNDYN"

_NONLINS = {
    "ReLU": nn.relu,
    "Tanh": jnp.tanh,
    "Sigmoid": nn.sigmoid,
    "SELU": nn.selu,
    "LeakyReLU": nn.leaky_relu,
    "Softsign": nn.soft_sign,
    "relu": nn.relu,
    "tanh": jnp.tanh,
}


def parse_int_set(nputstr):
    """Parse '0,2-5,7' or '-1' style index sets (misc/utils.parse_int_set
    role); returns a set of ints, -1 meaning "all groups"."""
    selection = set()
    for token in str(nputstr).replace("(", "").replace(")", "").split(","):
        token = token.strip()
        if not token:
            continue
        if re.fullmatch(r"-?\d+", token):
            selection.add(int(token))
        elif "-" in token:
            lo, hi = token.split("-")
            selection.update(range(int(lo), int(hi) + 1))
        else:
            raise ValueError("Cannot parse int set token: " + token)
    return selection


class LayerConfig:
    """One layer group (Config.py:40-54 role)."""

    def __init__(self, layer_type, out_dim=None, num_layers=1, nonlin=None,
                 dropout=0.0, bidirectional=False, kernel_size=None,
                 stride=1, padding=None, dilation=1, groups=1,
                 num_embeddings=None, batch_first=True, **kwargs):
        self.layer_type = layer_type
        self.out_dim = int(out_dim) if out_dim is not None else None
        self.num_layers = num_layers
        self.nonlin = nonlin
        self.dropout = dropout
        self.bidirectional = bidirectional
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.num_embeddings = num_embeddings
        self.batch_first = batch_first
        self.extra = kwargs


class EmbeddingConfig:
    """Embedding applied to specific layer groups (Config.py:81-111
    role).  The embedding index arrives as a trailing input column."""

    def __init__(self, embedding_dim, name, num_embeddings,
                 affected_layer_group_indices=(-1,)):
        self.embedding_dim = int(embedding_dim)
        self.name = name
        self.num_embeddings = int(num_embeddings)
        self.affected_layer_group_indices = set(
            affected_layer_group_indices)


def _affects(emb_config, group_idx, num_groups):
    idx_set = emb_config.affected_layer_group_indices
    return (-1 in idx_set or group_idx in idx_set
            or (group_idx - num_groups) in idx_set)


def masked_flip(x, lengths):
    """Reverse each sequence within its valid length; padding stays at
    the tail (packed-sequence reverse semantics)."""
    T = x.shape[1]
    t = jnp.arange(T)[None, :]
    idx = jnp.where(t < lengths[:, None], lengths[:, None] - 1 - t, t)
    return jnp.take_along_axis(x, idx[..., None], axis=1)


class _FastLSTM(nn.Module):
    """LSTM with the input projection hoisted out of the scan.

    The x @ W_x projection for ALL timesteps is one large matmul;
    the scan body only computes the lean recurrence h @ W_h + gates —
    roughly halving the sequential work vs a per-step full cell."""

    features: int
    unroll: int = 16

    def __call__(self, x, lengths=None, reverse=False):
        B, T, D = x.shape
        F = self.features
        Wx = self.param("Wx", nn.initializers.lecun_normal(), (D, 4 * F))
        Wh = self.param("Wh", nn.initializers.orthogonal(), (F, 4 * F))
        b = self.param("b", nn.initializers.zeros, (4 * F,))
        if reverse and lengths is not None:
            x = masked_flip(x, lengths)
        elif reverse:
            x = x[:, ::-1]
        x_proj = (x.astype(jnp.bfloat16) @ Wx.astype(jnp.bfloat16)
                  ).astype(jnp.float32) + b            # (B, T, 4F)
        Wh_b = Wh.astype(jnp.bfloat16)

        def step(carry, xp_t):
            h, c = carry
            gates = xp_t + (h.astype(jnp.bfloat16) @ Wh_b
                            ).astype(jnp.float32)
            i, f, g, o = jnp.split(gates, 4, axis=-1)
            c = jax.nn.sigmoid(f + 1.0) * c \
                + jax.nn.sigmoid(i) * jnp.tanh(g)
            h = jax.nn.sigmoid(o) * jnp.tanh(c)
            return (h, c), h

        init = (jnp.zeros((B, F)), jnp.zeros((B, F)))
        _, hs = jax.lax.scan(step, init, jnp.moveaxis(x_proj, 1, 0),
                             unroll=self.unroll)
        out = jnp.moveaxis(hs, 0, 1)
        if reverse and lengths is not None:
            out = masked_flip(out, lengths)
        elif reverse:
            out = out[:, ::-1]
        return out


class _BiFastLSTM(nn.Module):
    """Both BiLSTM directions in one scan.

    Inputs x / x_rev each (B, T, D); they ride a NEW leading
    direction axis of size 2 (never merged into the batch axis, which
    stays intact for data-parallel sharding) with per-direction weights
    applied via a direction-indexed einsum.  Returns (out_f, out_b_rev)
    each (B, T, F)."""

    features: int
    unroll: int = 16

    def __call__(self, x, x_rev):
        B, T, D = x.shape
        F = self.features
        Wx = self.param("Wx", nn.initializers.lecun_normal(),
                        (2, D, 4 * F))
        Wh = self.param("Wh", nn.initializers.orthogonal(),
                        (2, F, 4 * F))
        b = self.param("b", nn.initializers.zeros, (2, 4 * F))
        xd = jnp.stack([x, x_rev], axis=0)       # (2, B, T, D)

        x_proj = jnp.einsum("dbtc,dcg->dbtg",
                            xd.astype(jnp.bfloat16),
                            Wx.astype(jnp.bfloat16)
                            ).astype(jnp.float32) + b[:, None, None, :]
        Wh_b = Wh.astype(jnp.bfloat16)

        def step(carry, xp_t):
            h, c = carry                         # (2, B, F)
            rec = jnp.einsum("dbf,dfg->dbg",
                             h.astype(jnp.bfloat16),
                             Wh_b).astype(jnp.float32)
            gates = xp_t + rec
            i, f, g, o = jnp.split(gates, 4, axis=-1)
            c = jax.nn.sigmoid(f + 1.0) * c \
                + jax.nn.sigmoid(i) * jnp.tanh(g)
            h = jax.nn.sigmoid(o) * jnp.tanh(c)
            return (h, c), h

        init = (jnp.zeros((2, B, F)), jnp.zeros((2, B, F)))
        _, hs = jax.lax.scan(step, init,
                             jnp.moveaxis(x_proj, 2, 0),
                             unroll=self.unroll)
        out = jnp.moveaxis(hs, 0, 2)             # (2, B, T, F)
        return out[0], out[1]


class _MaskedFlipRNN(nn.Module):
    """Uni/bi-directional recurrent stack with length-aware reverse.

    ``dtype=bfloat16`` runs the matmuls in bf16 (parameters stay
    float32); ``unroll`` amortises the per-step scan overhead."""

    cell_type: str
    out_dim: int
    num_layers: int
    bidirectional: bool
    dropout: float
    nonlin: str = None
    dtype: str = "bfloat16"
    unroll: int = 8

    def _make_cell(self, idx, direction):
        dtype = jnp.bfloat16 if self.dtype == "bfloat16" else jnp.float32
        if self.cell_type == "LSTM":
            return nn.OptimizedLSTMCell(self.out_dim, dtype=dtype,
                                        name=f"{direction}{idx}")
        if self.cell_type == "GRU":
            return nn.GRUCell(self.out_dim, dtype=dtype,
                              name=f"{direction}{idx}")
        if self.cell_type == "RNN":
            act = _NONLINS.get(self.nonlin or "tanh", jnp.tanh)
            return nn.SimpleCell(self.out_dim, activation_fn=act,
                                 dtype=dtype, name=f"{direction}{idx}")
        raise NotImplementedError(self.cell_type)

    def __call__(self, x, lengths=None, training=False):
        for layer in range(self.num_layers):
            if self.cell_type == "LSTM" and self.bidirectional:
                # Both directions in ONE scan via a leading direction
                # axis (keeps the batch axis intact for sharding).
                x_rev = masked_flip(x, lengths) if lengths is not None \
                    else x[:, ::-1]
                out_f, out_b_rev = _BiFastLSTM(
                    self.out_dim, name=f"bi{layer}")(x, x_rev)
                out_b = masked_flip(out_b_rev, lengths) \
                    if lengths is not None else out_b_rev[:, ::-1]
                x = jnp.concatenate([out_f, out_b], axis=-1)
            elif self.cell_type == "LSTM":
                x = _FastLSTM(self.out_dim, name=f"fwd{layer}")(
                    x, lengths)
            else:
                fwd = nn.RNN(self._make_cell(layer, "fwd"),
                             unroll=self.unroll)
                out_f = fwd(x, seq_lengths=lengths)
                if self.bidirectional:
                    bwd = nn.RNN(self._make_cell(layer, "bwd"),
                                 reverse=True, keep_order=True,
                                 unroll=self.unroll)
                    out_b = bwd(x, seq_lengths=lengths)
                    x = jnp.concatenate([out_f, out_b], axis=-1)
                else:
                    x = out_f
            if self.dropout and layer < self.num_layers - 1:
                x = nn.Dropout(self.dropout,
                               deterministic=not training)(x)
        return x


class VanillaVAE(nn.Module):
    """Reparameterised VAE bottleneck layer: emits the latent sample and
    stores (mu, logvar) for the KLD loss (rnn_dyn VanillaVAE role)."""

    out_dim: int

    def __call__(self, x, training=False):
        mu = nn.Dense(self.out_dim, name="mu")(x)
        logvar = nn.Dense(self.out_dim, name="logvar")(x)
        if training:
            rng = self.make_rng("latent")
            std = jnp.exp(0.5 * logvar)
            z = mu + std * jax.random.normal(rng, mu.shape)
        else:
            z = mu
        self.sow("intermediates", "vae_mu", mu)
        self.sow("intermediates", "vae_logvar", logvar)
        return z


class RNNDyn(nn.Module):
    """Sequential layer-group stack with per-group embedding concat."""

    config: "Config"

    def __call__(self, inputs, lengths=None, training=False):
        cfg = self.config
        num_embs = len(cfg.emb_configs)
        if num_embs:
            emb_indices = inputs[..., -num_embs:]
            x = inputs[..., :-num_embs]
        else:
            emb_indices = None
            x = inputs

        embeddings = []
        for e_idx, emb_cfg in enumerate(cfg.emb_configs):
            table = nn.Embed(emb_cfg.num_embeddings,
                             emb_cfg.embedding_dim,
                             name="emb_" + str(emb_cfg.name))
            idx = emb_indices[..., e_idx].astype(jnp.int32)
            embeddings.append(table(idx))

        num_groups = len(cfg.layer_configs)
        for g_idx, layer in enumerate(cfg.layer_configs):
            use_remat = bool(layer.extra.get("remat"))
            for e_idx, emb_cfg in enumerate(cfg.emb_configs):
                if _affects(emb_cfg, g_idx, num_groups):
                    emb = embeddings[e_idx]
                    if emb.ndim > x.ndim:
                        # Pooled (utterance-level) activations after a
                        # frame-level embedding: the embedding is
                        # constant over time, take frame 0.
                        emb = emb[:, 0]
                    if emb.ndim == x.ndim:
                        x = jnp.concatenate([x, emb], axis=-1)
                    else:
                        x = jnp.concatenate(
                            [x, jnp.broadcast_to(
                                emb[:, None],
                                x.shape[:-1] + (emb.shape[-1],))],
                            axis=-1)
            if use_remat:
                # Rematerialise this group's activations in the
                # backward pass: trade FLOPs for HBM on long
                # sequences.  nn.remat creates parameters outside
                # the checkpoint and keeps this module's scope, so
                # parameter names (and checkpoints) are identical to
                # the non-remat path.
                x = nn.remat(
                    lambda mdl, x_, l_: mdl._apply_group(
                        g_idx, layer, x_, l_, training))(
                    self, x, lengths)
            else:
                x = self._apply_group(g_idx, layer, x, lengths,
                                      training)
        return x.astype(jnp.float32) if hasattr(x, "astype") else x

    def _apply_group(self, g_idx, layer, x, lengths, training):
        t = layer.layer_type
        name = "g{}_{}".format(g_idx, t)
        if t in ("Linear", "FC", "LIN"):
            for i in range(layer.num_layers):
                x = nn.Dense(layer.out_dim, dtype=jnp.bfloat16,
                             name="{}_{}".format(name, i))(x)
                if layer.nonlin:
                    x = _NONLINS[layer.nonlin](x)
                if layer.dropout:
                    x = nn.Dropout(layer.dropout,
                                   deterministic=not training)(x)
            return x
        if t in ("LSTM", "GRU", "RNN"):
            return _MaskedFlipRNN(cell_type=t, out_dim=layer.out_dim,
                                  num_layers=layer.num_layers,
                                  bidirectional=layer.bidirectional,
                                  dropout=layer.dropout,
                                  nonlin=layer.nonlin,
                                  name=name)(x, lengths, training)
        if t.startswith("Conv1d"):
            # Longest suffix wins ("Conv1dLEAKYRELU" must resolve to
            # LeakyReLU, not the shorter "relu" suffix).
            nonlin = None
            best = -1
            for key, fn in _NONLINS.items():
                if (t.endswith(key.upper()) or t.endswith(key)) \
                        and len(key) > best:
                    nonlin, best = fn, len(key)
            kernel = (layer.kernel_size if isinstance(
                layer.kernel_size, (tuple, list))
                else (layer.kernel_size,))
            stride = layer.stride if isinstance(layer.stride,
                                                (tuple, list)) \
                else (layer.stride,)
            if layer.padding is None:
                padding = "SAME"
            elif isinstance(layer.padding, str):
                padding = layer.padding
            else:
                pad = layer.padding if isinstance(
                    layer.padding, (tuple, list)) else (layer.padding,)
                padding = [(p, p) for p in pad]
            for i in range(layer.num_layers):
                x = nn.Conv(layer.out_dim, kernel, strides=stride,
                            padding=padding,
                            kernel_dilation=(layer.dilation,)
                            if np.isscalar(layer.dilation)
                            else layer.dilation,
                            feature_group_count=layer.groups,
                            name="{}_{}".format(name, i))(x)
                if nonlin is not None:
                    x = nonlin(x)
            return x
        if t == "BatchNorm1d":
            return nn.BatchNorm(use_running_average=not training,
                                axis=-1, name=name)(x)
        if t == "Embedding":
            table = nn.Embed(layer.num_embeddings, layer.out_dim,
                             name=name)
            return table(x[..., 0].astype(jnp.int32))
        if t == "VanillaVAE":
            return VanillaVAE(layer.out_dim, name=name)(x, training)
        if t == "SelectLastPooling":
            if lengths is None:
                return x[:, -1]
            idx = jnp.maximum(lengths - 1, 0).astype(jnp.int32)
            return jnp.take_along_axis(
                x, idx[:, None, None].repeat(x.shape[-1], axis=2),
                axis=1)[:, 0]
        if t == "MeanPooling":
            if lengths is None:
                return jnp.mean(x, axis=1)
            mask = (jnp.arange(x.shape[1])[None, :]
                    < lengths[:, None]).astype(x.dtype)
            return (jnp.sum(x * mask[..., None], axis=1)
                    / jnp.maximum(lengths[:, None], 1))
        if t == "Softmax":
            return jax.nn.softmax(x, axis=-1)
        if t == "LogSoftmax":
            return jax.nn.log_softmax(x, axis=-1)
        if t == "Exp":
            return jnp.exp(x)
        if t == "Dropout":
            return nn.Dropout(layer.dropout,
                              deterministic=not training)(x)
        if t == "Mask":
            # Zero padded frames explicitly (rnn_dyn Mask layer role).
            if lengths is None:
                return x
            mask = (jnp.arange(x.shape[1])[None, :]
                    < lengths[:, None]).astype(x.dtype)
            return x * mask[..., None]
        if t == "ApplyFunction":
            fn = layer.extra.get("function")
            if isinstance(fn, str):
                fn = _NONLINS.get(fn, getattr(jnp, fn, None))
            if fn is None:
                raise ValueError("ApplyFunction needs a function")
            return fn(x)
        if t == "AlwaysDropout":
            # Active at inference too (AlwaysDropout.py role).
            return nn.Dropout(layer.dropout, deterministic=False)(x)
        if t == "Custom":
            # Arbitrary user module in the stack
            # (rnn_dyn/CustomWrapper.py role). extra["module"] is a
            # module instance or zero-arg factory; modules taking
            # (x, lengths, training) get the full context.
            factory = layer.extra.get("module")
            if factory is None:
                raise ValueError("Custom layer needs "
                                 "extra={'module': <module or "
                                 "factory>}")
            mod = factory if isinstance(factory, nn.Module) \
                else factory()
            try:
                return mod(x, lengths=lengths, training=training)
            except TypeError:
                return mod(x)
        raise NotImplementedError("Unknown layer type " + t)

    class Config(ModelConfig):
        def __init__(self, in_dim=None, layer_configs=None,
                     emb_configs=None, hparams=None, **kwargs):
            super().__init__(**kwargs)
            self.in_dim = in_dim
            self.layer_configs = list(layer_configs or [])
            self.emb_configs = list(emb_configs or [])

        def create_model(self):
            from idiaptts_tpu.models.named import NamedForwardWrapper
            core = RNNDyn(config=self)
            if self.input_names:
                return NamedForwardWrapper(
                    wrapped=_CallAdapter(core),
                    input_names=self.input_names,
                    output_names=self.output_names or ("pred",),
                    input_merge_type=self.input_merge_type,
                    teacher_forcing_input_names=
                    self.teacher_forcing_input_names)
            return core

    LayerConfig = LayerConfig
    EmbeddingConfig = EmbeddingConfig


class _CallAdapter(nn.Module):
    """Adapts RNNDyn's (inputs, lengths, training) call to the wrapper's
    kwargs convention."""

    inner: nn.Module

    def __call__(self, inputs, lengths=None, training=False):
        return self.inner(inputs, lengths=lengths, training=training)


# Attach configs under the names the reference exposes.
Config = RNNDyn.Config


def convert_legacy_string(model_string, in_dim, hparams=None,
                          f_get_emb_index=None, dropout=0.0,
                          batch_first=True):
    """Legacy model-string -> Config
    (RNNDyn._get_config_from_legacy_string :150-357 grammar):
    ``RNNDYN-129x128_EMB_(-1)-2_RELU_1024-3_BiLSTM_512-1_FC_67``
    (``<num_embeddings>x<embedding_dim>_EMB_(<group indices>)``).
    """
    if hparams is not None:
        dropout = hparams.get("dropout", dropout)
        f_get_emb_index = hparams.get("f_get_emb_index", f_get_emb_index)
        batch_first = hparams.get("batch_first", True)
    groups = re.split(r"-\s*(?![^()]*\))", model_string)
    if groups and groups[0].upper().startswith(IDENTIFIER):
        groups = groups[1:]
    if not groups:
        raise ValueError("Empty RNNDYN configuration: " + model_string)

    in_dim_total = int(np.prod(in_dim)) if not np.isscalar(in_dim) \
        else int(in_dim)
    in_dim_without_embs = in_dim_total
    emb_configs = []
    layer_configs = []
    embeddings_done = False

    for group in groups:
        attrs = group.split("_")
        layer_type = attrs[1]
        bidirectional = False
        if layer_type.startswith("Bi"):
            bidirectional = True
            layer_type = layer_type[2:]

        if layer_type == "EMB":
            if embeddings_done:
                raise NotImplementedError(
                    "Embedding layers must come first.")
            num_embeddings, embedding_dim = attrs[0].replace(
                "(", "").replace(")", "").split("x")
            affected = parse_int_set(attrs[2])
            if int(num_embeddings) <= 0:
                # The reference's -1 means "infer from the corpus",
                # which nothing in-package can do — demand an explicit
                # table size instead of building an empty nn.Embed.
                raise ValueError(
                    "EMB layer needs an explicit positive "
                    "num_embeddings (got {!r}); the reference's -1 "
                    "placeholder is not resolvable here.".format(
                        num_embeddings))
            emb_configs.append(EmbeddingConfig(
                int(embedding_dim), str(len(emb_configs)),
                int(num_embeddings), affected))
            in_dim_without_embs -= 1
            continue
        embeddings_done = True

        n_layers = int(attrs[0])
        out_dim = int(attrs[2])
        norm_type = None
        if layer_type.startswith("BatchNorm1d"):
            norm_type = "BatchNorm1d"
            layer_type = layer_type[len("BatchNorm1d"):]

        nonlin = {"RELU": "ReLU", "TANH": "Tanh",
                  "SIGMOID": "Sigmoid"}.get(layer_type.upper())

        if layer_type in ("LSTM", "GRU", "RNNTANH", "RNNRELU"):
            if layer_type.startswith("RNN"):
                nonlin = {"RNNTANH": "tanh", "RNNRELU": "relu"}[layer_type]
                layer_type = "RNN"
            layer_configs.append(LayerConfig(
                layer_type=layer_type, out_dim=out_dim,
                num_layers=n_layers, nonlin=nonlin,
                dropout=dropout if n_layers > 1 else 0.0,
                bidirectional=bidirectional))
        elif layer_type.startswith("Conv1d"):
            kernel = tuple(map(int, attrs[3].split("x")))
            stride, padding = 1, int((kernel[0] - 1) / 2)
            dilation, conv_groups = 1, 1
            for param in attrs[4:]:
                if param[0] == "s":
                    stride = tuple(map(int, param[1:].split("x")))
                elif param[0] == "p":
                    padding = tuple(map(int, param[1:].split("x")))
                elif param[0] == "d":
                    dilation = tuple(map(int, param[1:].split("x")))
                elif param[0] == "g":
                    conv_groups = int(param[1:])
            layer_configs.append(LayerConfig(
                layer_type=layer_type, out_dim=out_dim,
                num_layers=n_layers, kernel_size=kernel, stride=stride,
                padding=padding, dilation=dilation, groups=conv_groups))
        elif layer_type.startswith("Emb"):
            layer_configs.append(LayerConfig(
                layer_type="Embedding", out_dim=int(attrs[2]),
                num_embeddings=int(attrs[3])))
        elif layer_type.startswith("Pool"):
            if layer_type == "PoolLast":
                layer_configs.append(LayerConfig(
                    layer_type="SelectLastPooling"))
            else:
                raise NotImplementedError(layer_type)
        elif "VAE" in layer_type:
            layer_configs.append(LayerConfig(layer_type="VanillaVAE",
                                             out_dim=out_dim))
        else:
            layer_configs.append(LayerConfig(
                layer_type="Linear", out_dim=out_dim,
                num_layers=n_layers, nonlin=nonlin, dropout=dropout))
        if norm_type is not None:
            layer_configs.append(LayerConfig(layer_type=norm_type,
                                             out_dim=out_dim))
    return Config(in_dim=in_dim_without_embs, batch_first=batch_first,
                  layer_configs=layer_configs, emb_configs=emb_configs)


# -- named presets (RNNDyn.py:379-412 role) --------------------------------

def merlin_acoustic_config(in_dim, out_dim, hparams=None, dropout=0.05):
    return convert_legacy_string(
        "RNNDYN-6_TANH_1024-1_FC_{}".format(out_dim), in_dim,
        hparams=hparams, dropout=dropout)


def interspeech18_baseline_config(in_dim, out_dim, hparams=None,
                                  dropout=0.0):
    return convert_legacy_string(
        "RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_{}".format(out_dim),
        in_dim, hparams=hparams, dropout=dropout)


def icassp19_baseline_config(in_dim, out_dim, hparams=None, dropout=0.0):
    return convert_legacy_string(
        "RNNDYN-2_RELU_1024-3_BiGRU_427-1_FC_{}".format(out_dim),
        in_dim, hparams=hparams, dropout=dropout)


def baseline_rnn_config(in_dim, out_dim, hparams=None):
    return convert_legacy_string(
        "RNNDYN-1_RELU_32-1_FC_{}".format(out_dim), in_dim,
        hparams=hparams)
