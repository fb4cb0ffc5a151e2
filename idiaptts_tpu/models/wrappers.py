"""Model wrappers for long sequences.

Capability parity with ``models/WindowingWrapper.py`` (:23-310): run a
wrapped model on overlapping windows of a long sequence and merge the
outputs — the single-process long-sequence strategy of the reference
(SURVEY.md §2.8/§5).  The reference's surface (reference :86-97 windows
every input tensor, :229-233 merges every output, :215-227/:252-310
output merge types cat/add/mean/mul with valid-chunk masking) is kept;
on top of it the default merge here is ``"window"`` — a triangular
cross-fade overlap-add that reconstructs the full-length sequence
without the chunk-boundary discontinuities of plain ``cat``.

All windowing is static-shape: chunks are materialised with a strided
index reshape (one gather at trace time), invalid chunks are masked
with the merge's identity element instead of the reference's per-sample
Python loops (reference :259-276) — so one jit program serves every
batch composition.
"""

from idiaptts_tpu.models import nn
import jax.numpy as jnp
import numpy as np

from idiaptts_tpu.models.config import ModelConfig
from idiaptts_tpu.models.named import broadcast_time, select_lengths


class WindowingWrapper(nn.Module):
    """Applies the wrapped module to overlapping windows and merges.

    output_merge_type:
      - ``"window"`` (default): triangular cross-fade overlap-add back
        to the original length (per-frame outputs).
      - ``"cat"``: concatenate chunk outputs along time (reference
        MERGE_TYPE_CAT, :215-227 — meaningful with step == window).
      - ``"add"`` / ``"mean"`` / ``"mul"``: reduce across a sample's
        valid chunks to one window-length output (reference :252-310),
        e.g. for per-window embeddings/pooling models.
    """

    wrapped: nn.Module
    input_names: tuple
    output_names: tuple
    window_size: int
    window_step: int
    output_merge_type: str = "window"

    def __call__(self, data_dict, lengths=None, training=False):
        lengths = select_lengths(lengths, *self.input_names)
        x0 = jnp.asarray(data_dict[self.input_names[0]])
        B = x0.shape[0]
        # Sequence length = max over ALL inputs (a static 2-D input
        # like a speaker embedding listed first must not disable
        # windowing; reference WindowingWrapper derives T from the
        # merged inputs).
        T = max([jnp.asarray(data_dict[n]).shape[1]
                 for n in self.input_names
                 if jnp.asarray(data_dict[n]).ndim > 2] or [1])
        W, S = self.window_size, self.window_step

        if T <= W:
            out = self.wrapped(
                {n: jnp.asarray(data_dict[n]) for n in self.input_names},
                lengths=lengths, training=training)
            return self._write_back(data_dict, out, set(self.input_names))

        num_windows = int(np.ceil(max(T - W, 0) / S)) + 1
        total = (num_windows - 1) * S + W
        idx = (jnp.arange(num_windows)[:, None] * S
               + jnp.arange(W)[None, :])            # (NW, W)

        windowed = {}
        for name in self.input_names:
            v = jnp.asarray(data_dict[name])
            v = broadcast_time(v, T)                # (B, T, D)
            v = jnp.pad(v, ((0, 0), (0, total - T)) +
                        ((0, 0),) * (v.ndim - 2))
            windows = v[:, idx]                     # (B, NW, W, D)
            windowed[name] = windows.reshape((B * num_windows, W)
                                             + v.shape[2:])

        if lengths is None:
            lengths = jnp.full((B,), T, jnp.int32)
        # Per-chunk valid lengths: chunk c of sample b covers frames
        # [c*S, c*S+W) -> its valid length is clip(len_b - c*S, 0, W).
        starts = jnp.arange(num_windows) * S        # (NW,)
        win_lengths = jnp.clip(lengths[:, None] - starts[None, :],
                               0, W)                # (B, NW)
        num_valid = jnp.sum(win_lengths > 0, axis=1)        # (B,)

        out = self.wrapped(windowed,
                           lengths=win_lengths.reshape(-1),
                           training=training)

        merge = self.output_merge_type
        merged = {}
        for key in out:
            if key in windowed:
                continue
            y = out[key]                            # (B*NW, W', C)
            Wp, C = y.shape[1], y.shape[-1]
            y = y.reshape(B, num_windows, Wp, C)
            if merge == "window":
                if Wp != W:
                    raise ValueError(
                        "window merge needs frame-aligned outputs "
                        "(got %d frames per %d-frame window); use "
                        "cat/add/mean/mul for length-changing models"
                        % (Wp, W))
                merged[key] = self._crossfade(y, idx, B, total, T, C)
            elif merge == "cat":
                merged[key] = y.reshape(B, num_windows * Wp, C)
            elif merge in ("add", "mean", "mul"):
                # Mask invalid chunks with the identity element; the
                # reduce then matches the reference's valid-chunk loops.
                valid = (win_lengths > 0)[:, :, None, None]
                if merge == "mul":
                    y = jnp.where(valid, y, 1.0)
                    merged[key] = jnp.prod(y, axis=1)
                else:
                    y = jnp.where(valid, y, 0.0)
                    summed = jnp.sum(y, axis=1)
                    if merge == "mean":
                        summed = summed / jnp.maximum(
                            num_valid, 1)[:, None, None]
                    merged[key] = summed
            else:
                raise NotImplementedError(
                    "output_merge_type " + merge)
        return self._write_back(data_dict, merged, set())

    @staticmethod
    def _crossfade(y, idx, B, total, T, out_dim):
        """Triangular cross-fade overlap-add of (B, NW, W, C) chunks."""
        W = y.shape[2]
        weight = jnp.minimum(jnp.arange(1, W + 1),
                             jnp.arange(W, 0, -1)).astype(jnp.float32)
        acc = jnp.zeros((B, total, out_dim))
        norm = jnp.zeros((B, total, 1))
        flat_idx = idx.reshape(-1)
        acc = acc.at[:, flat_idx].add(
            (y * weight[None, None, :, None]).reshape(B, -1, out_dim))
        norm = norm.at[:, flat_idx].add(
            jnp.broadcast_to(weight[None, None, :, None],
                             y.shape[:3] + (1,)).reshape(B, -1, 1))
        return (acc / jnp.maximum(norm, 1e-6))[:, :T]

    def _write_back(self, data_dict, out, skip):
        """Positionally rename the wrapped outputs to this wrapper's
        output_names (reference NamedForwardWrapper positional output
        mapping); extra outputs keep their inner names."""
        updated = dict(data_dict)
        new_keys = [k for k in out if k not in skip]
        for i, key in enumerate(new_keys):
            name = (self.output_names[i]
                    if i < len(self.output_names) else key)
            updated[name] = out[key]
        return updated

    class Config(ModelConfig):
        def __init__(self, wrapped_model_config=None, window_size=500,
                     window_step=250, output_merge_type="window",
                     **kwargs):
            super().__init__(**kwargs)
            self.wrapped_model_config = wrapped_model_config
            self.window_size = window_size
            self.window_step = window_step
            self.output_merge_type = output_merge_type

        def create_model(self):
            return WindowingWrapper(
                wrapped=self.wrapped_model_config.create_model(),
                input_names=self.input_names,
                output_names=self.output_names,
                window_size=self.window_size,
                window_step=self.window_step,
                output_merge_type=self.output_merge_type)
