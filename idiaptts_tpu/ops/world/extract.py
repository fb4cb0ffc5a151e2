"""Fused WORLD analysis: F0 + envelope + aperiodicity + mcep coding in
ONE jit-compiled program.

The composable pieces (:mod:`f0`, :mod:`cheaptrick`, :mod:`d4c`,
:mod:`idiaptts_tpu.ops.mcep`) each work standalone, but calling them
separately costs a host<->device round trip per stage with (T, 513)
intermediates.  This fused path keeps
everything on device and only transfers the final coded features
(T x (num_sps + 2)), giving corpus extraction throughput.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import importlib

from idiaptts_tpu.ops import mcep as mcep_ops

# The package __init__ re-exports same-named FUNCTIONS; import the
# submodules explicitly.
ct = importlib.import_module("idiaptts_tpu.ops.world.cheaptrick")
d4c_mod = importlib.import_module("idiaptts_tpu.ops.world.d4c")
f0_mod = importlib.import_module("idiaptts_tpu.ops.world.f0")

_LENGTH_BUCKET = 16384


@partial(jax.jit, static_argnames=("fs", "hop", "window", "fft_size",
                                   "num_bands", "order", "alpha"))
def _analysis_jit(raw, fs, hop, window, fft_size, num_bands, order,
                  alpha, uv_cost, trans_w, lag_bias, score_th):
    f0 = f0_mod._extract_f0_jit(raw, fs, hop, 71.0, 800.0, window,
                                uv_cost, trans_w, lag_bias, score_th)
    sp_power = ct._cheaptrick_jit(raw, f0, fs, hop, fft_size)
    ap = d4c_mod._d4c_jit(raw, f0, fs, hop, fft_size, num_bands)
    bap = d4c_mod.code_aperiodicity(ap)
    amp = jnp.sqrt(sp_power)
    coded_sp = mcep_ops.amp_sp_to_mcep(amp, order, alpha)
    return f0, coded_sp, bap


def world_analysis(raw, fs, num_coded_sps=60, frame_shift_ms=5.0,
                   fft_size=None, mgc_alpha=None):
    """Waveform -> (f0, coded_sp, bap) with one device round trip.

    Pads to a length bucket (compile reuse) and trims the frame outputs
    to the true length.  ``mgc_alpha`` overrides the warping
    coefficient (the reference's fixture corpus uses the Merlin-era
    0.58 at 16 kHz, AudioProcessing.py:42 commented table, while its
    live code uses pysptk.mcepalpha -> 0.41).
    """
    # One code path for sync and async: dispatch + wait.
    return world_analysis_result(world_analysis_async(
        raw, fs, num_coded_sps=num_coded_sps,
        frame_shift_ms=frame_shift_ms, fft_size=fft_size,
        mgc_alpha=mgc_alpha))


def world_analysis_async(raw, fs, num_coded_sps=60, frame_shift_ms=5.0,
                         fft_size=None, mgc_alpha=None):
    """Dispatch the fused analysis WITHOUT waiting: returns an opaque
    handle for :func:`world_analysis_result`.  Lets corpus extraction
    double-buffer — dispatch utterance i+1 while utterance i's outputs
    stream back — hiding the per-utterance device round trip."""
    if fft_size is None:
        fft_size = mcep_ops.fs_to_frame_length(fs)
    hop = int(fs * frame_shift_ms / 1000.0)
    window = int(2 ** np.ceil(np.log2(fs * 0.03)))
    alpha = mgc_alpha if mgc_alpha is not None \
        else mcep_ops.fs_to_mgc_alpha(fs)
    num_bands = max(1, d4c_mod.get_num_aperiodicities(fs))

    raw = np.asarray(raw, dtype=np.float32)
    num_frames = max(1, 1 + (len(raw) - 1) // hop)
    padded_len = int(np.ceil(max(len(raw), 1) / _LENGTH_BUCKET)
                     * _LENGTH_BUCKET)
    padded = np.zeros(padded_len, dtype=np.float32)
    padded[:len(raw)] = raw
    outputs = _analysis_jit(
        jnp.asarray(padded), int(fs), hop, window, int(fft_size),
        num_bands, num_coded_sps - 1, float(alpha),
        jnp.float32(f0_mod._UNVOICED_COST),
        jnp.float32(f0_mod._TRANSITION_W),
        jnp.float32(f0_mod._LAG_BIAS), jnp.float32(0.47))
    return outputs, num_frames, raw, fs, frame_shift_ms


def world_analysis_result(handle, vuv_refine=True):
    """Materialise a :func:`world_analysis_async` handle ->
    (f0, coded_sp, bap) trimmed to the true frame count.

    ``vuv_refine`` applies the host-side four-interval voicing decision
    (:func:`idiaptts_tpu.ops.world.f0.refine_vuv`) to the returned f0
    track, matching the standalone :func:`extract_f0` path.  The
    envelope/aperiodicity were computed with the in-jit voicing; on the
    few flipped frames they fall back to the default-window analysis —
    the same defaulting pyworld applies to unvoiced frames."""
    (f0, coded_sp, bap), num_frames, raw, fs, frame_shift_ms = handle
    f0, coded_sp, bap = jax.device_get((f0, coded_sp, bap))
    f0 = f0[:num_frames]
    if vuv_refine:
        f0 = f0_mod.refine_vuv(raw, fs, f0, frame_shift_ms)
    return (f0, coded_sp[:num_frames], bap[:num_frames])
