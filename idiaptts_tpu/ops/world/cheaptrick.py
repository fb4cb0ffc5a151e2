"""CheapTrick-style pitch-adaptive spectral envelope estimation.

Fills the role of pyworld's CheapTrick (used inside ``wav2world``,
``WorldFeatLabelGen.world_extract_features`` WorldFeatLabelGen.py:792).

Formulation: the pitch-adaptive analysis window (length
``3 * fs / f0``) is realised as a masked fixed-size window so every frame
runs the same static-shape program; power spectra come from one batched
FFT; the rectangular frequency smoothing of width ``2 f0 / 3`` is a
cumsum + linear-interp gather; and the quefrency liftering (sinc
smoothing lifter and q1 compensation lifter) is a pair of batched
FFT/iFFTs.  Numerical parity with pyworld is validated to tolerance in
tests via round-trip MCD on the reference fixtures.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_DEFAULT_F0 = 500.0   # envelope analysis f0 for unvoiced frames
_F0_CEIL = 800.0      # highest trackable f0 (matches f0.py's ceiling)
_Q1 = -0.15           # spectral recovery lifter coefficient


@partial(jax.jit, static_argnames=("fs", "hop", "fft_size"))
def _cheaptrick_jit(raw, f0, fs, hop, fft_size):
    T = f0.shape[0]
    num_bins = fft_size // 2 + 1
    f0_eff = jnp.where(f0 > 0, f0, _DEFAULT_F0)
    f0_eff = jnp.maximum(f0_eff, 3.0 * fs / fft_size)

    # --- pitch-adaptive masked windowing -----------------------------
    # Gather-free framing: frame starts lie on the hop grid, so the
    # (T, fft_size) windows are shifted SLICES of the hop-reshaped
    # signal (no large dynamic gather).
    half_max = fft_size // 2
    offs = jnp.arange(fft_size) - half_max            # [-half, half)
    rows_per_frame = -(-fft_size // hop) + 1
    padded = jnp.pad(raw, (half_max,
                           rows_per_frame * hop + hop * T))
    rows = padded[:(T + rows_per_frame) * hop].reshape(-1, hop)
    segs = jnp.concatenate(
        [rows[i:i + T] for i in range(rows_per_frame)],
        axis=1)[:, :fft_size]                         # (T, fft_size)

    half_win = 1.5 * fs / f0_eff                      # (T,)
    t_norm = offs[None, :] / half_win[:, None]        # in [-1, 1] inside
    in_win = jnp.abs(t_norm) <= 1.0
    window = jnp.where(in_win, 0.5 + 0.5 * jnp.cos(jnp.pi * t_norm), 0.0)
    window = window / jnp.sqrt(
        jnp.sum(window ** 2, axis=1, keepdims=True) + 1e-12)
    windowed = segs * window
    # Remove windowed DC (WORLD subtracts the weighted mean).
    wsum = jnp.sum(window, axis=1, keepdims=True)
    windowed = windowed - window * (
        jnp.sum(windowed, axis=1, keepdims=True) / jnp.maximum(wsum, 1e-9))

    power = jnp.abs(jnp.fft.rfft(windowed, n=fft_size, axis=-1)) ** 2

    # --- DC correction: mirror the band below f0 ---------------------
    # Only bins below f0 (< ~64 for speech at these fft sizes) receive
    # the correction; gathering a narrow slab instead of all bins keeps
    # the dynamic gather off the hot path.
    bin_hz = fs / fft_size
    # Cover every bin below the highest possible f0 (a fixed 64 cap
    # silently truncated the mirror correction for large fft_size/fs
    # ratios, e.g. 16 kHz at fft 2048 with f0 near 800 Hz).
    K_MIRROR = min(int(np.ceil(_F0_CEIL * fft_size / fs)) + 2,
                   num_bins)
    freqs_m = jnp.arange(K_MIRROR) * bin_hz
    mirror_bin = (2.0 * f0_eff[:, None] - freqs_m[None, :]) / bin_hz
    mirror_bin = jnp.clip(mirror_bin, 0, num_bins - 1)
    lo = jnp.floor(mirror_bin).astype(jnp.int32)
    hi = jnp.minimum(lo + 1, num_bins - 1)
    frac = mirror_bin - lo
    mirrored = (jnp.take_along_axis(power, lo, axis=1) * (1 - frac)
                + jnp.take_along_axis(power, hi, axis=1) * frac)
    below = freqs_m[None, :] < f0_eff[:, None]
    power = power.at[:, :K_MIRROR].add(jnp.where(below, mirrored, 0.0))

    # --- rectangular smoothing of width 2 f0 / 3 ---------------------
    # Frequency-domain convolution with a per-frame fractional-width
    # rect == multiplying the power "cepstrum" by sinc(pi W q / n)
    # (gather-free; the even rfft/irfft symmetry gives reflection
    # boundary handling, equivalent to the cumsum formulation away from
    # the edges).
    width_bins = (2.0 * f0_eff / 3.0) / bin_hz        # (T,)
    pq = jnp.fft.rfft(
        jnp.concatenate([power, power[:, -2:0:-1]], axis=1), axis=1)
    m = jnp.arange(num_bins)
    sarg = jnp.pi * width_bins[:, None] * m[None, :] / fft_size
    rect_mult = jnp.where(sarg > 1e-6,
                          jnp.sin(sarg) / jnp.maximum(sarg, 1e-6), 1.0)
    smoothed = jnp.fft.irfft(pq * rect_mult, n=fft_size,
                             axis=1)[:, :num_bins]
    smoothed = jnp.maximum(smoothed, 0.0)

    # --- quefrency liftering with spectral recovery -------------------
    # Relative spectral floor (-90 dB per frame) bounds the dynamic
    # range before the log: without it, deep inter-harmonic notches make
    # the cepstral lifter ring to absurd values (-300 dB) that no
    # synthesis round-trip can reproduce.
    frame_max = jnp.max(smoothed, axis=1, keepdims=True)
    floor = jnp.maximum(frame_max * 1e-9, 1e-30)
    log_p = jnp.log(jnp.maximum(smoothed, floor))
    cep = jnp.fft.irfft(log_p, n=fft_size, axis=-1)
    q_idx = jnp.arange(fft_size)
    q = jnp.minimum(q_idx, fft_size - q_idx) / fs      # symmetric quefrency
    arg = jnp.pi * f0_eff[:, None] * q[None, :]
    sinc = jnp.where(arg > 1e-6, jnp.sin(arg) / jnp.maximum(arg, 1e-6), 1.0)
    comp = (1.0 - 2.0 * _Q1) + 2.0 * _Q1 * jnp.cos(2.0 * arg)
    cep = cep * sinc * comp
    log_env = jnp.fft.rfft(cep, n=fft_size, axis=-1).real
    log_env = jnp.maximum(log_env, jnp.log(floor))     # lifter undershoot
    return jnp.exp(log_env)                            # power envelope


_FRAME_BUCKET = 256  # pad frame counts -> few distinct compilations


def _bucket_frames(raw, f0, hop):
    """Pad (raw, f0) to a frame-count bucket for compile reuse."""
    T = len(f0)
    T_pad = int(np.ceil(max(T, 1) / _FRAME_BUCKET) * _FRAME_BUCKET)
    f0_p = np.zeros(T_pad, dtype=np.float32)
    f0_p[:T] = np.asarray(f0, dtype=np.float32).reshape(-1)
    raw = np.asarray(raw, dtype=np.float32)
    n_needed = T_pad * hop
    raw_p = np.zeros(max(n_needed, len(raw)), dtype=np.float32)
    raw_p[:len(raw)] = raw
    return raw_p, f0_p, T


def cheaptrick(raw, f0, fs, frame_shift_ms=5.0, fft_size=None):
    """Power spectral envelope (T, fft_size//2+1) for a waveform + f0
    track (pyworld.cheaptrick equivalent)."""
    from idiaptts_tpu.ops.mcep import fs_to_frame_length
    if fft_size is None:
        fft_size = fs_to_frame_length(fs)
    hop = int(fs * frame_shift_ms / 1000.0)
    raw_p, f0_p, T = _bucket_frames(raw, f0, hop)
    out = _cheaptrick_jit(jnp.asarray(raw_p), jnp.asarray(f0_p),
                          int(fs), hop, int(fft_size))
    return out[:T]
