"""STFT, mel filterbank, and Griffin-Lim in JAX.

Replaces the reference's librosa usage (``AudioProcessing.py:156-301``:
``librosa_extract_amp_sp``, ``extract_mfbanks``, ``amp_sp_to_raw`` /
Griffin-Lim, ``Synthesiser.run_griffin_lim`` Synthesiser.py:320-351) with
batched on-device FFTs.  Defaults mirror librosa: hann window, centred
frames with reflect padding, Slaney-style mel filters.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def hann_window(win_length, dtype=jnp.float32):
    n = jnp.arange(win_length, dtype=dtype)
    return 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * n / win_length)


def frame_signal(raw, frame_length, hop_length, center=True):
    """(T,) -> (num_frames, frame_length) via gather; static shapes."""
    if center:
        pad = frame_length // 2
        raw = jnp.pad(raw, (pad, pad), mode="reflect")
    num_frames = 1 + (raw.shape[0] - frame_length) // hop_length
    idx = (jnp.arange(num_frames)[:, None] * hop_length
           + jnp.arange(frame_length)[None, :])
    return raw[idx]


@partial(jax.jit, static_argnames=("n_fft", "hop_length", "win_length",
                                   "center"))
def stft(raw, n_fft=1024, hop_length=256, win_length=None, center=True):
    """librosa-compatible STFT -> complex (num_frames, n_fft // 2 + 1)."""
    if win_length is None:
        win_length = n_fft
    frames = frame_signal(raw, n_fft, hop_length, center)
    window = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = jnp.pad(window, (lpad, n_fft - win_length - lpad))
    return jnp.fft.rfft(frames * window[None, :], n=n_fft, axis=-1)


def amp_spectrum(raw, n_fft=1024, hop_length=256, win_length=None,
                 center=True):
    return jnp.abs(stft(raw, n_fft, hop_length, win_length, center))


@partial(jax.jit, static_argnames=("n_fft", "hop_length", "win_length",
                                   "length"))
def istft(spec, n_fft=1024, hop_length=256, win_length=None, length=None):
    """Inverse STFT with hann-squared overlap-add normalisation."""
    if win_length is None:
        win_length = n_fft
    window = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = jnp.pad(window, (lpad, n_fft - win_length - lpad))
    frames = jnp.fft.irfft(spec, n=n_fft, axis=-1) * window[None, :]
    num_frames = frames.shape[0]
    total = n_fft + hop_length * (num_frames - 1)
    # Restrict to the window support (frames are zero outside it when
    # win_length < n_fft).
    wstart = (n_fft - win_length) // 2 if win_length < n_fft else 0
    eff = frames[:, wstart:wstart + win_length]
    wsq = jnp.broadcast_to(
        window[None, wstart:wstart + win_length] ** 2, eff.shape)
    if win_length % hop_length == 0:
        # Overlap factor k = win / hop: split each frame into k hop
        # chunks and add k diagonally-shifted dense layouts — no
        # scatter (scatter-add with colliding indices serialises).
        k = win_length // hop_length
        pad_frames = num_frames + k

        def overlap_add(x):
            chunks = x.reshape(num_frames, k, hop_length)
            acc = jnp.zeros((pad_frames, hop_length))
            for j in range(k):
                acc = acc.at[j:j + num_frames].add(chunks[:, j])
            flat = acc.reshape(-1)[:total - wstart]
            return jnp.pad(flat, (wstart, 0))[:total]

        raw = overlap_add(eff)
        norm = overlap_add(wsq)
    else:
        offsets = jnp.arange(num_frames) * hop_length + wstart
        idx = offsets[:, None] + jnp.arange(win_length)[None, :]
        raw = jnp.zeros(total).at[idx.reshape(-1)].add(
            eff.reshape(-1))
        norm = jnp.zeros(total).at[idx.reshape(-1)].add(
            wsq.reshape(-1))
    raw = raw / jnp.maximum(norm, 1e-8)
    pad = n_fft // 2
    # Trim the centre padding from BOTH ends (librosa istft semantics):
    # without an explicit length the result is hop * (F - 1) samples.
    raw = raw[pad:total - pad]
    if length is not None:
        raw = jnp.pad(raw, (0, max(0, length - raw.shape[0])))[:length]
    return raw


def hz_to_mel(freq):
    """Slaney mel scale (librosa default)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    # Guard the log for freq=0 entries (taken from the linear branch).
    safe = np.maximum(freq, 1e-10)
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(safe / min_log_hz) / logstep,
                    mel)


def mel_to_hz(mel):
    mel = np.asarray(mel, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freq = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mel >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mel - min_log_mel)), freq)


def mel_filterbank(fs, n_fft, n_mels=80, fmin=0.0, fmax=None, norm="slaney"):
    """(n_mels, n_fft//2+1) triangular filterbank, librosa-compatible."""
    if fmax is None:
        fmax = fs / 2.0
    fft_freqs = np.linspace(0, fs / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


@partial(jax.jit, static_argnames=("n_fft", "hop_length", "win_length",
                                   "num_iters", "length", "momentum"))
def griffin_lim(amp_spec, n_fft=1024, hop_length=256, win_length=None,
                num_iters=50, length=None, seed=0, momentum=0.99):
    """Phase reconstruction by momentum-accelerated iterative STFT
    projection (AudioProcessing.amp_sp_to_raw /
    Synthesiser.run_griffin_lim parity — librosa.griffinlim defaults to
    momentum=0.99, which converges much faster than the plain
    Griffin-Lim alternating projection).

    amp_spec: (num_frames, n_fft//2+1) magnitude.  The iteration is a
    ``lax.fori_loop`` over fused FFT pairs — entirely on device.
    """
    key = jax.random.PRNGKey(seed)
    angles = jax.random.uniform(key, amp_spec.shape, minval=-np.pi,
                                maxval=np.pi)
    spec = amp_spec * jnp.exp(1j * angles)

    def project(spec):
        raw = istft(spec, n_fft, hop_length, win_length, length)
        re = stft(raw, n_fft, hop_length, win_length)
        return re[:amp_spec.shape[0]]

    def body(_, carry):
        spec, prev = carry
        re = project(spec)
        accel = re - (momentum / (1.0 + momentum)) * prev \
            if momentum else re
        phase = accel / jnp.maximum(jnp.abs(accel), 1e-8)
        return amp_spec * phase, re

    spec, _ = jax.lax.fori_loop(0, num_iters, body,
                                (spec, jnp.zeros_like(spec)))
    return istft(spec, n_fft, hop_length, win_length, length)


@partial(jax.jit, static_argnames=("n_fft", "fs", "num_iters"))
def mel_power_to_power_sp(mel_power, fs, n_fft, num_iters=30):
    """Invert a mel-filterbank power projection: given ``m = W @ p``
    (W the (n_mels, bins) filterbank, p the power spectrum), recover a
    non-negative ``p`` (AudioProcessing.mfbanks_to_amp_sp role — the
    reference calls librosa's NNLS ``mel_to_stft``; same caveat applies:
    lossy, "use an SSRN instead").

    Formulation: multiplicative NNLS updates ``p <- p * (W^T m) /
    (W^T W p)`` — monotone in the KL objective, all matmuls, batched
    over frames, static shapes.  Returns (T, n_fft//2+1) power."""
    n_mels = mel_power.shape[-1]
    W = jnp.asarray(mel_filterbank(fs, n_fft, n_mels=n_mels))
    m = jnp.maximum(mel_power, 1e-10)
    # Least-squares warm start, clipped to positive.
    p0 = jnp.maximum(m @ jnp.linalg.pinv(W).T, 1e-10)

    def body(_, p):
        recon = jnp.maximum(p @ W.T, 1e-10)          # (T, n_mels)
        return p * ((m / recon) @ W) / jnp.maximum(
            jnp.sum(W, axis=0)[None, :], 1e-10)

    return jax.lax.fori_loop(0, num_iters, body, p0)


def mfbanks_to_amp_sp(coded_sp, fs, n_fft=None):
    """Log-mel-power features -> amplitude spectrum
    (AudioProcessing.mfbanks_to_amp_sp :291-301 role; input is the
    ``log(amp_sp**2 @ fbank.T)`` coding of
    WorldFeatLabelGen.extract_features)."""
    if n_fft is None:
        from idiaptts_tpu.ops import mcep as mcep_ops
        n_fft = mcep_ops.fs_to_frame_length(fs)
    power = mel_power_to_power_sp(
        jnp.exp(jnp.asarray(coded_sp, jnp.float32)), int(fs),
        int(n_fft))
    return jnp.sqrt(power)


def amp_to_db(amp):
    return 20.0 * jnp.log10(jnp.maximum(amp, 1e-10))


def db_to_amp(db):
    return jnp.power(10.0, db / 20.0)
