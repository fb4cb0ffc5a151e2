"""WORLD-style waveform synthesis: phase-coherent harmonics + shaped noise.

Fills the role of pyworld.synthesize (``WorldFeatLabelGen
.world_features_to_raw`` WorldFeatLabelGen.py:909-945).

Formulation: instead of WORLD's per-pitch-mark impulse
response overlap-add (irregular, data-dependent), the voiced part is an
additive harmonic model — per-sample phase accumulation ``phi_h[n] =
2*pi*h*cumsum(f0)/fs`` (one cumsum; phase-coherent across frames) with
harmonic amplitudes sampled from the spectral envelope (cepstral
expansion + Chebyshev cosine recurrence — no gathers) and linearly upsampled from frame to sample rate —
and the unvoiced part is white noise shaped by ``envelope *
aperiodicity`` via one batched STFT multiply + overlap-add.  Everything
is dense static-shape tensor work (FFTs, one cumsum, fused mul-adds)
that XLA fuses on device.

Amplitude calibration: for the analysis convention in
:mod:`cheaptrick` (unit-energy window, power smoothed over ``2 f0 / 3``)
a harmonic of envelope power ``E`` needs amplitude
``A_h = 2 * sqrt(E * f0 / fs)`` and the noise spectrum multiplier
is ``sqrt(E * win / 2)`` — the round-trip test asserts re-analysis
recovers the envelope with exactly these constants.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


# Degree-9 odd minimax polynomial for sin(pi*t) on [-1, 1]
# (max error 5.9e-6 = -104 dB, inaudible).  XLA's sin spends most of
# its work in range reduction we have already done (the phase is kept
# in cycles in [0, 1)), so a 5-term Horner chain is cheaper for the
# harmonic bank.
_SIN_C1 = 3.1415284229461573
_SIN_C3 = -5.166408786411196
_SIN_C5 = 2.5427382100290914
_SIN_C7 = -0.5818930905684506
_SIN_C9 = 0.06404115475945735


def _sin_cycles(x):
    """sin(2*pi*x) for x in [0, 1) via sin(pi*t), t = 2x-1 in [-1, 1):
    sin(2*pi*x) = -sin(pi*t)."""
    t = 2.0 * x - 1.0
    t2 = t * t
    p = _SIN_C9
    p = p * t2 + _SIN_C7
    p = p * t2 + _SIN_C5
    p = p * t2 + _SIN_C3
    p = p * t2 + _SIN_C1
    return -(t * p)


def _sample_log_field(log_field, x, num_ceps=64):
    """Evaluate a smooth log-spectral field at arbitrary frequencies
    WITHOUT gathers (arithmetic on the dense field instead of an
    index lookup per harmonic).

    log_field: (T, K) over bins [0, fs/2]; x: (T, H) frequency in
    cycles/sample in [0, 0.5].  Returns (T, H).

    Method: real cepstrum of the field (one irfft), then
    ``log_field(2*pi*x) = c0 + 2 * sum_m c_m cos(2*pi*m*x)`` evaluated
    with the Chebyshev recurrence ``cos((m+1)t) = 2cos(t)cos(mt) -
    cos((m-1)t)`` — one real cos total, the rest fused mul-adds.
    Exact for fields whose cepstrum dies within ``num_ceps`` terms
    (CheapTrick envelopes and band-interpolated aperiodicity are that
    smooth by construction)."""
    K = log_field.shape[1]
    n_fft = 2 * (K - 1)
    ceps = jnp.fft.irfft(log_field, n=n_fft, axis=1)[:, :num_ceps]
    theta = (2.0 * jnp.pi) * x
    cos1 = jnp.cos(theta)
    acc = ceps[:, 0:1] + 2.0 * ceps[:, 1:2] * cos1

    def body(m, carry):
        c_prev, c_cur, acc = carry
        c_next = 2.0 * cos1 * c_cur - c_prev
        w = jax.lax.dynamic_slice_in_dim(ceps, m, 1, axis=1)  # (T, 1)
        return (c_cur, c_next, acc + 2.0 * w * c_next)

    _, _, acc = jax.lax.fori_loop(
        2, num_ceps, body, (jnp.ones_like(cos1), cos1, acc))
    return acc


def _harmonic_bank(f0_safe, amp, fs, hop):
    """N-domain additive synthesis shared by the field-sampled and
    direct-mcep harmonic paths: per-sample phase accumulation + the
    minimax sin bank.  amp (T, H) per-frame harmonic amplitudes."""
    # Finite-synthesis guard: an unbounded f0 (e.g. exp of an untrained
    # model's lf0) overflows the phase cumsum to inf and mod(inf)=nan
    # poisons the whole waveform.  Above-Nyquist pitch is meaningless
    # anyway, so clamp — garbage in must give loud garbage out, never
    # NaN (the reference's WORLD C code is finite the same way).
    f0_safe = jnp.clip(f0_safe, 0.0, fs / 2.0)
    T, H = amp.shape
    h = jnp.arange(1, H + 1, dtype=jnp.float32)
    # Per-sample upsampling via reshape (no gathers): sample n in frame
    # chunk t uses weights (1-k/hop, k/hop) against frames t, t+1.
    N = T * hop
    w = (jnp.arange(hop) / hop)                        # (hop,)
    f0_next = jnp.concatenate([f0_safe[1:], f0_safe[-1:]])
    f0_s = (f0_safe[:, None] * (1 - w)[None, :]
            + f0_next[:, None] * w[None, :]).reshape(N)
    # Phase accumulation in cycles with PER-FRAME wrapping: a flat f32
    # cumsum loses ~1e-3 cycles after a minute of audio (ulp of 1e8
    # samples' worth of phase), which harmonic h multiplies h-fold.
    # Instead accumulate the frame-start offset with a scan that wraps
    # mod 1 every frame (the carry never exceeds ~hop*f0max/fs cycles,
    # so each step is f32-exact to ~1e-7) and add the small in-frame
    # cumsum on top.
    inc = (f0_s / fs).reshape(T, hop)
    frame_sum = jnp.sum(inc, axis=1)                   # (T,)

    def wrap_step(offset, s):
        new = jnp.mod(offset + s, 1.0)
        return new, offset

    _, frame_offset = jax.lax.scan(wrap_step, jnp.float32(0.0),
                                   frame_sum)
    inner = jnp.cumsum(inc, axis=1)                    # (T, hop)
    cycles = jnp.mod(frame_offset[:, None] + inner, 1.0).reshape(N)
    arg = jnp.mod(cycles[:, None] * h[None, :], 1.0)   # (N, H) in [0,1)

    amp_next = jnp.concatenate([amp[1:], amp[-1:]], axis=0)
    amp_s = (amp[:, None, :] * (1 - w)[None, :, None]
             + amp_next[:, None, :] * w[None, :, None]).reshape(N, -1)
    return jnp.sum(amp_s * _sin_cycles(arg), axis=1)


@partial(jax.jit, static_argnames=("fs", "hop", "max_harmonics"))
def _harmonic_part(f0, f0_cont, sp_power, ap, fs, hop, max_harmonics):
    """Additive harmonic synthesis.  f0 (T,) with unvoiced zeros,
    f0_cont (T,) gap-filled pitch for phase, sp_power (T, K),
    ap (T, K) -> (T * hop,) waveform."""
    T, num_bins = sp_power.shape
    n_fft = 2 * (num_bins - 1)
    bin_hz = fs / n_fft
    voiced = f0 > 0
    # f0_cont: continuous pitch for phase accumulation — holding the
    # last voiced value across gaps avoids broadband chirps at voicing
    # boundaries (amplitude alone ramps to zero there).
    f0_safe = f0_cont

    h = jnp.arange(1, max_harmonics + 1, dtype=jnp.float32)
    harm_freq = h[None, :] * f0_safe[:, None]          # (T, H)
    below_nyq = harm_freq < (fs / 2.0 - bin_hz)

    x = jnp.clip(harm_freq / fs, 0.0, 0.5)            # cycles/sample
    log_env = 0.5 * jnp.log(jnp.maximum(sp_power, 1e-30))   # log amp
    log_ap = jnp.log(jnp.maximum(ap, 1e-9))
    # Clip before exp: log amplitudes beyond ~25 (120 dB above unit)
    # only arise from divergent model outputs and would overflow f32
    # to inf, which the mask multiplies below turn into NaN.
    env_p = jnp.exp(2.0 * jnp.clip(_sample_log_field(log_env, x),
                                   -60.0, 25.0))
    ap_h = jnp.exp(jnp.clip(_sample_log_field(log_ap, x), -60.0, 0.0))
    periodic_frac = jnp.sqrt(jnp.clip(1.0 - ap_h ** 2, 0.0, 1.0))
    # Calibrated so cheaptrick re-analysis recovers sp_power (flat to
    # ±0.3 dB in the round-trip test).
    amp = 2.0 * jnp.sqrt(env_p * f0_safe[:, None] / fs)
    amp = amp * periodic_frac * below_nyq * voiced[:, None]
    return _harmonic_bank(f0_safe, amp, fs, hop)


def _ap_at_freqs(bap, freqs, fs):
    """Aperiodicity ratio evaluated directly at arbitrary frequencies
    (T, H) — same piecewise-linear-in-log band model as
    d4c.decode_aperiodicity, without materialising the bin grid.
    bap (T, NB) coded log ratios; freqs (T, H) Hz."""
    from idiaptts_tpu.ops.world.d4c import _AP_FLOOR
    num_bands = bap.shape[-1]
    log_floor = float(np.log(_AP_FLOOR))
    log_ratio = jnp.clip(bap, log_floor, 0.0)
    anchors_f = np.concatenate([
        [0.0], 3000.0 * (np.arange(num_bands) + 1.0), [fs / 2.0]])
    anchors_v = jnp.concatenate(
        [jnp.full(bap.shape[:-1] + (1,), log_floor),
         log_ratio, log_ratio[..., -1:]], axis=-1)   # (T, NB + 2)
    ap_log = jnp.broadcast_to(anchors_v[..., -1:], freqs.shape)
    # Static segment sweep (<= 6 segments): later matches overwrite.
    for s in range(len(anchors_f) - 1, 0, -1):
        f_lo, f_hi = anchors_f[s - 1], anchors_f[s]
        w = (freqs - f_lo) / max(f_hi - f_lo, 1e-9)
        seg = (anchors_v[..., s - 1:s] * (1.0 - w)
               + anchors_v[..., s:s + 1] * w)
        ap_log = jnp.where(freqs < f_hi, seg, ap_log)
    return jnp.clip(jnp.exp(ap_log), _AP_FLOOR, 1.0)


@partial(jax.jit,
         static_argnames=("fs", "hop", "alpha", "max_harmonics"))
def _harmonic_part_mcep(f0, f0_cont, coded, bap, fs, hop, alpha,
                        max_harmonics):
    """Harmonic synthesis straight from coded features: the mel-cepstral
    log envelope ``log_amp(w) = sum_m c_m cos(m * beta(w))`` (the exact
    model mcep_to_amp_sp renders onto a bin grid, ops/mcep.py:132) is
    evaluated directly at the harmonic frequencies via the analytic
    all-pass warp — skipping the grid render, the re-cepstrum irfft and
    the 64-term resampling recurrence of the field-sampled path
    (~3x vocoder-stage time at bench shapes).  Numerically this is the
    same function _harmonic_part approximates through its smooth-field
    resampling, so the two paths agree to the resampling tolerance."""
    T = coded.shape[0]
    voiced = f0 > 0
    f0_safe = f0_cont
    h = jnp.arange(1, max_harmonics + 1, dtype=jnp.float32)
    harm_freq = h[None, :] * f0_safe[:, None]          # (T, H)
    below_nyq = harm_freq < (fs / 2.0 * (1.0 - 2.0 / 1024.0))

    omega = (2.0 * jnp.pi) * jnp.clip(harm_freq / fs, 0.0, 0.5)
    beta = omega + 2.0 * jnp.arctan2(
        alpha * jnp.sin(omega), 1.0 - alpha * jnp.cos(omega))
    # log_amp = sum_m c_m cos(m beta): Chebyshev recurrence, statically
    # unrolled over the cepstral order (order+1 fused fma steps).
    cos1 = jnp.cos(beta)
    c_prev = jnp.ones_like(cos1)
    c_cur = cos1
    log_amp = coded[:, 0:1] + coded[:, 1:2] * cos1
    for m in range(2, coded.shape[-1]):
        c_prev, c_cur = c_cur, 2.0 * cos1 * c_cur - c_prev
        log_amp = log_amp + coded[:, m:m + 1] * c_cur
    # Clip before exp (see _harmonic_part): keeps divergent model
    # outputs finite instead of inf * mask -> NaN.
    env_p = jnp.exp(2.0 * jnp.clip(log_amp, -60.0, 25.0))

    ap_h = _ap_at_freqs(bap, harm_freq, fs)
    periodic_frac = jnp.sqrt(jnp.clip(1.0 - ap_h ** 2, 0.0, 1.0))
    amp = 2.0 * jnp.sqrt(env_p * f0_safe[:, None] / fs)
    amp = amp * periodic_frac * below_nyq * voiced[:, None]
    return _harmonic_bank(f0_safe, amp, fs, hop)


@partial(jax.jit, static_argnames=("fs", "hop"))
def _noise_part(f0, sp_power, ap, fs, hop, key):
    """Shaped-noise synthesis directly in the frequency domain.

    Instead of time-domain white noise -> STFT -> multiply -> iSTFT
    (gather-framing and a colliding scatter overlap-add), draw each frame's spectrum as iid complex Gaussians,
    scale by the target amplitude, and overlap-add the windowed
    irffts on a dense hop-aligned layout (no gathers or scatters).

    Statistics: a frame spectrum X_k = Z_k * A_k with Z ~ CN(0,1)
    gives the irfft'd frame a two-sided power density p2(w_k) =
    E|X_k|^2 / n_fft = |A_k|^2 / n_fft at each of the mirrored lines
    (Parseval: var = (1/n_fft) sum_j p2(w_j) = (1/n_fft^2)
    sum_j E|X_full,j|^2).  The analysis convention (hann(win) STFT with
    E|X_analysis|^2 = p2 * sum w^2, matched to cheaptrick's smoothed
    power in the round-trip test) requires p2(w_k) = target_k^2 *
    (win / 2) / sum w^2, so the closed-form scale is
    ``sqrt(n_fft * win / (2 sum w^2))`` — pure window algebra, no
    fitted constants (verified against the true-STFT implementation's
    measured PSD: flat to <0.1 dB).  Overlap-added iid frames are
    renormalised by sqrt(sum_t w(n - t hop)^2) (a trace-time constant)
    so the local variance equals a single frame's exactly."""
    T, num_bins = sp_power.shape
    n_fft = 2 * (num_bins - 1)
    N = T * hop
    # Short hop-multiple window (~4 hops, like the old STFT path's
    # min(n_fft, 4 hop)) keeps the noise energy local in time — a
    # frame-length window would smear quiet frames with energy from
    # loud neighbours.  Hop-multiple => dense overlap-add with
    # k = win // hop diagonally-shifted layouts (no scatters).  The
    # scale below is window-length independent for hann (sum w^2 =
    # (3/8) win cancels), so the choice only affects time resolution.
    # The window must fit inside the irfft frame; callers size the
    # bin grid so n_fft >= hop (see _vocode_one).
    if n_fft < hop:
        raise ValueError(
            "noise grid too small: n_fft {} < hop {} (increase "
            "num_bins so 2*(num_bins-1) >= hop)".format(n_fft, hop))
    k = max(1, min(4, n_fft // hop))
    win = k * hop
    w_np = np.asarray(0.5 - 0.5 * np.cos(
        2.0 * np.pi * np.arange(win) / win), np.float32)
    wsum2 = float((w_np ** 2).sum())
    scale = float(np.sqrt(n_fft * win / (2.0 * wsum2)))

    kr, ki = jax.random.split(key)
    target = jnp.sqrt(jnp.maximum(sp_power, 0.0)) * ap
    z = (jax.random.normal(kr, (T, num_bins))
         + 1j * jax.random.normal(ki, (T, num_bins)))
    frames = jnp.fft.irfft(z * (target * (scale / np.sqrt(2.0))),
                           n=n_fft, axis=-1)[:, :win] * w_np[None, :]

    def overlap_add(x, rows):
        chunks = x.reshape(rows, k, hop)
        acc = jnp.zeros((rows + k, hop), x.dtype)
        for j in range(k):
            acc = acc.at[j:j + rows].add(chunks[:, j])
        return acc.reshape(-1)[:rows * hop]

    raw = overlap_add(frames, T)
    norm = overlap_add(jnp.broadcast_to(w_np[None, :] ** 2,
                                        (T, win)), T)
    return raw * jax.lax.rsqrt(jnp.maximum(norm, 1e-12))


def world_synthesis(f0, sp_power, ap, fs, frame_shift_ms=5.0, seed=0):
    """Synthesise a waveform from WORLD-style features.

    f0: (T,) Hz with 0 = unvoiced; sp_power: (T, num_bins) power
    envelope (CheapTrick convention); ap: (T, num_bins) aperiodicity
    amplitude ratio in [0, 1].  Returns (T * hop,) float32 waveform.
    """
    from idiaptts_tpu.ops.interpolation import interpolate_lin
    hop = int(fs * frame_shift_ms / 1000.0)
    f0 = np.asarray(f0, np.float32).reshape(-1)
    f0_cont = interpolate_lin(f0)[0][:, 0]
    f0_cont = np.where(f0_cont > 0, f0_cont, 150.0)  # all-unvoiced guard
    f0 = jnp.asarray(f0)
    f0_cont = jnp.asarray(f0_cont, jnp.float32)
    sp_power = jnp.asarray(sp_power, jnp.float32)
    ap = jnp.asarray(ap, jnp.float32)
    max_harmonics = int(fs / 2.0 / 55.0)
    harm = _harmonic_part(f0, f0_cont, sp_power, ap, int(fs), hop,
                          max_harmonics)
    key = jax.random.PRNGKey(seed)
    noise = _noise_part(f0, sp_power, ap, int(fs), hop, key)
    return harm + noise
