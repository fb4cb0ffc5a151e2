"""Band aperiodicity estimation (D4C role) + WORLD-compatible coding.

Fills the role of pyworld's D4C + ``code_aperiodicity`` /
``decode_aperiodicity`` (``WorldFeatLabelGen.world_extract_features``
WorldFeatLabelGen.py:805, ``world_features_to_raw`` :940).

Formulation — chirp-corrected pitch-synchronous probing:
the f0 TRACK defines a continuous fundamental phase
``phi(n) = 2*pi*cumsum(f0)/fs``; demodulating the windowed frame at
``exp(-j*k*phi)`` concentrates harmonic k at DC *even under f0 drift*
(the classic failure mode of fixed-lag or fixed-bin measures).  Integer
``k`` slots measure harmonic power, half-integer slots (between
harmonics) measure the noise density.  With a Nuttall window of 8
periods (sidelobes < -90 dB, mainlobe < f0/2) the per-band aperiodicity

    ap^2 = N_band / (N_band + P_band)
    P_band = sum_h 2*(|S_h|^2 - noise_slot) / (sum w)^2
    N_band = noise_slot * 2 * BW / fs            (with sum w^2 = 1)

is an EXACT noise-amplitude-fraction estimator: on synthetic
harmonic+noise signals with known per-band ratios it recovers the truth
to a few percent at 16/22.05/48 kHz with NO calibration constants
(tests/unit/test_world_d4c_synthetic.py).

D4C observable scale: WORLD's D4C statistic (group-delay concentration
+ the LoveTrain periodicity gate) reports far smaller values on voiced
speech (its fixture tracks span ln-ap [-20.7, 0] where the physical
noise fraction spans [-4.2, 0]) because it deliberately excludes
deterministic jitter/shimmer sidebands and clamps strongly-periodic
frames to a safeguard floor.  For feature-space compatibility the
default output applies the fixed log-domain statistic conversion
``ln ap_d4c = A * ln ap_ratio + B`` below.  Unlike the round-2
calibration (which compensated a RATE-DEPENDENT floor of the old
pitch-lag statistic), this map converts between two well-defined
statistics on top of a rate-exact measurement, so it transfers across
sample rates by construction; the raw ratio is available via
``d4c_scale=False``.  Note the reference's own per-frame fine detail is
majority estimator noise (lag-1 autocorrelation 0.46 inside its
measured region on the fixture tracks), which bounds any clean
estimator's frame-level correlation with it.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_AP_FLOOR = 1e-9
_WINDOW_PERIODS = 8.0   # Nuttall mainlobe halfwidth ~4/T_w < f0/2
_F0_FLOOR = 71.0
_DEFAULT_F0 = 160.0     # phase track through unvoiced stretches

# Statistic conversion (measured noise-amplitude fraction -> D4C's
# observable scale), fit once as a robust 10-90% quantile line through
# the voiced (ln ap_ratio, ln ap_d4c) pairs of the reference fixture
# corpus (median-exact by construction; the clip at 0 preserves
# ap_ratio=1 -> ap_d4c=1); see module docstring for why this transfers
# across sample rates.
_D4C_SCALE_A = 5.30
_D4C_SCALE_B = 6.84


def get_num_aperiodicities(fs):
    """Number of coded aperiodicity bands
    (AudioProcessing.py:71 via pyworld.get_num_aperiodicities):
    WORLD uses bands of 3 kHz starting at 3 kHz."""
    return int(min(15000.0, fs / 2.0 - 3000.0) / 3000.0)


def _nuttall(t_norm):
    """Nuttall window on |t_norm| <= 1 (masked outside)."""
    inside = jnp.abs(t_norm) <= 1.0
    x = jnp.pi * (t_norm + 1.0)          # [0, 2*pi] inside
    w = (0.355768 - 0.487396 * jnp.cos(x) + 0.144232 * jnp.cos(2 * x)
         - 0.012604 * jnp.cos(3 * x))
    return jnp.where(inside, w, 0.0)


@partial(jax.jit, static_argnames=("fs", "hop", "fft_size", "num_bands",
                                   "d4c_scale"))
def _d4c_jit(raw, f0, fs, hop, fft_size, num_bands, d4c_scale=True):
    """Chirp-corrected harmonic/half-harmonic probe aperiodicity.

    ``fft_size`` is kept for signature compatibility (the probe method
    needs no FFT grid).
    """
    T = f0.shape[0]
    f0_eff = jnp.where(f0 > 0, jnp.maximum(f0, _F0_FLOOR), _DEFAULT_F0)

    # --- continuous fundamental phase from the track ------------------
    f0_samples = jnp.repeat(f0_eff, hop, total_repeat_length=T * hop)
    need = T * hop + hop
    f0_samples = jnp.pad(f0_samples, (0, need - T * hop), mode="edge")
    # Accumulate the phase with per-hop wrapping mod 2 cycles (= 4*pi):
    # a flat f32 cumsum drifts ~0.016 rad after a minute of audio,
    # which the k/2 slot phasors amplify k/2-fold.  Every half-integer
    # slot phasor exp(-i*(k/2)*phi) is 4*pi-periodic, so the wrap is
    # exact.
    inc = (f0_samples / fs).reshape(-1, hop)             # cycles
    chunk_sum = jnp.sum(inc, axis=1)

    def _wrap(offset, s):
        return jnp.mod(offset + s, 2.0), offset

    _, offsets = jax.lax.scan(_wrap, jnp.float32(0.0), chunk_sum)
    cycles = jnp.mod(offsets[:, None] + jnp.cumsum(inc, axis=1), 2.0)
    phi = (2.0 * jnp.pi) * cycles.reshape(-1)             # (need,)

    # --- gather-free framing (hop-grid slices) ------------------------
    W = int(2 ** np.ceil(np.log2(_WINDOW_PERIODS * fs / _F0_FLOOR)))
    half = W // 2
    rows_per_frame = -(-W // hop) + 1
    ext = rows_per_frame * hop

    def frame(sig, fill):
        sp = jnp.pad(sig, (half, ext + hop), constant_values=fill)
        rows = sp[:(T + rows_per_frame) * hop].reshape(-1, hop)
        return jnp.concatenate(
            [rows[i:i + T] for i in range(rows_per_frame)],
            axis=1)[:, :W]                                 # (T, W)

    N = raw.shape[0]
    x_f = frame(jnp.pad(raw, (0, max(0, need - N)))[:need], 0.0)
    phi_f = frame(phi, 0.0)
    # Phase relative to the frame centre keeps exp() arguments small.
    phi_f = phi_f - phi_f[:, half:half + 1]

    # --- masked pitch-adaptive Nuttall window -------------------------
    offs = jnp.arange(W) - half
    half_win = jnp.minimum(0.5 * _WINDOW_PERIODS * fs / f0_eff,
                           float(half - 1))
    t_norm = offs[None, :] / half_win[:, None]
    w = _nuttall(t_norm)
    w = w / jnp.sqrt(jnp.sum(w ** 2, axis=1, keepdims=True) + 1e-20)
    wsum2 = jnp.sum(w, axis=1) ** 2                        # (T,)
    xw = (x_f * w).astype(jnp.complex64)

    # --- S_k for k = 0.5, 1.0, ... via incremental half-step phasors --
    K_half = int(2 * np.floor((fs / 2.0) / _F0_FLOOR))     # slot count
    v_half = jnp.exp(-0.5j * phi_f).astype(jnp.complex64)

    def body(z, _):
        s = jnp.sum(xw * z, axis=1)                        # (T,)
        return z * v_half, s

    _, S = jax.lax.scan(body, v_half, None, length=K_half)
    S = jnp.transpose(S)                                   # (T, K_half)
    P = jnp.abs(S) ** 2
    ks = (jnp.arange(K_half) + 1) * 0.5                    # 0.5, 1.0, ..
    freqs = ks[None, :] * f0_eff[:, None]                  # (T, K)
    is_harm = (jnp.arange(K_half) % 2) == 1                # k integer
    valid = freqs < (fs / 2.0 - 0.5 * f0_eff[:, None])

    # --- per-band accounting ------------------------------------------
    edges = [0.0] + [3000.0 * (b + 1) + 1500.0
                     for b in range(num_bands - 1)] + [fs / 2.0 + 1.0]
    aps = []
    for b in range(num_bands):
        in_band = (freqs >= edges[b]) & (freqs < edges[b + 1]) & valid
        noise_m = in_band & (~is_harm)[None, :]
        harm_m = in_band & is_harm[None, :]
        n_noise = jnp.sum(noise_m, axis=1)
        noise_slot = jnp.sum(jnp.where(noise_m, P, 0.0), axis=1) \
            / jnp.maximum(n_noise, 1)
        p_per = jnp.sum(jnp.where(
            harm_m, jnp.maximum(P - noise_slot[:, None], 0.0), 0.0),
            axis=1) * 2.0 / jnp.maximum(wsum2, 1e-20)
        bw = min(edges[b + 1], fs / 2.0) - edges[b]
        p_noise = noise_slot * 2.0 * bw / fs
        ap2 = p_noise / (p_noise + p_per + 1e-30)
        ap = jnp.sqrt(jnp.clip(ap2, _AP_FLOOR ** 2, 1.0))
        # Bands with no usable slots (f0 too high): fully aperiodic.
        ap = jnp.where((n_noise > 0)
                       & (jnp.sum(harm_m, axis=1) > 0), ap, 1.0)
        aps.append(ap)
    ap = jnp.stack(aps, axis=1)                            # (T, bands)

    if d4c_scale:
        # Statistic conversion to D4C's observable range (see module
        # docstring; rate-safe because the underlying ratio is).
        ap = jnp.exp(jnp.clip(
            _D4C_SCALE_A * jnp.log(ap) + _D4C_SCALE_B,
            np.log(_AP_FLOOR), 0.0))
    # Unvoiced frames: fully aperiodic.
    ap = jnp.where((f0 > 0)[:, None], ap, 1.0)
    return ap


def d4c_band_aperiodicity(raw, f0, fs, frame_shift_ms=5.0, fft_size=None,
                          d4c_scale=True):
    """Band aperiodicity amplitude ratios (T, num_bands) in (0, 1].

    ``d4c_scale=False`` returns the raw physical noise-amplitude
    fraction (exact on synthetic ground truth, no constants)."""
    from idiaptts_tpu.ops.mcep import fs_to_frame_length
    from idiaptts_tpu.ops.world.cheaptrick import _bucket_frames
    if fft_size is None:
        fft_size = fs_to_frame_length(fs)
    hop = int(fs * frame_shift_ms / 1000.0)
    num_bands = max(1, get_num_aperiodicities(fs))
    raw_p, f0_p, T = _bucket_frames(raw, f0, hop)
    out = _d4c_jit(jnp.asarray(raw_p), jnp.asarray(f0_p), int(fs), hop,
                   int(fft_size), num_bands, d4c_scale=bool(d4c_scale))
    return out[:T]


def code_aperiodicity(ap_ratio):
    """(T, num_bands) ratio -> coded bap = ln(ratio) (pyworld coding as
    observed on the fixtures: range [ln(1e-9), 0])."""
    return jnp.log(jnp.clip(ap_ratio, _AP_FLOOR, 1.0))


def decode_aperiodicity(bap, num_bins, fs):
    """Coded bap (T, num_bands) -> full-resolution aperiodicity
    (T, num_bins) by piecewise-linear interpolation over band centres
    (pyworld.decode_aperiodicity role).  Like WORLD, the 0 Hz anchor is
    pinned at the aperiodicity floor — low frequencies of voiced speech
    stay periodic even when the coded bands are noisy — and the Nyquist
    anchor holds the last band's value."""
    bap = jnp.atleast_2d(bap)
    num_bands = bap.shape[-1]
    log_ratio = jnp.clip(bap, np.log(_AP_FLOOR), 0.0)
    anchors_f = jnp.concatenate([
        jnp.zeros(1), 3000.0 * (jnp.arange(num_bands) + 1.0),
        jnp.array([fs / 2.0])])
    anchors_v = jnp.concatenate([
        jnp.full(bap.shape[:-1] + (1,), np.log(_AP_FLOOR)),
        log_ratio, log_ratio[..., -1:]], axis=-1)
    freqs = jnp.linspace(0.0, fs / 2.0, num_bins)
    # Shared anchor grid -> vectorised piecewise-linear interpolation.
    seg = jnp.clip(jnp.searchsorted(anchors_f, freqs, side="right") - 1,
                   0, num_bands)                     # (num_bins,)
    f_lo = anchors_f[seg]
    f_hi = anchors_f[seg + 1]
    w = jnp.where(f_hi > f_lo, (freqs - f_lo) / jnp.maximum(
        f_hi - f_lo, 1e-9), 0.0)
    v_lo = anchors_v[..., seg]
    v_hi = anchors_v[..., seg + 1]
    ap_log = v_lo * (1.0 - w) + v_hi * w
    return jnp.clip(jnp.exp(ap_log), _AP_FLOOR, 1.0)
