"""Batched F0 tracking in JAX.

Fills the role of pyworld's DIO/Harvest + StoneMask
(``WorldFeatLabelGen.world_extract_features``
WorldFeatLabelGen.py:792-793) with a batched formulation:

1. frame the waveform once (static shapes),
2. normalised cross-correlation over all candidate lags via batched FFTs,
3. local-maximum candidate extraction with ``top_k`` (fixed K),
4. Viterbi smoothing over candidates (forward ``lax.scan`` + backtrace
   ``lax.scan``) with an explicit unvoiced state,
5. parabolic lag refinement,
6. two instantaneous-frequency refinement passes over the first
   harmonics (the StoneMask role, all static shapes).

Everything is dense, statically shaped and jit-compiled; the sequential
parts are O(T) scans over 5 ms frames with K-sized inner vector work.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_NUM_CANDS = 8          # candidate peaks per frame
# Measured against the reference's pyworld (Harvest+StoneMask) tracks
# on the LJSpeech fixtures with the four-interval voicing refinement
# (:func:`refine_vuv`) enabled: VUV agreement 0.941, voiced F0 RMSE
# ~12 Hz, GPE(>20%) <1% over all 9 utterances (pinned in
# tests/unit/test_world.py::test_f0_vuv_agreement_all_fixtures).  On
# synthetic audio with known truth (tests/fixtures): median error
# 0.16 Hz, RMSE 0.46 Hz.
_UNVOICED_COST = 0.52   # score below which unvoiced becomes attractive
_TRANSITION_W = 4.0     # octave-jump penalty weight
_LAG_BIAS = 0.0         # subharmonic penalty supersedes lag bias


def _frame_starts(num_samples, hop, window):
    num_frames = max(1, 1 + (num_samples - 1) // hop)
    return num_frames


def _frame_signal(raw, hop, num_frames, seg_len, front_pad):
    """Gather-free framing: frame starts lie on the hop grid, so the
    (T, seg_len) windows are shifted slices of the hop-reshaped signal
    (no dynamic gather).  Frame ``t`` covers
    original samples ``[t*hop - front_pad, t*hop - front_pad + seg_len)``
    (zero-padded outside the signal)."""
    rows_per_frame = -(-seg_len // hop)
    padded = jnp.pad(raw, (front_pad,
                           (rows_per_frame + num_frames) * hop))
    rows = padded[:(num_frames + rows_per_frame) * hop].reshape(-1, hop)
    return jnp.concatenate(
        [rows[i:i + num_frames] for i in range(rows_per_frame)],
        axis=1)[:, :seg_len]                            # (T, seg_len)


@partial(jax.jit, static_argnames=("fs", "hop", "f0_floor", "f0_ceil",
                                   "window"))
def _nccf(raw, fs, hop, f0_floor, f0_ceil, window):
    """Normalised cross-correlation (frames, max_lag+1)."""
    max_lag = int(fs / f0_floor) + 1
    num_frames = _frame_starts(raw.shape[0], hop, window)
    seg_len = window + max_lag
    segs = _frame_signal(raw, hop, num_frames, seg_len, window // 2)
    segs = segs - jnp.mean(segs[:, :window], axis=1, keepdims=True)

    n_fft = int(2 ** np.ceil(np.log2(seg_len + window)))
    base = segs[:, :window]
    spec_base = jnp.fft.rfft(base, n=n_fft, axis=-1)
    spec_full = jnp.fft.rfft(segs, n=n_fft, axis=-1)
    corr = jnp.fft.irfft(jnp.conj(spec_base) * spec_full, n=n_fft,
                         axis=-1)[:, :max_lag + 1]      # (T, L+1)

    # Energy terms: e0 = sum base^2; e[l] = sum segs[l:l+window]^2.
    csum = jnp.cumsum(segs ** 2, axis=-1)
    csum = jnp.concatenate([jnp.zeros_like(csum[:, :1]), csum], axis=-1)
    lags = jnp.arange(max_lag + 1)
    e_lag = csum[:, lags + window] - csum[:, lags]      # (T, L+1)
    e0 = e_lag[:, :1]
    denom = jnp.sqrt(jnp.maximum(e0 * e_lag, 1e-12))
    nccf = corr / denom
    energy = e0[:, 0] / window
    return nccf, energy


@partial(jax.jit, static_argnames=("fs", "f0_floor", "f0_ceil"))
def _candidates(nccf, fs, f0_floor, f0_ceil):
    """Local-max candidate lags + parabolic refinement -> (T, K) f0 and
    scores."""
    T, L1 = nccf.shape
    lags = jnp.arange(L1)
    lag_min = int(fs / f0_ceil)
    lag_max = L1 - 2
    valid = (lags >= lag_min) & (lags <= lag_max)

    left = jnp.concatenate([nccf[:, :1], nccf[:, :-1]], axis=1)
    right = jnp.concatenate([nccf[:, 1:], nccf[:, -1:]], axis=1)
    is_peak = (nccf >= left) & (nccf >= right) & valid[None, :]
    scores = jnp.where(is_peak, nccf, -1.0)
    top_scores, top_lags = jax.lax.top_k(scores, _NUM_CANDS)

    # Parabolic interpolation around each peak.
    l = top_lags
    ym1 = jnp.take_along_axis(nccf, jnp.maximum(l - 1, 0), axis=1)
    y0 = jnp.take_along_axis(nccf, l, axis=1)
    yp1 = jnp.take_along_axis(nccf, jnp.minimum(l + 1, L1 - 1), axis=1)
    denom = ym1 - 2.0 * y0 + yp1
    delta = jnp.where(jnp.abs(denom) > 1e-9,
                      0.5 * (ym1 - yp1) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    refined = l.astype(jnp.float32) + delta
    f0 = fs / jnp.maximum(refined, 1.0)
    f0 = jnp.clip(f0, f0_floor, f0_ceil)

    # Subharmonic (period-doubling) suppression: a candidate whose HALF
    # lag also correlates strongly is likely an octave-low duplicate of
    # the true period — penalise it by how strong the half-lag peak is.
    half = jnp.maximum(l // 2, 1)
    nccf_half = jnp.take_along_axis(nccf, half, axis=1)
    penalty = 0.35 * jnp.clip(nccf_half - 0.4, 0.0, 1.0)
    penalty = jnp.where(half >= lag_min, penalty, 0.0)
    return f0, top_scores - penalty


@jax.jit
def _viterbi(f0_cand, scores, uv_cost, trans_w):
    """Continuity smoothing over K candidates + an unvoiced state.

    State k in [0, K): voiced with f0_cand[t, k]; state K: unvoiced.
    ``uv_cost``/``trans_w`` are traced scalars so tuning does not
    recompile.  Returns best path state per frame (T,) int32.
    """
    T, K = f0_cand.shape
    log_f0 = jnp.log(f0_cand)
    obs_cost_v = -scores                       # voiced observation cost
    obs_cost_u = -uv_cost * jnp.ones((T, 1))
    obs = jnp.concatenate([obs_cost_v, obs_cost_u], axis=1)  # (T, K+1)

    def transition(prev_cost, prev_logf0, cur_logf0):
        # (K+1,) prev costs -> (K+1, K+1) transitions -> min over prev.
        jump = jnp.abs(cur_logf0[None, :K] - prev_logf0[:K, None])
        trans_vv = trans_w * jump                          # (K, K)
        # voiced <-> unvoiced switching penalty
        sw = 0.25
        row_u = jnp.full((1, K), sw)
        trans = jnp.concatenate([trans_vv, row_u], axis=0)  # (K+1, K)
        col_u = jnp.full((K + 1, 1), sw).at[K, 0].set(0.0)
        trans = jnp.concatenate([trans, col_u], axis=1)     # (K+1, K+1)
        total = prev_cost[:, None] + trans
        return jnp.min(total, axis=0), jnp.argmin(total, axis=0)

    def fwd(carry, inputs):
        prev_cost, prev_logf0 = carry
        obs_t, logf0_t = inputs
        moved, argmin = transition(prev_cost, prev_logf0, logf0_t)
        cost = moved + obs_t
        return (cost, logf0_t), argmin

    init = (obs[0], log_f0[0])
    (final_cost, _), argmins = jax.lax.scan(
        fwd, init, (obs[1:], log_f0[1:]))

    last_state = jnp.argmin(final_cost)

    def back(state, argmin_t):
        prev = argmin_t[state]
        return prev, state

    # path_rev holds states T-1 .. 1; the final carry is state 0.
    first_state, path_rev = jax.lax.scan(back, last_state, argmins[::-1])
    path = jnp.concatenate([first_state[None], path_rev[::-1]])
    return path


def _if_spectra(raw, fs, hop, num_frames, window):
    """Per-frame instantaneous-frequency map + magnitudes for
    :func:`_refine_if`.  The IF of bin ``b`` is the phase advance
    between the same windowed segment shifted by one sample — exact
    for an isolated sinusoid anywhere inside its analysis mainlobe.
    F0-independent, so refinement iterations can share one copy."""
    n_fft = int(2 ** np.ceil(np.log2(2 * window)))
    segs = _frame_signal(raw, hop, num_frames, window + 1, window // 2)
    win = 0.5 - 0.5 * jnp.cos(
        2.0 * jnp.pi * jnp.arange(window) / (window - 1))
    spec_a = jnp.fft.rfft(segs[:, :window] * win, n=n_fft, axis=-1)
    spec_b = jnp.fft.rfft(segs[:, 1:window + 1] * win, n=n_fft, axis=-1)
    cross = spec_b * jnp.conj(spec_a)
    inst_freq = jnp.angle(cross) * fs / (2.0 * jnp.pi)    # (T, F)
    mag2 = jnp.abs(spec_a) ** 2
    return inst_freq, mag2, n_fft


def _refine_if(inst_freq, mag2, n_fft, fs, window, f0, voiced,
               num_harmonics=3):
    """StoneMask-role refinement: instantaneous-frequency estimates at
    the first harmonics sharpen each voiced frame's F0 (pyworld runs
    ``stonemask`` after ``dio``; WorldFeatLabelGen.py:793).

    The coarse lag-domain F0 only needs to land within half a mainlobe
    (~2*fs/W Hz) of the truth for the harmonic bins to be picked
    correctly.  Harmonic IFs divided by their index are averaged with
    magnitude-squared weights; a consistency gate drops harmonics that
    disagree with the current estimate by >18% (collided or noisy
    bins).  All shapes static.
    """
    num_bins = inst_freq.shape[1]

    est_num = jnp.zeros_like(f0)
    est_den = jnp.zeros_like(f0)
    for k in range(1, num_harmonics + 1):
        bin_f = k * f0 * n_fft / fs
        b0 = jnp.clip(jnp.round(bin_f).astype(jnp.int32), 1,
                      num_bins - 2)
        in_range = (k * f0) < (0.5 * fs - fs / window)
        for off in (-1, 0, 1):
            idx = jnp.clip(b0 + off, 0, num_bins - 1)[:, None]
            est = jnp.take_along_axis(inst_freq, idx, axis=1)[:, 0] / k
            w = jnp.take_along_axis(mag2, idx, axis=1)[:, 0]
            ok = in_range & (jnp.abs(est - f0) < 0.18 * f0)
            w = jnp.where(ok, w, 0.0)
            est_num = est_num + w * est
            est_den = est_den + w
    refined = est_num / jnp.maximum(est_den, 1e-12)
    use = voiced & (est_den > 1e-8)
    return jnp.where(use, refined, f0)


@partial(jax.jit, static_argnames=("fs", "hop", "f0_floor", "f0_ceil",
                                   "window"))
def _extract_f0_jit(raw, fs, hop, f0_floor, f0_ceil, window, uv_cost,
                    trans_w, lag_bias, score_th):
    nccf, energy = _nccf(raw, fs, hop, f0_floor, f0_ceil, window)
    f0_cand, scores = _candidates(nccf, fs, f0_floor, f0_ceil)
    # Octave-error suppression: mildly prefer higher-f0 candidates.
    biased = scores - lag_bias * jnp.log2(f0_ceil / f0_cand)
    path = _viterbi(f0_cand, biased, uv_cost, trans_w)
    K = f0_cand.shape[1]
    voiced = path < K
    picked = jnp.take_along_axis(
        f0_cand, jnp.minimum(path, K - 1)[:, None], axis=1)[:, 0]
    picked_score = jnp.take_along_axis(
        scores, jnp.minimum(path, K - 1)[:, None], axis=1)[:, 0]
    # Energy gate: very quiet frames are unvoiced.
    energy_db = 10.0 * jnp.log10(energy + 1e-12)
    gate = energy_db > (jnp.max(energy_db) - 40.0)
    voiced = voiced & gate & (picked_score > score_th)
    # Two IF-refinement passes (StoneMask runs refinement twice): the
    # first pulls the lag-grid estimate onto the spectral truth, the
    # second re-centres the harmonic bins with the better estimate.
    num_frames = _frame_starts(raw.shape[0], hop, window)
    w_ref = int(fs * 0.035)
    inst_freq, mag2, n_fft = _if_spectra(raw, fs, hop, num_frames,
                                         w_ref)
    picked = jnp.clip(picked, f0_floor, f0_ceil)
    for _ in range(2):
        picked = _refine_if(inst_freq, mag2, n_fft, fs, w_ref, picked,
                            voiced)
        picked = jnp.clip(picked, f0_floor, f0_ceil)
    return jnp.where(voiced, picked, 0.0)


_LENGTH_BUCKET = 16384  # pad waveforms to multiples -> few compilations


def _four_interval_tracks(raw, fs, num_frames, hop, f0_floor, f0_ceil,
                          per_octave=6):
    """Harvest/DIO-style voicing evidence (host-side).

    The reference's vuv track is pyworld Harvest's voicing decision
    (``pyworld.wav2world``, WorldFeatLabelGen.py:792-801): Harvest
    low-pass filters the signal at log-spaced boundary frequencies and
    trusts a frame only when four independent period estimators of the
    filtered signal (negative/positive zero crossings, peaks, dips)
    agree — when the cutoff isolates exactly the fundamental, the
    filtered signal is a near-sinusoid and all four intervals coincide;
    leaked harmonics or noise make them disagree.  Correlation
    magnitude (the NCCF path) cannot reproduce those decisions:
    fricative/formant periodicity scores high NCCF but fails interval
    consistency, while low-energy voicing fails NCCF but passes it.

    Event detection is inherently data-dependent (variable event
    counts), so this runs in numpy on the host — it is offline
    feature-extraction work, the same role pyworld's C code plays on
    CPU for the reference; the per-frame F0 values still come from the
    jit NCCF+Viterbi+IF pipeline.

    Returns ``(best_f0, best_dev)`` per frame: the candidate channel
    mean F0 and its relative four-estimator deviation (lower = more
    certainly voiced; 9.0 = no valid candidate).
    """
    raw = np.asarray(raw, dtype=np.float64)
    n = len(raw)
    tgrid = np.arange(num_frames) * hop / fs
    n_fft = int(2 ** np.ceil(np.log2(max(n, 2) + 1)))
    spec = np.fft.rfft(raw, n_fft)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / fs)
    n_oct = np.log2(f0_ceil / f0_floor)
    centers = f0_floor * 2.0 ** (
        (np.arange(int(n_oct * per_octave)) + 1) / per_octave)
    best_f0 = np.zeros(num_frames)
    best_dev = np.full(num_frames, 9.0)
    for c in centers:
        # Raised-cosine low-pass to zero at 1.2*c + rumble high-pass.
        lp = np.where(freqs < 1.2 * c,
                      0.5 * (1.0 + np.cos(np.pi * freqs / (1.2 * c))),
                      0.0)
        lp *= freqs > 35.0
        y = np.fft.irfft(spec * lp, n_fft)[:n]
        dy = np.diff(y)
        ests = []
        for sig in (y, -y, dy, -dy):
            s0, s1 = sig[:-1], sig[1:]
            idx = np.where((s0 < 0) & (s1 >= 0))[0]
            if len(idx) < 3:
                ests = []
                break
            frac = -s0[idx] / (s1[idx] - s0[idx] + 1e-20)
            times = (idx + frac) / fs
            intervals = np.diff(times)
            mids = 0.5 * (times[:-1] + times[1:])
            ests.append(np.interp(tgrid, mids,
                                  1.0 / np.maximum(intervals, 1e-6),
                                  left=0.0, right=0.0))
        if len(ests) < 4:
            continue
        est = np.stack(ests)
        mu = est.mean(axis=0)
        dev = est.std(axis=0) / np.maximum(mu, 1e-6)
        # The channel is only trustworthy where its cutoff isolates the
        # fundamental: mu must sit in roughly [c/2.2, 1.2c].
        ok = ((mu > max(f0_floor, c / 2.2))
              & (mu < min(f0_ceil, 1.2 * c)))
        dev = np.where(ok, dev, 9.0)
        better = dev < best_dev
        best_f0 = np.where(better, mu, best_f0)
        best_dev = np.where(better, dev, best_dev)
    return best_f0, best_dev


def _voiced_runs(voiced):
    edges = np.diff(np.concatenate([[0], voiced.astype(np.int8), [0]]))
    return list(zip(np.where(edges == 1)[0], np.where(edges == -1)[0]))


def refine_vuv(raw, fs, f0, frame_shift_ms=5.0, f0_floor=71.0,
               f0_ceil=800.0, dev_th=0.007, min_run=6, ext_dev_th=0.02,
               merge_gap=3, max_ext=15):
    """Replace the NCCF voicing decision with the four-interval one.

    Decision (Harvest's fix-step structure, re-derived): a frame is
    voiced when its best channel deviation < ``dev_th``; voiced runs
    shorter than ``min_run`` frames are dropped; runs extend outward
    through frames with consistent F0 and deviation < ``ext_dev_th``
    (hysteresis); gaps <= ``merge_gap`` frames between F0-consistent
    runs are bridged.  F0 values keep the (IF-refined) NCCF estimate
    wherever both paths agree within half an octave; frames only the
    interval evidence calls voiced get the channel-mean F0.

    Raises fixture VUV agreement vs the reference's Harvest tracks
    from 0.866 (NCCF decision alone) to 0.941.
    """
    f0 = np.asarray(f0).copy()
    hop = int(fs * frame_shift_ms / 1000.0)
    num_frames = len(f0)
    bf, bd = _four_interval_tracks(raw, fs, num_frames, hop, f0_floor,
                                   f0_ceil)
    voiced = bd < dev_th
    for s, e in _voiced_runs(voiced):
        if e - s < min_run:
            voiced[s:e] = False
    for s, e in _voiced_runs(voiced):
        last, i, cnt = bf[s], s - 1, 0
        while (i >= 0 and cnt < max_ext and not voiced[i]
               and bd[i] < ext_dev_th
               and abs(bf[i] - last) < 0.2 * last):
            voiced[i] = True
            last, i, cnt = bf[i], i - 1, cnt + 1
        last, i, cnt = bf[e - 1], e, 0
        while (i < num_frames and cnt < max_ext and not voiced[i]
               and bd[i] < ext_dev_th
               and abs(bf[i] - last) < 0.2 * last):
            voiced[i] = True
            last, i, cnt = bf[i], i + 1, cnt + 1
    runs = _voiced_runs(voiced)
    for (s1, e1), (s2, e2) in zip(runs[:-1], runs[1:]):
        if (s2 - e1 <= merge_gap
                and abs(bf[s2] - bf[e1 - 1]) < 0.25 * max(bf[e1 - 1], 1)):
            voiced[e1:s2] = True
    # Values: keep the NCCF/IF estimate where consistent, else the
    # interval estimate (also for frames the NCCF path called unvoiced).
    nccf_ok = (f0 > 0) & (np.abs(np.log2(np.maximum(f0, 1e-3)
                                         / np.maximum(bf, 1e-3))) < 0.5)
    out = np.where(voiced, np.where(nccf_ok, f0, bf), 0.0)
    return out.astype(np.float32)


def extract_f0(raw, fs, frame_shift_ms=5.0, f0_floor=71.0, f0_ceil=800.0,
               uv_cost=_UNVOICED_COST, trans_w=_TRANSITION_W,
               lag_bias=_LAG_BIAS, score_th=0.47, vuv_refine=True):
    """F0 track at the given frame shift; 0 marks unvoiced frames.

    Matches pyworld's frame count convention (frame count
    ``1 + (N-1)//hop`` equals pyworld's on the 5 ms fixtures; callers
    trim to shortest like the reference, WorldFeatLabelGen.py:887-907).
    Waveforms are padded to length buckets so XLA compiles one program
    per bucket instead of one per utterance.
    """
    hop = int(fs * frame_shift_ms / 1000.0)
    window = int(2 ** np.ceil(np.log2(fs * 0.03)))  # ~30 ms correlation
    raw = np.asarray(raw, dtype=np.float32)
    num_frames = max(1, 1 + (len(raw) - 1) // hop)
    padded_len = int(np.ceil(max(len(raw), 1) / _LENGTH_BUCKET)
                     * _LENGTH_BUCKET)
    padded = np.zeros(padded_len, dtype=np.float32)
    padded[:len(raw)] = raw
    f0 = _extract_f0_jit(jnp.asarray(padded), int(fs), hop,
                         float(f0_floor), float(f0_ceil), window,
                         jnp.float32(uv_cost), jnp.float32(trans_w),
                         jnp.float32(lag_bias), jnp.float32(score_th))
    f0 = np.asarray(f0)[:num_frames]
    if vuv_refine:
        f0 = refine_vuv(raw, fs, f0, frame_shift_ms, f0_floor, f0_ceil)
    return f0
