"""Property/edge-case tests for the WORLD kernels: silence, pure tone,
white noise, very short input — the classic DSP invariants that guard
the gather-free reformulations."""

import numpy as np
import pytest

FS = 16000


@pytest.fixture(scope="module")
def tone():
    """Harmonic-rich 220 Hz tone (energy in every ap band, unlike a
    pure sine whose 3-4.5 kHz band would be empty)."""
    t = np.arange(FS) / FS
    sig = sum((0.3 / h) * np.sin(2 * np.pi * 220.0 * h * t)
              for h in range(1, 30))
    return (sig / np.abs(sig).max() * 0.5).astype(np.float32)


def test_extraction_on_silence():
    from idiaptts_tpu.ops.world.extract import world_analysis
    raw = np.zeros(FS, np.float32)
    f0, coded, bap = world_analysis(raw, FS, num_coded_sps=20)
    assert np.isfinite(coded).all() and np.isfinite(bap).all()
    assert (f0 == 0).all()                      # no voicing in silence


def test_extraction_on_pure_tone(tone):
    from idiaptts_tpu.ops.world.extract import world_analysis
    f0, coded, bap = world_analysis(tone, FS, num_coded_sps=20)
    voiced = f0 > 0
    assert voiced.mean() > 0.8                  # tone is voiced
    err = np.abs(f0[voiced] - 220.0)
    assert np.median(err) < 3.0                 # tracks the tone
    # Perfectly periodic -> strongly periodic band 1 (bap floor-ish).
    assert np.median(bap[voiced, 0]) < -5.0
    assert np.isfinite(coded).all()


def test_extraction_on_white_noise():
    from idiaptts_tpu.ops.world.extract import world_analysis
    rng = np.random.RandomState(0)
    raw = (0.1 * rng.randn(FS)).astype(np.float32)
    f0, coded, bap = world_analysis(raw, FS, num_coded_sps=20)
    # Aperiodic signal: mostly unvoiced; any voiced frames keep high ap.
    assert (f0 > 0).mean() < 0.5
    assert np.isfinite(coded).all() and np.isfinite(bap).all()


def test_extraction_very_short():
    from idiaptts_tpu.ops.world.extract import world_analysis
    raw = (0.1 * np.random.RandomState(1).randn(400)).astype(np.float32)
    f0, coded, bap = world_analysis(raw, FS, num_coded_sps=20)
    assert len(f0) == max(1, 1 + (400 - 1) // 80)
    assert np.isfinite(coded).all()


def test_synthesis_on_silence_features():
    from idiaptts_tpu.ops.world.synthesis import world_synthesis
    T = 100
    f0 = np.zeros(T, np.float32)
    sp = np.full((T, 513), 1e-12, np.float32)
    ap = np.ones((T, 513), np.float32)
    wav = np.asarray(world_synthesis(f0, sp, ap, FS))
    assert wav.shape == (T * 80,)
    assert np.isfinite(wav).all()
    assert np.abs(wav).max() < 1e-3             # silence in, silence out


def test_synthesis_pure_harmonic_tone():
    """A single-harmonic envelope at constant f0 synthesises a stable
    tone at that frequency (checks the cepstral envelope sampling and
    the minimax oscillator)."""
    from idiaptts_tpu.ops.world.synthesis import world_synthesis
    T, K = 200, 513
    f0 = np.full(T, 200.0, np.float32)
    freqs = np.arange(K) * FS / 1024.0
    # Smooth envelope peaked at 200 Hz.
    sp = np.exp(-((freqs - 200.0) / 300.0) ** 2)[None, :].repeat(
        T, 0).astype(np.float32)
    ap = np.full((T, K), 1e-4, np.float32)      # fully periodic
    wav = np.asarray(world_synthesis(f0, sp, ap, FS))
    assert np.isfinite(wav).all()
    # Dominant frequency == f0 (within one bin of a long FFT).
    spec = np.abs(np.fft.rfft(wav[2000:10000] * np.hanning(8000)))
    peak_hz = np.argmax(spec) * FS / 8000.0
    assert abs(peak_hz - 200.0) < 6.0, peak_hz
    # Steady amplitude: no frame-rate modulation.
    frames = wav[2000:10000].reshape(-1, 80)
    rms = np.sqrt((frames ** 2).mean(axis=1))
    assert rms.std() / rms.mean() < 0.1


def test_sample_log_field_matches_direct_interpolation():
    """The cepstral field sampler agrees with direct linear
    interpolation on a smooth envelope."""
    import jax.numpy as jnp
    from idiaptts_tpu.ops.world.synthesis import _sample_log_field
    rng = np.random.RandomState(0)
    K, M = 513, 48
    n_fft = 2 * (K - 1)
    # Field built EXACTLY as an M-term cepstral expansion (within the
    # sampler's 64-term budget): evaluation must be near-exact at
    # arbitrary fractional frequencies.
    ceps = rng.randn(4, M) * np.exp(-0.1 * np.arange(M))
    k = np.arange(K)
    log_field = (ceps[:, :1]
                 + 2.0 * np.einsum(
                     "tm,mk->tk", ceps[:, 1:],
                     np.cos(2 * np.pi * np.arange(1, M)[:, None]
                            * k[None, :] / n_fft)))
    x = np.sort(rng.uniform(0.0, 0.5, (4, 50))).astype(np.float32)
    out = np.asarray(_sample_log_field(jnp.asarray(log_field,
                                                   jnp.float32),
                                       jnp.asarray(x)))
    theta = 2 * np.pi * x                        # cycles -> rad/sample
    for i in range(4):
        exact = (ceps[i, 0] + 2.0 * np.sum(
            ceps[i, 1:, None]
            * np.cos(np.arange(1, M)[:, None] * theta[i][None, :]),
            axis=0))
        np.testing.assert_allclose(out[i], exact, atol=2e-3)


def test_fast_sin_accuracy():
    from idiaptts_tpu.ops.world.synthesis import _sin_cycles
    x = np.linspace(0.0, 1.0, 100001)[:-1].astype(np.float64)
    err = np.abs(np.asarray(_sin_cycles(x)) - np.sin(2 * np.pi * x))
    assert err.max() < 1e-5


def test_synthesis_finite_for_divergent_model_outputs():
    """Garbage in -> loud garbage out, never NaN: an untrained model's
    denormalised predictions (large mcep coefficients, huge lf0) must
    not overflow exp()/phase accumulation into inf*mask=NaN waveforms
    (regression: the builtin-front-end TTS test wrote all-NaN wavs
    through the fused path before the log-envelope/f0 clamps)."""
    import jax
    import jax.numpy as jnp
    from idiaptts_tpu.ops import mcep as mcep_ops
    from idiaptts_tpu.synth.pipeline import BatchedWorldSynth, _vocode_one

    T, D, NB = 64, 20, 1
    rng = np.random.RandomState(0)
    alpha = mcep_ops.fs_to_mgc_alpha(16000)
    for scale in (1.0, 8.0, 30.0):
        coded = jnp.asarray(rng.randn(T, D).astype(np.float32) * scale)
        out = _vocode_one(coded, jnp.full((T,), 60.0),
                          jnp.ones((T,), bool), jnp.full((T, NB), -0.5),
                          jnp.full((T,), 150.0), jax.random.PRNGKey(0),
                          16000, 80, 513, alpha, 112)
        assert np.all(np.isfinite(np.asarray(out))), scale

    # Same through the serving surface (vmap + padding path).
    feats = rng.randn(T, D + 2 + NB).astype(np.float32) * 10.0
    feats[:, D] = 200.0   # lf0 -> exp overflows f32 without the cap
    feats[:, D + 1] = 1.0
    synth = BatchedWorldSynth(D, fs=16000, frame_shift_ms=5.0,
                              num_bap=NB)
    wav = np.asarray(synth([feats])[0])
    assert np.all(np.isfinite(wav))


def test_float_to_pcm16_nan_safe():
    """NaN/inf must map to silence/clipping, not undefined int casts
    that read back as finite garbage."""
    from idiaptts_tpu.ops.audio_io import float_to_pcm16
    pcm = float_to_pcm16(np.array([np.nan, np.inf, -np.inf, 0.5, -2.0]))
    assert pcm.dtype == np.int16
    assert pcm[0] == 0 and pcm[1] == 32767 and pcm[2] == -32767


def test_large_hop_noise_grid():
    """48 kHz at 10 ms frame shift (hop 480 > the default 256-point
    coarse noise grid): the fused vocoder body raises the grid so the
    noise overlap-add window fits (regression: broadcast crash)."""
    import jax
    import numpy as np
    from idiaptts_tpu.synth.pipeline import BatchedWorldSynth

    fs, T, D = 48000, 24, 20
    synth = BatchedWorldSynth(D, fs=fs, frame_shift_ms=10.0,
                              num_bap=5, bucket=8)
    rng = np.random.RandomState(0)
    feats = np.zeros((T, D + 2 + 5), np.float32)
    feats[:, 0] = -2.0                      # quiet envelope
    feats[:, D] = np.log(150.0)             # lf0
    feats[:, D + 1] = 1.0                   # voiced
    feats[:, D + 2:] = -1.0                 # bap
    wavs = synth([feats])
    hop = int(fs * 0.010)
    assert wavs[0].shape == (T * hop,)
    assert np.isfinite(wavs[0]).all()
