import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal

from idiaptts_tpu.ops import mcep as mcep_ops
from idiaptts_tpu.ops import stft as stft_ops


def _tone(fs=16000, dur=0.3, freq=220.0):
    t = np.arange(int(fs * dur)) / fs
    return (0.6 * np.sin(2 * np.pi * freq * t)
            + 0.2 * np.sin(2 * np.pi * 3 * freq * t)).astype(np.float32)


def _fetch_complex(x):
    """Device->host for complex arrays via a real/imag split.

    Some device platforms cannot transfer complex64 to the host
    (UNIMPLEMENTED) — and a failed attempt poisons every subsequent
    transfer in the process, which is why one naive ``np.asarray`` of
    an STFT used to cascade into dozens of unrelated failures in a
    hardware suite run."""
    return (np.asarray(jnp.real(x))
            + 1j * np.asarray(jnp.imag(x))).astype(np.complex64)


def test_stft_matches_scipy():
    raw = _tone()
    n_fft, hop = 512, 128
    got = _fetch_complex(stft_ops.stft(jnp.asarray(raw), n_fft, hop))
    _, _, ref = scipy.signal.stft(raw, nperseg=n_fft, noverlap=n_fft - hop,
                                  window="hann", boundary=None, padded=False)
    # scipy normalises by window sum; compare magnitudes up to scale on
    # interior frames.
    interior = slice(4, min(got.shape[0], ref.shape[1]) - 4)
    g = np.abs(got[interior]).T
    r = np.abs(ref[:, interior])
    scale = np.sum(g * r) / np.sum(r * r)
    np.testing.assert_allclose(g, scale * r, atol=1e-2 * g.max())


def test_istft_roundtrip():
    raw = _tone()
    n_fft, hop = 512, 128
    spec = stft_ops.stft(jnp.asarray(raw), n_fft, hop)
    back = np.asarray(stft_ops.istft(spec, n_fft, hop, length=len(raw)))
    np.testing.assert_allclose(back[hop:-hop], raw[hop:-hop], atol=1e-3)


def test_mel_filterbank_properties():
    fb = stft_ops.mel_filterbank(16000, 512, n_mels=40)
    assert fb.shape == (40, 257)
    assert np.all(fb >= 0)
    # every filter has some support
    assert np.all(fb.sum(axis=1) > 0)


def test_griffin_lim_reconstruction():
    raw = _tone(dur=0.25)
    n_fft, hop = 512, 128
    amp = jnp.abs(stft_ops.stft(jnp.asarray(raw), n_fft, hop))
    rec = np.asarray(stft_ops.griffin_lim(amp, n_fft, hop, num_iters=60,
                                          length=len(raw)))
    # Compare magnitude spectra of reconstruction (phase-free metric).
    amp_rec = np.asarray(jnp.abs(stft_ops.stft(jnp.asarray(rec),
                                               n_fft, hop)))
    err = np.linalg.norm(amp_rec - np.asarray(amp)) / np.linalg.norm(amp)
    assert err < 0.2


def test_mcep_alpha_table():
    assert mcep_ops.fs_to_mgc_alpha(16000) == pytest.approx(0.41, abs=0.02)
    assert mcep_ops.fs_to_mgc_alpha(22050) == pytest.approx(0.455, abs=0.02)
    assert mcep_ops.fs_to_mgc_alpha(48000) == pytest.approx(0.554, abs=0.03)


def test_fs_to_frame_length():
    assert mcep_ops.fs_to_frame_length(16000) == 1024
    assert mcep_ops.fs_to_frame_length(22050) == 1024
    assert mcep_ops.fs_to_frame_length(44100) == 2048
    assert mcep_ops.fs_to_frame_length(48000) == 2048


def test_mcep_roundtrip_smooth_spectrum():
    """analysis -> synthesis recovers a smooth log spectrum closely."""
    num_bins, order, alpha = 513, 24, 0.41
    omega = np.linspace(0, np.pi, num_bins)
    log_sp = (-2.0 + 1.5 * np.cos(omega * 2) + 0.5 * np.cos(omega * 5)
              - 0.8 * omega / np.pi)
    amp = np.exp(log_sp)[None, :].astype(np.float32)
    c = mcep_ops.amp_sp_to_mcep(jnp.asarray(amp), order, alpha)
    amp_rec = np.asarray(mcep_ops.mcep_to_amp_sp(c, num_bins, alpha))
    log_rec = np.log(amp_rec[0])
    rmse_db = np.sqrt(np.mean((log_rec - log_sp) ** 2)) * 20 / np.log(10)
    assert rmse_db < 1.0  # < 1 dB RMS error for a smooth envelope


def test_merlin_post_filter_preserves_energy():
    num_bins, order, alpha = 513, 24, 0.41
    rng = np.random.RandomState(0)
    mgc = rng.randn(5, order + 1).astype(np.float32) * 0.3
    mgc[:, 0] = -1.0
    post = mcep_ops.merlin_post_filter(jnp.asarray(mgc), alpha,
                                       num_bins=num_bins)
    sp_orig = np.asarray(mcep_ops.mcep_to_amp_sp(jnp.asarray(mgc), num_bins,
                                                 alpha))
    sp_post = np.asarray(mcep_ops.mcep_to_amp_sp(post, num_bins, alpha))
    e_orig = np.sum(sp_orig ** 2, axis=-1)
    e_post = np.sum(sp_post ** 2, axis=-1)
    np.testing.assert_allclose(e_post, e_orig, rtol=1e-3)
    # Higher-order coefficients are boosted.
    np.testing.assert_allclose(np.asarray(post)[:, 2:], mgc[:, 2:] * 1.4,
                               rtol=1e-5)


def test_min_phase_log_spectrum():
    """Min-phase spectrum has the same magnitude as the input."""
    num_bins = 257
    omega = np.linspace(0, np.pi, num_bins)
    log_amp = (-1.0 + np.cos(2 * omega))[None, :].astype(np.float32)
    cplx = _fetch_complex(
        mcep_ops.min_phase_log_spectrum(jnp.asarray(log_amp)))
    np.testing.assert_allclose(cplx.real[0], log_amp[0], atol=1e-3)


def test_mfbanks_to_amp_sp_inversion():
    """NNLS mel inversion (AudioProcessing.mfbanks_to_amp_sp role):
    re-projecting the recovered power through the filterbank reproduces
    the mel features, and a smooth spectrum is recovered to a few dB."""
    fs, n_fft, n_mels = 16000, 1024, 80
    bins = n_fft // 2 + 1
    freqs = np.linspace(0, fs / 2, bins)
    # Smooth formant-like log envelope.
    amp = np.exp(np.stack([
        -1.0 + 0.8 * np.exp(-0.5 * ((freqs - 700) / 300) ** 2)
        + 0.5 * np.exp(-0.5 * ((freqs - 2400) / 500) ** 2)
        - freqs / 8000.0 * s for s in (1.0, 1.5, 2.0)]))
    W = stft_ops.mel_filterbank(fs, n_fft, n_mels=n_mels)
    coded = np.log(np.maximum((amp ** 2) @ W.T, 1e-10))
    rec_amp = np.asarray(stft_ops.mfbanks_to_amp_sp(coded, fs,
                                                    n_fft=n_fft))
    assert rec_amp.shape == amp.shape
    assert np.all(rec_amp >= 0)
    # Mel-domain reconstruction is tight.
    coded_rec = np.log(np.maximum((rec_amp ** 2) @ W.T, 1e-10))
    assert np.max(np.abs(coded_rec[:, 2:-2] - coded[:, 2:-2])) < 0.2
    # Linear-domain recovery: within a few dB over the mel-covered band.
    band = (freqs > 150) & (freqs < 7000)
    err_db = 10 * np.abs(np.log10(np.maximum(rec_amp[:, band], 1e-8) ** 2)
                         - np.log10(amp[:, band] ** 2))
    assert np.median(err_db) < 3.0


def test_decode_sp_dispatch_and_mfbanks_world_synth(tmp_path):
    """WorldFeatLabelGen.decode_sp dispatch (AudioProcessing.decode_sp
    :304-327) + Synthesiser.run_world_synth with sp_type="mfbanks"."""
    from idiaptts_tpu.data.world_feat import WorldFeatLabelGen
    from idiaptts_tpu.hparams import ExtendedHParams
    from idiaptts_tpu.synth.synthesiser import Synthesiser

    fs, n_mels, T = 16000, 20, 40
    bins = mcep_ops.fs_to_frame_length(fs) // 2 + 1
    rng = np.random.RandomState(0)
    amp = np.exp(rng.randn(T, bins) * 0.05 - 1.0).astype(np.float32)
    W = stft_ops.mel_filterbank(fs, (bins - 1) * 2, n_mels=n_mels)
    coded = np.log(np.maximum((amp ** 2) @ W.T, 1e-10))

    # Dispatch: every branch returns the right shape.
    out = WorldFeatLabelGen.decode_sp(coded, "mfbanks", fs=fs)
    assert out.shape == (T, bins)
    assert WorldFeatLabelGen.decode_sp(amp, "amp_sp", fs=fs).shape \
        == (T, bins)
    mc = np.zeros((T, 20), np.float32)
    assert WorldFeatLabelGen.decode_sp(mc, "mcep", fs=fs).shape \
        == (T, bins)
    with pytest.raises(NotImplementedError):
        WorldFeatLabelGen.decode_sp(mc, "nope", fs=fs)

    # Full synth path from mel features.
    lf0 = np.full((T, 1), np.log(140.0), np.float32)
    vuv = np.ones((T, 1), np.float32)
    bap = np.full((T, 1), -2.0, np.float32)
    feats = np.concatenate([coded, lf0, vuv, bap], axis=1)
    hparams = ExtendedHParams.create_hparams()
    hparams.setattr_no_type_check("synth_dir", str(tmp_path))
    hparams.setattr_no_type_check("synth_fs", fs)
    hparams.setattr_no_type_check("num_coded_sps", n_mels)
    hparams.setattr_no_type_check("sp_type", "mfbanks")
    paths = Synthesiser.run_world_synth({"utt": feats}, hparams)
    import os
    assert os.path.isfile(paths["utt"])
    raw, fs_read = __import__(
        "idiaptts_tpu.ops.audio_io", fromlist=["get_raw"]).get_raw(
        paths["utt"])
    assert fs_read == fs and len(raw) > 0 and np.isfinite(raw).all()


def test_audio_processing_facade():
    """Reference-named AudioProcessing facade (AudioProcessing.py
    :33-339): every reference static method exists and delegates to the
    JAX ops with consistent shapes/conventions."""
    from idiaptts_tpu.data.audio_processing import AudioProcessing as AP

    fs = 16000
    assert AP.fs_to_mgc_alpha(fs) == pytest.approx(0.41, abs=0.02)
    assert AP.fs_to_frame_length(fs) == 1024
    assert AP.fs_to_num_bap(fs) >= 1

    rng = np.random.RandomState(0)
    t = np.arange(fs) / fs
    raw = (0.3 * np.sin(2 * np.pi * 220 * t)
           + 0.05 * rng.randn(fs)).astype(np.float32)

    frames = AP.framing(raw, 400, 80)
    assert frames.shape[1] == 400

    pre = AP.preemphasis(raw, 0.97)
    rec = AP.depreemphasis(pre, 0.97)
    np.testing.assert_allclose(rec, raw, atol=1e-4)

    amp = AP.librosa_extract_amp_sp(raw, fs)
    assert amp.shape[1] == 513

    mc = AP.extract_mcep(amp, 20, AP.fs_to_mgc_alpha(fs))
    assert mc.shape == (amp.shape[0], 20)
    amp_rec = AP.mcep_to_amp_sp(mc, fs)
    assert amp_rec.shape == amp.shape
    assert AP.mgc_to_amp_sp(mc, fs).shape == amp.shape

    mf = AP.extract_mfbanks(raw=raw, fs=fs, n_fft=1024,
                            num_coded_sps=24)
    assert mf.shape == (amp.shape[0], 24)
    assert np.all(mf >= 0)  # linear amplitude mel, reference convention
    amp_from_mel = AP.mfbanks_to_amp_sp(mf, fs)
    assert amp_from_mel.shape == amp.shape
    # Reprojection through the filterbank recovers the mel features.
    from idiaptts_tpu.ops import stft as stft_ops
    W = stft_ops.mel_filterbank(fs, 1024, n_mels=24)
    np.testing.assert_allclose(amp_from_mel @ W.T, mf, rtol=0.2,
                               atol=1e-3)

    assert AP.decode_sp(mc, "mcep", fs=fs).shape == amp.shape
    db = AP.amp_to_db(np.asarray([1.0, 0.1]))
    # rtol covers an accelerator's slightly looser exp/log precision.
    np.testing.assert_allclose(AP.db_to_amp(db), [1.0, 0.1], rtol=1e-4)

    wav = AP.amp_sp_to_raw(amp[:100], fs, num_iters=5)
    assert np.isfinite(wav).all() and len(wav) > 0
