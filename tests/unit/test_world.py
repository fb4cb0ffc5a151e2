"""WORLD-equivalent vocoder tests: parity with the reference's pyworld
tracks on the committed fixtures (to tolerance) and analysis->synthesis
round-trip fidelity (the test strategy of
test_WorldFeatLabelGen.py:303-396, adapted to tolerance-based checks as
the kernels are reformulations, not ports)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from idiaptts_tpu.ops import mcep as mcep_ops
from idiaptts_tpu.ops.audio_io import get_raw
from idiaptts_tpu.ops.world import (cheaptrick, d4c_band_aperiodicity,
                                    extract_f0, world_synthesis)
from idiaptts_tpu.ops.world.d4c import (code_aperiodicity,
                                        decode_aperiodicity,
                                        get_num_aperiodicities)

REF_UTT = "LJ001-0001"


@pytest.fixture(scope="module")
def analysis(fixtures_dir, uid):
    raw, fs = get_raw(os.path.join(fixtures_dir, "database", "wav",
                                   uid + ".wav"))
    raw = raw[:fs * 4]
    f0 = extract_f0(raw, fs)
    sp = np.asarray(cheaptrick(raw, f0, fs))
    ap = np.asarray(d4c_band_aperiodicity(raw, f0, fs))
    return raw, fs, f0, sp, ap


def test_f0_matches_generating_parameters(fixtures_dir, id_list):
    """Self-contained ground-truth check: F0 extracted from the corpus
    wavs matches the known generating contour (the corpus is synthesised
    from stored parameters; see tools/create_fixtures.py)."""
    for utt in id_list[:3]:
        raw, fs = get_raw(os.path.join(fixtures_dir, "database", "wav",
                                       utt + ".wav"))
        f0 = extract_f0(raw, fs)
        params = np.load(os.path.join(fixtures_dir, "params",
                                      utt + ".npz"))
        f0_true = params["f0"]
        n = min(len(f0), len(f0_true))
        both = (f0[:n] > 0) & (f0_true[:n] > 0)
        err = np.abs(f0[:n][both] - f0_true[:n][both])
        # IF refinement brings the synthetic-truth median to ~0.16 Hz;
        # 0.6 allows per-utterance spread while pinning the gain.
        assert np.median(err) < 0.6, np.median(err)
        agree = ((f0[:n] > 0) == (f0_true[:n] > 0)).mean()
        assert agree > 0.85, agree


def test_f0_parity_with_reference(ref_fixtures_dir):
    """VUV agreement and voiced RMSE against the reference's
    DIO+StoneMask lf0/vuv tracks."""
    agree, rmse, gpe = [], [], []
    for utt in ["LJ001-0001", "LJ001-0002", "LJ001-0003"]:
        raw, fs = get_raw(os.path.join(ref_fixtures_dir, "database",
                                       "wav", utt + ".wav"))
        f0 = extract_f0(raw, fs)
        lf0 = np.fromfile(os.path.join(ref_fixtures_dir, "WORLD", "lf0",
                                       utt + ".lf0"), dtype=np.float32)
        vuv = np.fromfile(os.path.join(ref_fixtures_dir, "WORLD", "vuv",
                                       utt + ".vuv"), dtype=np.float32)
        n = min(len(f0), len(lf0))
        assert abs(len(f0) - len(lf0)) <= 1  # frame-count convention
        mine_v = f0[:n] > 0
        ref_v = vuv[:n] > 0
        agree.append((mine_v == ref_v).mean())
        both = mine_v & ref_v
        f0_ref = np.exp(lf0[:n][both])
        err = np.abs(f0[:n][both] - f0_ref)
        rmse.append(np.sqrt(np.mean(err ** 2)))
        gpe.append((err / f0_ref > 0.2).mean())
    assert np.mean(agree) > 0.90, np.mean(agree)
    assert np.mean(rmse) < 15.0, np.mean(rmse)
    assert np.mean(gpe) < 0.02, np.mean(gpe)


def test_f0_vuv_agreement_all_fixtures(ref_fixtures_dir):
    """Dedicated VUV gate over ALL nine fixture utterances: the
    four-interval voicing refinement (ops/world/f0.py::refine_vuv)
    holds >=0.92 frame agreement with the reference's pyworld Harvest
    voicing (equivalently VDE <= 0.08), >=0.90 on every utterance.
    Measured at recording time: 0.941 overall, worst utterance 0.924,
    mean voiced RMSE 9.9 Hz, mean GPE 0.63%."""
    with open(os.path.join(ref_fixtures_dir, "file_id_list.txt")) as f:
        ids = [line.strip() for line in f]
    agree_frames = total_frames = 0
    per_utt = {}
    for utt in ids:
        raw, fs = get_raw(os.path.join(ref_fixtures_dir, "database",
                                       "wav", utt + ".wav"))
        f0 = extract_f0(raw, fs)
        vuv = np.fromfile(os.path.join(ref_fixtures_dir, "WORLD", "vuv",
                                       utt + ".vuv"), dtype=np.float32)
        n = min(len(f0), len(vuv))
        match = ((f0[:n] > 0) == (vuv[:n] > 0))
        per_utt[utt] = match.mean()
        agree_frames += match.sum()
        total_frames += n
    assert agree_frames / total_frames >= 0.92, per_utt
    assert min(per_utt.values()) >= 0.90, per_utt


def test_mcep_direct_compat_with_reference_fixtures(ref_fixtures_dir):
    """Repo-extracted mcep matches the reference's fixture mcep20
    DIRECTLY — no fitted map.

    The reference's committed fixtures were extracted with Merlin-era
    conventions: preemphasis 0.97 (its own extraction tests,
    test_WorldFeatLabelGen.py:710,773) and warping alpha 0.58 for
    16 kHz (the commented Merlin table in AudioProcessing.py:42; its
    live code now returns pysptk.mcepalpha -> 0.41).  With matching
    settings the full extraction path (our F0 + CheapTrick + UELS
    mcep) lands at ~2.6-3.1 dB raw MCD against pyworld+pysptk output —
    the residual is envelope fine structure, not a basis difference
    (see test_mcep_recovers_sptk_model_exactly).  A regression in
    F0/CheapTrick/mcep code pushes this pin red.
    """
    from idiaptts_tpu.ops.world.extract import world_analysis
    for utt, bound in [("LJ001-0001", 3.4), ("LJ001-0002", 3.2)]:
        raw, fs = get_raw(os.path.join(ref_fixtures_dir, "database",
                                       "wav", utt + ".wav"),
                          preemphasis=0.97)
        _, mc, _ = world_analysis(raw, fs, num_coded_sps=20,
                                  mgc_alpha=0.58)
        mc_ref = np.fromfile(
            os.path.join(ref_fixtures_dir, "WORLD", "mcep20",
                         utt + ".mcep"), dtype=np.float32).reshape(-1, 20)
        n = min(len(mc), len(mc_ref))
        d = np.asarray(mc[:n, 1:]) - mc_ref[:n, 1:]
        mcd = (10.0 / np.log(10)) * np.sqrt(2.0) * np.mean(
            np.sqrt(np.sum(d ** 2, axis=1)))
        assert mcd < bound, (utt, mcd)


def test_mcep_recovers_sptk_model_exactly():
    """The UELS analysis basis IS the SPTK mel-cepstral basis: a
    spectrum generated from known mel-cepstral coefficients
    ``log|H| = sum_m c_m cos(m * beta(w))`` must be recovered
    coefficient-exactly (any basis/measure mismatch shows up as a
    systematic residual here)."""
    import jax.numpy as jnp
    from idiaptts_tpu.ops import mcep as M
    rng = np.random.RandomState(0)
    order, bins = 20, 513
    for alpha in (0.41, 0.58):
        c_true = rng.randn(8, order + 1) * (0.8 ** np.arange(order + 1))
        c_true[:, 0] += 2.0
        _, A = M._bases(bins, order, alpha)
        amp = np.exp(c_true @ A.T)
        c_est = np.asarray(M.amp_sp_to_mcep(jnp.asarray(amp), order,
                                            alpha))
        assert np.abs(c_est - c_true).max() < 0.02, alpha


def test_f0_synthetic_accuracy():
    fs = 16000
    t = np.arange(fs * 2) / fs
    f0_true = 150 + 50 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0_true) / fs
    sig = np.sin(phase) + 0.4 * np.sin(2 * phase) + 0.2 * np.sin(3 * phase)
    f0 = extract_f0(sig, fs)
    ref = 150 + 50 * np.sin(2 * np.pi * 0.7 * np.arange(len(f0)) * 0.005)
    voiced = f0 > 0
    assert voiced.mean() > 0.95
    err = np.abs(f0[voiced] - ref[voiced])
    assert np.percentile(err, 95) < 3.0


def test_f0_silence_is_unvoiced():
    assert np.all(extract_f0(np.zeros(16000), 16000) == 0)


def test_cheaptrick_shapes_and_positivity(analysis):
    raw, fs, f0, sp, ap = analysis
    assert sp.shape == (len(f0), 513)
    assert np.all(sp > 0)
    assert np.all(np.isfinite(sp))
    # Relative floor bounds the per-frame dynamic range to ~90 dB.
    dyn = 10 * (np.log10(sp.max(1)) - np.log10(sp.min(1)))
    assert dyn.max() < 95.0


def test_bap_coding_contract(analysis):
    raw, fs, f0, sp, ap = analysis
    assert ap.shape[1] == get_num_aperiodicities(fs) == 1
    bap = np.asarray(code_aperiodicity(ap))
    voiced = f0 > 0
    assert np.all(bap <= 0) and np.all(bap >= np.log(1e-9) - 1e-3)
    # Unvoiced fully aperiodic.
    assert np.allclose(bap[~voiced], 0.0, atol=1e-4)


def test_bap_scale_matches_reference(ref_fixtures_dir):
    raw, fs = get_raw(os.path.join(ref_fixtures_dir, "database", "wav",
                                   REF_UTT + ".wav"))
    raw = raw[:fs * 4]
    f0 = extract_f0(raw, fs)
    ap = np.asarray(d4c_band_aperiodicity(raw, f0, fs))
    bap = np.asarray(code_aperiodicity(ap))
    bref = np.fromfile(os.path.join(ref_fixtures_dir, "WORLD", "bap",
                                    REF_UTT + ".bap"),
                       dtype=np.float32)[:len(f0)]
    voiced = f0 > 0
    assert abs(np.median(bap[voiced]) - np.median(bref[voiced])) < 2.0


def test_decode_aperiodicity_anchors():
    bap = jnp.asarray([[-5.0]])
    ap = np.asarray(decode_aperiodicity(bap, 513, 16000))
    assert ap.shape == (1, 513)
    assert ap[0, 0] < 1e-8           # 0 Hz pinned at floor
    band_3k = int(3000 / (16000 / 2) * 512)
    np.testing.assert_allclose(ap[0, band_3k], np.exp(-5.0), rtol=0.05)


def test_roundtrip_resynthesis(analysis):
    """analysis -> synthesis -> re-analysis recovers F0, VUV and the
    envelope (the pyworld-equivalence criterion)."""
    raw, fs, f0, sp, ap = analysis
    bap = np.asarray(code_aperiodicity(ap))
    ap_full = np.asarray(decode_aperiodicity(jnp.asarray(bap),
                                             sp.shape[1], fs))
    wav = np.asarray(world_synthesis(f0, sp, ap_full, fs))
    assert len(wav) == len(f0) * int(fs * 0.005)
    # Similar loudness.
    rms_ratio = np.sqrt((wav ** 2).mean()) / np.sqrt((raw ** 2).mean())
    assert 0.5 < rms_ratio < 2.0

    f0_2 = extract_f0(wav, fs)
    n = min(len(f0), len(f0_2))
    vuv_agree = ((f0[:n] > 0) == (f0_2[:n] > 0)).mean()
    assert vuv_agree > 0.9, vuv_agree
    both = (f0[:n] > 0) & (f0_2[:n] > 0)
    err = np.abs(f0[:n][both] - f0_2[:n][both])
    assert np.sqrt((err ** 2).mean()) < 10.0

    sp_2 = np.asarray(cheaptrick(wav, f0_2, fs))
    alpha = mcep_ops.fs_to_mgc_alpha(fs)
    c1 = np.asarray(mcep_ops.amp_sp_to_mcep(
        jnp.asarray(np.sqrt(sp[:n])), 19, alpha))
    c2 = np.asarray(mcep_ops.amp_sp_to_mcep(
        jnp.asarray(np.sqrt(sp_2[:n])), 19, alpha))
    mcd = np.mean(np.sqrt(np.sum((c1[both][:, 1:] - c2[both][:, 1:]) ** 2,
                                 axis=1))) * 10 * np.sqrt(2) / np.log(10)
    assert mcd < 3.0, mcd  # measured ~1.6 dB


def test_synthesis_envelope_calibration():
    """Re-analysis of a synthesised constant-envelope tone recovers the
    envelope to ~0.5 dB (the calibration contract in synthesis.py)."""
    fs, T = 16000, 300
    f0 = np.full(T, 150.0, np.float32)
    omega = np.linspace(0, np.pi, 513)
    sp = np.exp(-6 + 2 * np.cos(2 * omega)
                - 2 * omega / np.pi)[None, :].repeat(T, 0)
    ap = np.full((T, 513), 0.01, np.float32)
    wav = np.asarray(world_synthesis(f0, sp.astype(np.float32), ap, fs))
    f0e = extract_f0(wav, fs)
    sp2 = np.asarray(cheaptrick(wav, f0e, fs))
    d = 10 * np.log10(sp2[50:-50]) - 10 * np.log10(sp[50:-50])
    assert abs(d.mean()) < 1.0
    assert d.std() < 1.0


def test_noise_only_synthesis_calibration():
    fs, T = 16000, 300
    f0 = np.zeros(T, np.float32)
    omega = np.linspace(0, np.pi, 513)
    sp = np.exp(-6 + 2 * np.cos(2 * omega)
                - 2 * omega / np.pi)[None, :].repeat(T, 0)
    ap = np.ones((T, 513), np.float32)
    wav = np.asarray(world_synthesis(f0, sp.astype(np.float32), ap, fs))
    sp2 = np.asarray(cheaptrick(wav, f0, fs))
    d = 10 * np.log10(sp2[50:-50]) - 10 * np.log10(sp[50:-50])
    assert abs(d.mean()) < 1.5
