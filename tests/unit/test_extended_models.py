"""Tests for VTLN, intonation filters, atoms, windowing wrapper and
WaveNet (mirrors test_AllPassLayer.py, test_GradientScaling.py and the
wcad/WaveNet test strategies of the reference)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from idiaptts_tpu.data.atoms import AtomLabelGen, GammaAtom
from idiaptts_tpu.models.intonation import (ComplexFilterBank,
                                            CriticalFilterBank,
                                            theta_to_modulus,
                                            modulus_to_theta)
from idiaptts_tpu.models.vtln import (all_pass_warp,
                                      combine_warping_parameters,
                                      gen_w_matrix_3d, get_warp_matrix,
                                      grad_scale)
from idiaptts_tpu.models.wavenet import WaveNetWrapper, generate
from idiaptts_tpu.models.wrappers import WindowingWrapper


# -- VTLN ------------------------------------------------------------------

def _recursive_warp(alpha, n):
    m = np.zeros((n, n))
    m[0, 0] = 1
    for r in range(1, n):
        m[r, 0] = m[r - 1, 0] * alpha
    for c in range(1, n):
        for r in range(1, n):
            m[r, c] = m[r - 1, c - 1] + alpha * (m[r - 1, c]
                                                 - m[r, c - 1])
    return m


def test_warp_matrix_matches_recursive():
    """Polynomial tensor equals the recursive construction
    (AllPassWarp.compare_with_recursive :80-146 criterion)."""
    n = 20
    for alpha in (-0.2, -0.05, 0.0, 0.1, 0.3):
        M = np.asarray(get_warp_matrix(jnp.asarray([[alpha]]), n))[0]
        R = _recursive_warp(alpha, n)
        np.testing.assert_allclose(M, R, atol=1e-3)


def test_warp_identity_at_zero():
    n = 12
    M = np.asarray(get_warp_matrix(jnp.asarray([[0.0]]), n))[0]
    np.testing.assert_allclose(M, np.eye(n), atol=1e-7)
    feat = jnp.asarray(np.random.RandomState(0).randn(2, 7, 36),
                       jnp.float32)
    warped = all_pass_warp(feat, jnp.zeros((2, 7, 1)), 12)
    np.testing.assert_allclose(np.asarray(warped), np.asarray(feat),
                               atol=1e-5)


def test_alpha_composition_law():
    a = combine_warping_parameters([jnp.asarray(0.1), jnp.asarray(0.1)])
    np.testing.assert_allclose(float(a), 0.2 / 1.01, rtol=1e-6)


def test_grad_scale():
    """Identity forward, scaled gradient (test_GradientScaling.py:29-47
    criterion)."""
    x = jnp.asarray(3.0)
    fn = lambda x: grad_scale(x, 10.0) ** 2
    assert float(fn(x)) == pytest.approx(9.0)
    g = jax.grad(fn)(x)
    assert float(g) == pytest.approx(2 * 3.0 * 10.0)


def test_warp_shifts_formants():
    """A positive alpha compresses the cepstrum towards low
    quefrencies; the warped spectrum shifts formants."""
    from idiaptts_tpu.ops import mcep as M
    n = 20
    c = np.zeros((1, 1, n), np.float32)
    c[0, 0, 3] = 1.0
    warped = np.asarray(all_pass_warp(jnp.asarray(c),
                                      jnp.full((1, 1, 1), 0.1), n))
    sp0 = np.asarray(M.mcep_to_amp_sp(jnp.asarray(c[0]), 129, 0.0))
    sp1 = np.asarray(M.mcep_to_amp_sp(jnp.asarray(warped[0]), 129, 0.0))
    # The warped spectrum is a frequency-compressed version: clearly
    # different but with the same overall energy scale.
    rel = np.abs(np.log(sp1[0]) - np.log(sp0[0])).max()
    assert rel > 0.1


# -- intonation filters ----------------------------------------------------

def test_theta_modulus_roundtrip():
    thetas = np.array([0.03, 0.06, 0.09])
    np.testing.assert_allclose(
        modulus_to_theta(theta_to_modulus(thetas)), thetas, rtol=1e-10)


def test_critical_filter_impulse_response():
    """A double-pole IIR turns a spike into a smooth gamma-like bump."""
    bank = CriticalFilterBank(tuple(theta_to_modulus([0.05])))
    x = np.zeros((1, 120, 1), np.float32)
    x[0, 10, 0] = 1.0
    params = bank.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y = np.asarray(bank.apply(params, jnp.asarray(x)))[0, :, 0]
    assert np.all(y[:10] == 0)          # causal
    assert y[11] > 0
    peak = np.argmax(y)
    assert 10 < peak < 60               # delayed smooth peak
    assert y[-1] < y[peak] * 0.5        # decays


def test_complex_filter_oscillates():
    bank = ComplexFilterBank(tuple(theta_to_modulus([0.05])),
                             phase_init=0.3)
    x = np.zeros((1, 200, 1), np.float32)
    x[0, 5, 0] = 1.0
    params = bank.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y = np.asarray(bank.apply(params, jnp.asarray(x)))[0, :, 0]
    # Sign changes => oscillation.
    assert (np.diff(np.sign(y[6:])) != 0).sum() >= 2


def test_filters_trainable():
    bank = CriticalFilterBank(tuple(theta_to_modulus([0.05, 0.1])))
    x = jnp.asarray(np.random.RandomState(0).rand(2, 50, 2),
                    jnp.float32)
    target = jnp.ones((2, 50, 1))
    params = bank.init(jax.random.PRNGKey(0), x)

    def loss(p):
        return jnp.mean((bank.apply(p, x) - target) ** 2)

    l0 = float(loss(params))
    grads = jax.grad(loss)(params)
    params2 = jax.tree_util.tree_map(lambda p, g: p - 0.05 * g, params,
                                     grads)
    assert float(loss(params2)) < l0


# -- atoms -----------------------------------------------------------------

def test_gamma_atom_curve():
    atom = GammaAtom(k=6, theta=0.05, frame_rate=200, amp=2.0,
                     position=10)
    curve = atom.get_padded_curve(100)
    assert np.all(curve[:10] == 0)
    assert curve.max() > 0
    # L2-normalised up to right-truncation at the sequence end.
    norm = np.linalg.norm(curve)
    assert 1.8 < norm <= 2.0 + 1e-6


def test_atom_labelgen_fixtures(fixtures_dir, uid):
    thetas = (0.03, 0.06, 0.09, 0.12, 0.15)
    config = AtomLabelGen.Config(
        name="atoms",
        directory=os.path.join(
            fixtures_dir, "wcad-0.030_0.060_0.090_0.120_0.150"),
        thetas=thetas)
    reader = config.create_reader()
    labels = reader.load(uid)
    T = len(labels)
    assert labels.shape == (T, 5, 2)
    amps = reader.preprocess_sample(labels)
    assert amps.shape == (T, 5)
    # postprocess denormalises back to the raw spike amplitudes.
    restored = reader.postprocess_sample(amps, identify_peaks=False)
    np.testing.assert_allclose(restored[:, :, 0], labels[:, :, 0],
                               atol=1e-4)
    # Reconstruction gives a plausible lf0 deviation curve (the corpus
    # decomposition keeps small-amplitude atoms, min_amp=0.08).
    lf0 = AtomLabelGen.labels_to_lf0(labels, k=6, amp_threshold=0.05)
    assert lf0.shape == (T,)
    assert np.abs(lf0).max() > 0.01
    # phrase curve available
    phrase = reader.load_phrase(uid)
    assert phrase.shape == (T, 1)


def test_atom_reconstruction_correlates_with_lf0(fixtures_dir, uid):
    """atoms + phrase should approximate the true lf0 on voiced frames
    (the GCR decomposition the wcad tool performed)."""
    thetas = (0.03, 0.06, 0.09, 0.12, 0.15)
    config = AtomLabelGen.Config(
        name="atoms",
        directory=os.path.join(
            fixtures_dir, "wcad-0.030_0.060_0.090_0.120_0.150"),
        thetas=thetas)
    reader = config.create_reader()
    labels = reader.load(uid)
    phrase = reader.load_phrase(uid)[:, 0]
    recon = AtomLabelGen.labels_to_lf0(labels, k=6, amp_threshold=0.05)

    def _stream(sub, ext):
        archive = np.load(os.path.join(fixtures_dir, "WORLD", sub,
                                       uid + ".npz"))
        return archive[list(archive.keys())[0]].reshape(-1)
    lf0 = _stream("lf0", ".lf0")
    vuv = _stream("vuv", ".vuv")
    voiced = vuv > 0
    # Atoms model the lf0 residual after removing the phrase curve.
    target = lf0 - phrase
    corr = np.corrcoef(recon[voiced], target[voiced])[0, 1]
    assert corr > 0.7, corr


def test_identify_peaks():
    label = np.zeros((50, 1), np.float32)
    label[10] = 1.0
    label[12] = 0.5   # suppressed (smaller within range)
    label[30] = -0.8
    peaks = AtomLabelGen.identify_peaks(label, peak_range=10)
    assert peaks[10, 0] == 1.0
    assert peaks[12, 0] == 0.0
    assert peaks[30, 0] == -0.8


# -- windowing wrapper -----------------------------------------------------

def test_windowing_wrapper_matches_direct():
    """For a frame-local model, windowed application equals direct."""
    from idiaptts_tpu.models import nn

    class Local(nn.Module):
        def __call__(self, data_dict, lengths=None, training=False):
            x = data_dict["x"]
            return {"pred": x * 2.0 + 1.0}

    wrapper = WindowingWrapper(wrapped=Local(), input_names=("x",),
                               output_names=("y",), window_size=50,
                               window_step=25)
    x = jnp.asarray(np.random.RandomState(0).randn(2, 130, 4),
                    jnp.float32)
    params = wrapper.init(jax.random.PRNGKey(0), {"x": x})
    out = wrapper.apply(params, {"x": x})
    np.testing.assert_allclose(np.asarray(out["y"]),
                               np.asarray(x) * 2.0 + 1.0, atol=1e-4)


# -- wavenet ---------------------------------------------------------------

def test_wavenet_training_and_generation():
    cfg = WaveNetWrapper.Config(
        input_names=("cond_features",), output_names=("pred_logits",),
        target_name="target_quantised", out_channels=64,
        residual_channels=16, gate_channels=32, skip_channels=16,
        num_layers=4, num_stacks=2)
    model = cfg.create_model()
    B, T, C = 2, 100, 5
    rng = np.random.RandomState(0)
    data = {
        "cond_features": jnp.asarray(rng.randn(B, T, C), jnp.float32),
        "target_quantised": jnp.asarray(
            rng.randint(0, 64, (B, T, 1)).astype(np.float32)),
    }
    params = model.init(jax.random.PRNGKey(0), data, training=True)
    out = model.apply(params, data, training=True)
    assert out["pred_logits"].shape == (B, T, 64)

    # Causality: changing the future target must not affect current
    # logits.
    data2 = {k: np.array(v) for k, v in data.items()}
    data2["target_quantised"][:, 60:] = 0.0
    out2 = model.apply(params, {k: jnp.asarray(v)
                                for k, v in data2.items()},
                       training=True)
    np.testing.assert_allclose(np.asarray(out["pred_logits"][:, :55]),
                               np.asarray(out2["pred_logits"][:, :55]),
                               atol=1e-3)

    # Generation runs and produces a bounded waveform.
    cond = np.asarray(data["cond_features"][0])
    raw = generate(params, cfg, jnp.asarray(cond))
    assert raw.shape == (T,)
    assert np.abs(raw).max() <= 1.0


def test_wavenet_generation_matches_teacher_forcing():
    """Incremental generation logits equal the parallel forward when fed
    the same history (generation-vs-training parity)."""
    cfg = WaveNetWrapper.Config(
        input_names=("cond_features",), output_names=("pred_logits",),
        target_name="target_quantised", out_channels=32,
        residual_channels=8, gate_channels=16, skip_channels=8,
        num_layers=3, num_stacks=1)
    model = cfg.create_model()
    T, C = 20, 3
    rng = np.random.RandomState(1)
    cond = rng.randn(1, T, C).astype(np.float32)
    target = rng.randint(0, 32, (1, T, 1)).astype(np.float32)
    data = {"cond_features": jnp.asarray(cond),
            "target_quantised": jnp.asarray(target)}
    params = model.init(jax.random.PRNGKey(0), data, training=True)
    out = np.asarray(model.apply(params, data,
                                 training=True)["pred_logits"])[0]

    # Manual incremental evaluation with the same teacher-forced
    # history, reusing the generation math.
    from idiaptts_tpu.utils import serialization
    from idiaptts_tpu.models.wavenet import WaveNet
    # Compare the argmax path where history matches: feed the target
    # history through the parallel net shifted by one.
    shifted = np.concatenate([[16], target[0, :-1, 0]]).astype(np.int64)
    net = WaveNet(out_channels=32, residual_channels=8,
                  gate_channels=16, skip_channels=8, num_layers=3,
                  num_stacks=1)
    logits2 = np.asarray(net.apply(
        {"params": params["params"]["wavenet"]},
        jnp.asarray(shifted[None, :]), jnp.asarray(cond)))[0]
    np.testing.assert_allclose(out, logits2, atol=1e-4)

def test_wavenet_batched_generation_matches_single():
    """Batched generation with identical cond rows equals the single
    run when sampling is effectively greedy (low temperature)."""
    from idiaptts_tpu.models.wavenet import generate
    cfg = WaveNetWrapper.Config(
        input_names=("cond_features",), output_names=("pred_logits",),
        target_name="target_quantised", out_channels=32,
        residual_channels=8, gate_channels=16, skip_channels=8,
        num_layers=4, num_stacks=2)
    model = cfg.create_model()
    T, C = 30, 3
    rng = np.random.RandomState(3)
    cond = rng.randn(1, T, C).astype(np.float32)
    data = {"cond_features": jnp.asarray(cond),
            "target_quantised": jnp.asarray(
                rng.randint(0, 32, (1, T, 1)).astype(np.float32))}
    params = model.init(jax.random.PRNGKey(0), data, training=True)
    single = generate(params, cfg, cond[0], temperature=1e-4)
    batched = generate(params, cfg,
                       np.repeat(cond, 3, axis=0), temperature=1e-4)
    assert batched.shape == (3, T)
    for b in range(3):
        np.testing.assert_allclose(batched[b], single, atol=1e-6)

def test_wavenet_vocoder_checkpoint_and_synthesiser(tmp_path):
    """Config JSON round trip for nested Config classes + batched
    Synthesiser.run_wavenet_vocoder with per-utterance length trim."""
    from idiaptts_tpu.utils import serialization
    from idiaptts_tpu.hparams import ExtendedHParams
    from idiaptts_tpu.ops.audio_io import get_raw
    from idiaptts_tpu.synth.synthesiser import Synthesiser
    cfg = WaveNetWrapper.Config(
        input_names=("cond_features",), output_names=("pred_logits",),
        target_name="target_quantised", out_channels=32,
        residual_channels=8, gate_channels=16, skip_channels=8,
        num_layers=4, num_stacks=2)
    from idiaptts_tpu.models.config import ModelConfig
    restored = ModelConfig.from_json(cfg.to_json())
    assert type(restored) is WaveNetWrapper.Config
    assert restored.num_layers == 4

    model = cfg.create_model()
    rng = np.random.RandomState(0)
    data = {"cond_features": jnp.asarray(rng.randn(1, 50, 3),
                                         jnp.float32),
            "target_quantised": jnp.asarray(
                rng.randint(0, 32, (1, 50, 1)).astype(np.float32))}
    params = model.init(jax.random.PRNGKey(0), data, training=True)
    ckpt = tmp_path / "nn"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(cfg.to_json())
    with open(ckpt / "params_1", "wb") as f:
        f.write(serialization.msgpack_serialize(
            {"params": params["params"]}))

    hp = ExtendedHParams.create_hparams()
    hp.add_hparams(synth_vocoder_path=str(ckpt))
    hp.synth_dir = str(tmp_path / "synth")
    hp.synth_fs = 16000
    out = Synthesiser.run_wavenet_vocoder(
        {"uttA": rng.randn(120, 3).astype(np.float32),
         "uttB": rng.randn(75, 3).astype(np.float32)}, hp)
    assert len(get_raw(out["uttA"])[0]) == 120
    assert len(get_raw(out["uttB"])[0]) == 75

def test_synthesiser_copy_synth_and_gl_on_log(fixtures_dir, id_list,
                                              tmp_path):
    """Synthesiser.copy_synth (WORLD + raw paths) and
    run_griffin_lim_on_log (Synthesiser.py:110-166, :320-322 roles)."""
    import os
    from idiaptts_tpu.hparams import ExtendedHParams
    from idiaptts_tpu.ops.audio_io import get_raw
    from idiaptts_tpu.synth.synthesiser import Synthesiser
    hp = ExtendedHParams.create_hparams()
    hp.num_coded_sps = 20
    hp.sp_type = "mcep"
    hp.synth_fs = 16000
    hp.synth_dir = str(tmp_path)
    paths = Synthesiser.copy_synth(
        hp, [id_list[1]], feature_dir=os.path.join(fixtures_dir,
                                                     "WORLD"))
    raw, fs = get_raw(paths[id_list[1]])
    assert np.sqrt((raw ** 2).mean()) > 0.01
    hp.synth_vocoder = "raw"
    paths = Synthesiser.copy_synth(
        hp, [id_list[2]],
        feature_dir=os.path.join(fixtures_dir, "database", "wav"))
    assert os.path.isfile(paths[id_list[2]])
    amp = np.abs(np.random.RandomState(0).randn(60, 513)) + 0.1
    paths = Synthesiser.run_griffin_lim_on_log(
        {"gl": np.log(amp).astype(np.float32)}, hp)
    raw, _ = get_raw(paths["gl"])
    assert np.isfinite(raw).all() and len(raw) > 1000


def test_r9y9wavenet_world_feats_wrapper(tmp_path):
    """run_r9y9wavenet_mulaw_world_feats_synth upsamples WORLD frame
    features to sample rate and runs the neural vocoder."""
    from idiaptts_tpu.utils import serialization
    import os
    from idiaptts_tpu.hparams import ExtendedHParams
    from idiaptts_tpu.ops.audio_io import get_raw
    from idiaptts_tpu.synth.synthesiser import Synthesiser
    cfg = WaveNetWrapper.Config(
        input_names=("cond_features",), output_names=("pred_logits",),
        target_name="target_quantised", out_channels=32,
        residual_channels=8, gate_channels=16, skip_channels=8,
        num_layers=3, num_stacks=1)
    model = cfg.create_model()
    rng = np.random.RandomState(0)
    data = {"cond_features": jnp.asarray(rng.randn(1, 50, 23),
                                         jnp.float32),
            "target_quantised": jnp.asarray(
                rng.randint(0, 32, (1, 50, 1)).astype(np.float32))}
    params = model.init(jax.random.PRNGKey(0), data, training=True)
    ckpt = tmp_path / "nn"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(cfg.to_json())
    with open(ckpt / "params_1", "wb") as f:
        f.write(serialization.msgpack_serialize(
            {"params": params["params"]}))
    hp = ExtendedHParams.create_hparams()
    hp.add_hparams(synth_vocoder_path=str(ckpt))
    hp.do_post_filtering = True
    hp.num_coded_sps = 20
    hp.synth_fs = 16000
    hp.synth_dir = str(tmp_path / "synth")
    feats = rng.randn(12, 23).astype(np.float32)   # 12 frames, mcep+lf0+vuv+bap
    feats[:, 21] = (feats[:, 21] > 0)
    paths = Synthesiser.run_r9y9wavenet_mulaw_world_feats_synth(
        {"utt": feats}, hp)
    raw, fs = get_raw(paths["utt"])
    assert len(raw) == 12 * 80                     # upsampled to 16 kHz

def test_fused_acoustic_pipeline():
    """FusedAcousticPipeline: list input, bucket padding, per-utterance
    trimming, and agreement with the unfused composition."""
    from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
    from idiaptts_tpu.synth.pipeline import FusedAcousticPipeline
    D, Q = 4, 10
    cfg = convert_legacy_string("RNNDYN-1_RELU_8-1_FC_{}".format(
        3 * D + 3 + 1 + 3), Q)
    cfg.input_names = ("q",)
    cfg.output_names = ("pred",)
    model = cfg.create_model()
    rng = np.random.RandomState(0)
    qs = [rng.rand(40, Q).astype(np.float32),
          rng.rand(25, Q).astype(np.float32)]
    params = model.init(jax.random.PRNGKey(0),
                        {"q": jnp.asarray(qs[0][None])},
                        lengths=jnp.asarray([40]), training=False)

    def apply_fn(params, q, lengths):
        return model.apply(params, {"q": q}, lengths=lengths,
                           training=False)["pred"]

    variances = {"sp": np.ones(3 * D, np.float32),
                 "lf0": np.ones(3, np.float32),
                 "bap": np.ones(3, np.float32)}
    pipe = FusedAcousticPipeline(apply_fn, variances, num_coded_sps=D,
                                 fs=16000, bucket=32)
    wavs = pipe(params, qs)
    assert len(wavs) == 2
    assert wavs[0].shape == (40 * 80,)
    assert wavs[1].shape == (25 * 80,)
    assert all(np.isfinite(w).all() for w in wavs)
    # Same batch through the device-output path agrees.
    T = 64
    batch = np.zeros((2, T, Q), np.float32)
    batch[0, :40] = qs[0]
    batch[1, :25] = qs[1]
    dev = np.asarray(pipe(params, batch,
                          np.array([40, 25], np.int32),
                          device_output=True))
    np.testing.assert_allclose(dev[0][:40 * 80], wavs[0], atol=2e-4)


def test_embedding_groups_in_rnn_dyn():
    """EMB layer groups (RNNDyn Config.py:81-111 role): the legacy
    string declares embeddings consumed from trailing input columns;
    different indices change the affected groups' outputs."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from idiaptts_tpu.models.rnn_dyn import convert_legacy_string

    in_dim = 10
    cfg = convert_legacy_string("RNNDYN-4x8_EMB_(-1)-1_RELU_16-1_FC_3",
                                in_dim + 1)   # +1 embedding index col
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred",)
    assert len(cfg.emb_configs) == 1
    assert cfg.emb_configs[0].num_embeddings == 4
    assert cfg.emb_configs[0].embedding_dim == 8
    model = cfg.create_model()
    B, T = 2, 12
    x = np.random.RandomState(0).randn(B, T, in_dim).astype(np.float32)
    def run(idx):
        data = np.concatenate(
            [x, np.full((B, T, 1), idx, np.float32)], axis=-1)
        params = model.init({"params": jax.random.PRNGKey(0)},
                            {"questions": jnp.asarray(data)},
                            lengths=jnp.array([T, T]), training=False)
        out = model.apply(params, {"questions": jnp.asarray(data)},
                          lengths=jnp.array([T, T]), training=False)
        return np.asarray(out["pred"])
    out0, out1 = run(0), run(1)
    assert out0.shape == (B, T, 3)
    assert np.all(np.isfinite(out0))
    # Same params (same seed), different embedding index -> different
    # outputs through the affected (all, -1) groups.
    assert not np.allclose(out0, out1)


def test_windowing_wrapper_multi_input_and_extra_outputs():
    """Reference WindowingWrapper windows EVERY input tensor (:86-97)
    and merges every output (:229-233): a two-input frame-local model
    round-trips through windows, and outputs beyond output_names keep
    their inner names."""
    from idiaptts_tpu.models import nn

    class TwoIn(nn.Module):
        def __call__(self, data_dict, lengths=None, training=False):
            a, b = data_dict["a"], data_dict["b"]
            return {"pred": a + 2.0 * b, "aux": a - b}

    wrapper = WindowingWrapper(wrapped=TwoIn(), input_names=("a", "b"),
                               output_names=("y",), window_size=40,
                               window_step=20)
    rng = np.random.RandomState(1)
    a = jnp.asarray(rng.randn(2, 95, 3), jnp.float32)
    b = jnp.asarray(rng.randn(2, 95, 3), jnp.float32)
    params = wrapper.init(jax.random.PRNGKey(0), {"a": a, "b": b})
    out = wrapper.apply(params, {"a": a, "b": b})
    np.testing.assert_allclose(np.asarray(out["y"]),
                               np.asarray(a + 2.0 * b), atol=1e-4)
    np.testing.assert_allclose(np.asarray(out["aux"]),
                               np.asarray(a - b), atol=1e-4)


def test_windowing_wrapper_reduce_merges_mask_invalid_chunks():
    """add/mean/mul merges reduce across each sample's VALID chunks
    only (reference :252-310 valid-chunk loops), under static shapes
    with ragged lengths."""
    from idiaptts_tpu.models import nn

    class Sum(nn.Module):
        def __call__(self, data_dict, lengths=None, training=False):
            x = data_dict["x"]
            # Zero padded frames so chunk content reflects lengths.
            t = jnp.arange(x.shape[1])[None, :, None]
            mask = t < lengths[:, None, None]
            return {"pred": jnp.sum(x * mask, axis=1, keepdims=True)}

    W, S = 30, 30
    rng = np.random.RandomState(2)
    x = rng.randn(2, 75, 2).astype(np.float32)
    lengths = np.array([75, 40], np.int32)

    for merge in ("add", "mean", "mul"):
        wrapper = WindowingWrapper(wrapped=Sum(), input_names=("x",),
                                   output_names=("y",), window_size=W,
                                   window_step=S,
                                   output_merge_type=merge)
        params = wrapper.init(jax.random.PRNGKey(0),
                              {"x": jnp.asarray(x)},
                              lengths=jnp.asarray(lengths))
        out = np.asarray(wrapper.apply(params, {"x": jnp.asarray(x)},
                                       lengths=jnp.asarray(lengths))["y"])
        for bi in range(2):
            chunks = []
            for c0 in range(0, 75, S):
                n = min(lengths[bi] - c0, W)
                if n <= 0:
                    break
                chunks.append(x[bi, c0:c0 + n].sum(0, keepdims=True))
            stack = np.stack(chunks)
            if merge == "add":
                want = stack.sum(0)
            elif merge == "mean":
                want = stack.mean(0)
            else:
                want = np.prod(stack, axis=0)
            np.testing.assert_allclose(out[bi], want, rtol=1e-4,
                                       atol=1e-4)


def test_windowing_wrapper_cat_merge():
    """cat concatenates chunk outputs along time (reference
    MERGE_TYPE_CAT :215-227), step == window."""
    from idiaptts_tpu.models import nn

    class Id(nn.Module):
        def __call__(self, data_dict, lengths=None, training=False):
            return {"pred": data_dict["x"] * 3.0}

    wrapper = WindowingWrapper(wrapped=Id(), input_names=("x",),
                               output_names=("y",), window_size=25,
                               window_step=25, output_merge_type="cat")
    x = jnp.asarray(np.random.RandomState(3).randn(1, 70, 2),
                    jnp.float32)
    params = wrapper.init(jax.random.PRNGKey(0), {"x": x})
    out = np.asarray(wrapper.apply(params, {"x": x})["y"])
    assert out.shape == (1, 75, 2)      # 3 chunks x 25, zero padded
    np.testing.assert_allclose(out[0, :70], np.asarray(x[0]) * 3.0,
                               atol=1e-4)


def test_windowing_wrapper_static_first_input():
    """WindowingWrapper derives the sequence length from ALL inputs:
    a static 2-D input (speaker embedding) listed FIRST must not
    disable windowing (regression: T was taken from input_names[0])."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from idiaptts_tpu.models.wrappers import WindowingWrapper
    from idiaptts_tpu.models.named import NamedForwardWrapper
    from idiaptts_tpu.models import nn

    class Probe(nn.Module):
        """Records the time length it was called with."""
        def __call__(self, data_dict, lengths=None, training=False):
            x = data_dict["frames"]
            emb = data_dict["spk"]
            out = x + emb[:, None, :] if emb.ndim == 2 else x + emb
            return {"pred": out * 1.0}

    B, T, D = 2, 50, 3
    wrapper = WindowingWrapper(
        wrapped=Probe(), input_names=("spk", "frames"),
        output_names=("pred",), window_size=16, window_step=8)
    data = {"spk": jnp.ones((B, D)),
            "frames": jnp.asarray(
                np.random.RandomState(0).randn(B, T, D), jnp.float32)}
    params = wrapper.init(jax.random.PRNGKey(0), data,
                          lengths=jnp.array([T, T - 5]))
    out = wrapper.apply(params, data, lengths=jnp.array([T, T - 5]))
    # Windowing engaged (T=50 > 16) and output covers the full length.
    assert out["pred"].shape == (B, T, D)
    assert np.isfinite(np.asarray(out["pred"])).all()


def test_wavenet_wrapper_inference_without_target():
    """trainer.synth runs the wrapper with conditioning only; the
    waveform comes from the AR generator in gen_waveform, so the
    wrapper must tolerate a missing teacher target."""
    import jax
    import jax.numpy as jnp

    cfg = WaveNetWrapper.Config(
        input_names=("cond_features",), output_names=("pred_logits",),
        target_name="target_quantised", out_channels=256,
        residual_channels=16, gate_channels=32, skip_channels=16,
        num_layers=4, num_stacks=2)
    model = WaveNetWrapper(cfg)
    B, T, C = 2, 40, 20
    full = {"cond_features": jnp.zeros((B, T, C)),
            "target_quantised": jnp.zeros((B, T), jnp.int32)}
    params = model.init({"params": jax.random.PRNGKey(0)}, full)
    out = model.apply(params, {"cond_features": jnp.ones((B, T, C))})
    assert out["pred_logits"].shape == (B, T, 256)
