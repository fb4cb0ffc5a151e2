"""Pinned objective-quality regression tests.

The repo's answer to the reference's 3-decimal benchmark pins
(test_AcousticModelTrainer.py:104 ``(8.616, 78.4, 0.609, 37.352)``,
test_DurationModelTrainer.py:106 ``14.954``): a seeded, fixed-epoch
recipe on the committed fixture corpus whose MCD / F0-RMSE / VDE / BAP
and duration-RMSE must stay inside a tight band of the recorded values.
A regression anywhere in questions/model/MLPG/mcep/F0/metrics code turns
these red.

The pins were recorded on the virtual-CPU platform the suite always
runs under (tests/conftest.py forces JAX_PLATFORMS=cpu), so they are
reproducible everywhere; the tolerance absorbs BLAS/XLA-version noise,
not algorithm changes.
"""

import os

import numpy as np
import pytest

from idiaptts_tpu.train.acoustic import AcousticModelTrainer
from idiaptts_tpu.train.duration import DurationModelTrainer

# Recorded from the seeded recipe below (virtual-CPU platform,
# 2026-08-16).  Tolerances: ±5% relative.
PINNED_ACOUSTIC = {"mcd": 4.097, "f0_rmse": 9.534, "vde": 0.0294,
                   "bap": 12.704}
PINNED_DURATION_RMSE = 3.249
# Atom F0-reconstruction pin (the repo's answer to the reference's
# test_AtomVUVDistPosModelTrainer.py:116 pins (87.312 Hz / 0.624);
# recorded 2026-08-17 on the committed synthetic corpus).
PINNED_ATOM = {"f0_rmse": 8.8186, "vde": 0.4627}
# Three-phase neural-filter pins (reference analogues:
# test_AtomNeuralFilterModelTrainer.py:187-193 (214.1 Hz / 0.604) and
# test_PhraseAtomNeuralFilterModelTrainer.py:224-232 (1679.056 Hz);
# recorded 2026-08-17, seeded 3-epoch-per-phase recipe).
# Re-recorded after surround_with_norm_dist gained exact
# reference semantics (signed, summed, linspace window) —
# the pos-flag targets changed.  Values deterministic over
# two runs; both still beat the reference's analogue pins
# (flat 214.1 Hz / phrase 1679.0 Hz).
PINNED_FLAT = {"f0_rmse": 160.6132, "vde": 0.2475}
PINNED_PHRASE = {"f0_rmse": 245.7131, "vde": 0.2133}
# VTLN speaker-adaptation pin (reference analogue:
# test_VTLNSpeakerAdaptionModelTrainer.py:184 (8.644 dB / 78.4 / 0.609
# / 37.352); recorded 2026-08-17, seeded 8-epoch recipe).
PINNED_VTLN = {"mcd": 10.8833, "f0_rmse": 17.6262, "vde": 0.5373,
               "bap": 36.1106}
# The seeded recipes are deterministic on the recording platform
# (recorded twice bit-identically), so the two-sided band is 1% — wide
# enough for XLA/BLAS version noise, tight enough that a real quality
# regression cannot hide inside it.  (Was 5% before round 4.)
RTOL = 0.01


def assert_pinned(key, got, pinned, rtol=RTOL):
    """Two-sided drift pin on the recording platform (virtual CPU —
    the platform the values were recorded on); on other backends
    (``IDIAPTTS_TEST_PLATFORM=gpu``) the training trajectory differs
    (bf16 matmuls, fused kernels), so assert the one-sided QUALITY
    bound instead: the run must not be materially worse than the pin
    (hardware runs that beat the pin — observed for the duration
    model — must not fail)."""
    import jax

    assert pinned is not None, (key, got)
    tol = max(abs(pinned) * rtol, 1e-3)
    if jax.default_backend() == "cpu":
        assert abs(got - pinned) <= tol, (key, got, pinned)
    else:
        assert got <= pinned + tol, (key, got, pinned)


@pytest.fixture(scope="module")
def acoustic_metrics(fixtures_dir, id_list, num_questions,
                     tmp_path_factory):
    hparams = AcousticModelTrainer.create_hparams()
    hparams.num_questions = num_questions
    hparams.num_coded_sps = 20
    hparams.out_dir = str(tmp_path_factory.mktemp("pin_acoustic"))
    hparams.model_name = "pin_acoustic"
    hparams.epochs = 12
    hparams.batch_size_train = 2
    hparams.batch_size_val = 6
    hparams.batch_size_benchmark = 6
    hparams.learning_rate = 0.002
    hparams.seed = 1
    hparams.use_best_as_final_model = True
    hparams.test_set_perc = 0.0
    hparams.val_set_perc = 0.25
    hparams.synth_fs = 16000
    trainer = AcousticModelTrainer(
        hparams, list(id_list),
        dir_question_labels=os.path.join(fixtures_dir, "questions"),
        dir_world_features=os.path.join(fixtures_dir, "WORLD"))
    from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
    cfg = convert_legacy_string("RNNDYN-2_RELU_128-1_BiLSTM_64-1_FC_67",
                                num_questions)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_acoustic_features",)
    trainer.init(hparams, model_config=cfg)
    trainer.train(hparams)
    mcd, f0_rmse, vde, bap = trainer.benchmark(hparams,
                                               trainer.id_list_train)
    return {"mcd": float(mcd), "f0_rmse": float(f0_rmse),
            "vde": float(vde), "bap": float(bap)}


def test_acoustic_benchmark_pinned(acoustic_metrics):
    print("acoustic metrics:", acoustic_metrics)
    for key, pinned in PINNED_ACOUSTIC.items():
        assert pinned is not None, (
            "record pins first: %s" % acoustic_metrics)
        assert_pinned(key, acoustic_metrics[key], pinned)


def test_duration_benchmark_pinned(fixtures_dir, id_list, question_file,
                                   num_questions, tmp_path):
    from idiaptts_tpu.data.phonemes import PhonemeDurationLabelGen
    from idiaptts_tpu.data.questions import QuestionLabelGen
    from idiaptts_tpu.data.normalisation import MinMaxExtractor

    dir_questions = str(tmp_path / "questions")
    dir_dur = os.path.join(fixtures_dir, "dur")
    label_dir = os.path.join(fixtures_dir, "labels", "label_state_align")
    label_dict, _, _ = QuestionLabelGen.gen_data(
        label_dir, question_file, dir_out=None, id_list=id_list,
        return_dict=True)
    os.makedirs(dir_questions, exist_ok=True)
    extractor = MinMaxExtractor()
    for id_name, frames in label_dict.items():
        dur = PhonemeDurationLabelGen.load_sample(id_name, dir_dur)
        frame_idx = np.cumsum(dur.sum(axis=1).astype(np.int64)) \
            - dur.sum(axis=1).astype(np.int64)
        frame_idx = np.minimum(frame_idx, len(frames) - 1)
        phone_level = frames[frame_idx]
        extractor.add_sample(phone_level)
        phone_level.astype(np.float32).tofile(
            os.path.join(dir_questions, id_name + ".questions"))
    extractor.save(os.path.join(dir_questions, "all"))

    hparams = DurationModelTrainer.create_hparams()
    hparams.num_questions = num_questions
    hparams.out_dir = str(tmp_path / "exp")
    hparams.model_name = "pin_dur"
    hparams.epochs = 12
    hparams.batch_size_train = 2
    hparams.batch_size_val = 6
    hparams.learning_rate = 0.002
    hparams.seed = 1
    hparams.use_best_as_final_model = True
    hparams.test_set_perc = 0.0
    hparams.val_set_perc = 0.25
    trainer = DurationModelTrainer(hparams, list(id_list),
                                   dir_phoneme_labels=dir_questions,
                                   dir_durations=dir_dur)
    trainer.init(hparams)
    trainer.train(hparams)
    rmse, _ = trainer.benchmark(hparams, trainer.id_list_train)
    print("duration rmse:", float(rmse))
    assert_pinned("dur_rmse", float(rmse), PINNED_DURATION_RMSE)


def test_atom_benchmark_pinned(fixtures_dir, id_list, num_questions,
                               tmp_path):
    """Seeded atom-model recipe: F0 reconstruction RMSE / VDE from
    predicted atom spikes must stay pinned (reference analogue:
    test_AtomVUVDistPosModelTrainer.py:116)."""
    from idiaptts_tpu.train.atom_trainers import AtomModelTrainer
    from idiaptts_tpu.models.rnn_dyn import convert_legacy_string

    hparams = AtomModelTrainer.create_hparams()
    hparams.num_questions = num_questions
    hparams.thetas = [0.03, 0.06, 0.09, 0.12, 0.15]
    hparams.out_dir = str(tmp_path / "exp")
    hparams.model_name = "pin_atoms"
    hparams.epochs = 10
    hparams.batch_size_train = 3
    hparams.learning_rate = 0.001
    hparams.seed = 1
    hparams.test_set_perc = 0.0
    hparams.val_set_perc = 0.25
    hparams.use_best_as_final_model = True
    trainer = AtomModelTrainer(
        hparams, list(id_list),
        dir_question_labels=os.path.join(fixtures_dir, "questions"),
        dir_atom_labels=os.path.join(
            fixtures_dir, "wcad-0.030_0.060_0.090_0.120_0.150"),
        dir_world_features=os.path.join(fixtures_dir, "WORLD"))
    cfg = convert_legacy_string("RNNDYN-1_RELU_64-1_FC_5",
                                num_questions)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_atoms",)
    trainer.init(hparams, model_config=cfg)
    trainer.train(hparams)
    f0_rmse, vde = trainer.benchmark(hparams, trainer.id_list_train)
    print("atom metrics:", float(f0_rmse), float(vde))
    for key, got in [("f0_rmse", float(f0_rmse)), ("vde", float(vde))]:
        pinned = PINNED_ATOM[key]
        assert_pinned(key, got, pinned)


def test_phrase_pipeline_benchmark_pinned(fixtures_dir, id_list,
                                          num_questions, tmp_path):
    """Seeded three-phase atom -> flat -> phrase recipe: F0-RMSE / VDE
    of the flat neural-filter model and the full phrase model must stay
    pinned (reference analogues:
    test_AtomNeuralFilterModelTrainer.py:187-193,
    test_PhraseAtomNeuralFilterModelTrainer.py:224-232)."""
    from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
    from idiaptts_tpu.train.atom_trainers import (
        AtomNeuralFilterModelTrainer, AtomVUVDistPosModelTrainer,
        PhraseAtomNeuralFilterModelTrainer)

    dirs = dict(
        dir_question_labels=os.path.join(fixtures_dir, "questions"),
        dir_atom_labels=os.path.join(
            fixtures_dir, "wcad-0.030_0.060_0.090_0.120_0.150"),
        dir_world_features=os.path.join(fixtures_dir, "WORLD"))

    def base_hp(cls, name, epochs):
        hp = cls.create_hparams()
        hp.num_questions = num_questions
        hp.thetas = [0.03, 0.06, 0.09, 0.12, 0.15]
        hp.out_dir = str(tmp_path / name)
        hp.model_name = name
        hp.epochs = epochs
        hp.batch_size_train = 3
        hp.batch_size_val = 6
        hp.learning_rate = 0.001
        hp.seed = 1
        hp.test_set_perc = 0.0
        hp.val_set_perc = 0.25
        hp.use_best_as_final_model = False
        return hp

    atom_hp = base_hp(AtomVUVDistPosModelTrainer, "atoms", 3)
    atom_tr = AtomVUVDistPosModelTrainer(atom_hp, list(id_list), **dirs)
    atom_cfg = convert_legacy_string("RNNDYN-1_RELU_32-1_FC_7",
                                     num_questions)
    atom_cfg.input_names = ("questions",)
    atom_cfg.output_names = ("pred_atoms",)
    atom_tr.init(atom_hp, model_config=atom_cfg)
    flat_hp = base_hp(AtomNeuralFilterModelTrainer, "flat", 3)
    flat_tr = AtomNeuralFilterModelTrainer(flat_hp, list(id_list),
                                           **dirs)
    flat_tr.init_atom(flat_hp, atom_tr)
    flat_tr.init(flat_hp)
    phrase_hp = base_hp(PhraseAtomNeuralFilterModelTrainer, "phrase", 3)
    phrase_hp.add_hparams(phrase_bias_init=5.2)
    phrase_tr = PhraseAtomNeuralFilterModelTrainer(
        phrase_hp, list(id_list), **dirs)
    phrase_tr.init_flat(phrase_hp, flat_tr)
    phrase_tr.init(phrase_hp)

    phrase_tr.train_atom(atom_hp)
    phrase_tr.train_flat(flat_hp)
    phrase_tr.train(phrase_hp)

    flat_rmse, flat_vde = flat_tr.benchmark(flat_hp,
                                            flat_tr.id_list_train)
    f0_rmse, vde = phrase_tr.benchmark(phrase_hp,
                                       phrase_tr.id_list_train)
    print("flat:", float(flat_rmse), float(flat_vde),
          "phrase:", float(f0_rmse), float(vde))
    for key, got, pins in [("f0_rmse", float(flat_rmse), PINNED_FLAT),
                           ("vde", float(flat_vde), PINNED_FLAT),
                           ("f0_rmse", float(f0_rmse), PINNED_PHRASE),
                           ("vde", float(vde), PINNED_PHRASE)]:
        pinned = pins[key]
        assert_pinned(key, got, pinned)


def test_vtln_benchmark_pinned(fixtures_dir, id_list, num_questions,
                               tmp_path):
    """Seeded VTLN speaker-adaptation recipe: MCD / F0-RMSE / VDE / BAP
    must stay pinned (reference analogue:
    test_VTLNSpeakerAdaptionModelTrainer.py:184)."""
    from idiaptts_tpu.train.vtln_trainer import \
        VTLNSpeakerAdaptionModelTrainer
    from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
    from idiaptts_tpu.data.category import CategoryDataReader

    hparams = VTLNSpeakerAdaptionModelTrainer.create_hparams()
    hparams.num_questions = num_questions
    hparams.num_coded_sps = 20
    hparams.out_dir = str(tmp_path / "exp")
    hparams.model_name = "pin_vtln"
    hparams.epochs = 8
    hparams.batch_size_train = 3
    hparams.batch_size_val = 6
    hparams.learning_rate = 0.0005
    hparams.seed = 1
    hparams.test_set_perc = 0.0
    hparams.val_set_perc = 0.25
    hparams.use_best_as_final_model = True
    hparams.warp_matrix_size = 20
    trainer = VTLNSpeakerAdaptionModelTrainer(
        hparams, list(id_list),
        dir_question_labels=os.path.join(fixtures_dir, "questions"),
        dir_world_features=os.path.join(fixtures_dir, "WORLD"))
    pre_net = convert_legacy_string("RNNDYN-1_RELU_64-1_FC_67",
                                    num_questions)
    pre_net.input_names = ("questions",)
    pre_net.output_names = ("pre_net_output",)
    data_configs = trainer.default_data_reader_configs(hparams)
    data_configs.append(CategoryDataReader.Config(
        name="speaker_embedding", get_category_fn=lambda idn: [0.5]))
    model_config = trainer.build_model_config(hparams, pre_net, 20)
    trainer.init(hparams, model_config=model_config,
                 data_reader_configs=data_configs)
    trainer.train(hparams)
    mcd, f0_rmse, vde, bap = trainer.benchmark(hparams,
                                               trainer.id_list_train)
    got = {"mcd": float(mcd), "f0_rmse": float(f0_rmse),
           "vde": float(vde), "bap": float(bap)}
    print("vtln metrics:", got)
    for key, pinned in PINNED_VTLN.items():
        assert_pinned(key, got[key], pinned)
