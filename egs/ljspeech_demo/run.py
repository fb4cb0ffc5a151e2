"""End-to-end LJSpeech demo recipe (the role of the reference's
external ``idiaptts_egs_*`` recipe repos, self-contained on the
committed 9-utterance fixture set).

Stages (Kaldi-style ``--stage N`` resume):
  1  extract WORLD features (fused analysis) + norm stats
  2  generate question labels from HTS state-aligned labels (+ C++
     matcher if built) and phone durations
  3  train the duration model
  4  train the acoustic model
  5  benchmark the acoustic model (MCD / F0-RMSE / VDE / BAP)
  6  synthesise test utterances from labels (full TTS:
     duration -> acoustic -> WORLD vocoder)
  7  online serving demo: concurrent requests through
     trainer.serve()'s batching SynthesisServer
  8  (opt-in: --stop_stage 8) train a WaveNet neural vocoder on the
     corpus, export a standalone vocoder bundle, and neural-vocode a
     test utterance (autoregressive generation is slow on CPU)

Usage:
  python egs/ljspeech_demo/run.py --work_dir /tmp/ljdemo [--stage 1]
      [--epochs 8] [--fixtures /root/reference/test/integration/fixtures]
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import recipe_common

logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s %(levelname)s %(message)s")
logger = logging.getLogger("ljspeech_demo")

NUM_SPS = 20


def _num_questions(args):
    return recipe_common.num_questions(args.fixtures)


def _question_file(args):
    return recipe_common.question_file(args.fixtures)


def stage1_world(args, ids):
    recipe_common.stage_world(args.fixtures, args.work_dir, ids,
                              NUM_SPS)


def stage2_labels(args, ids):
    from idiaptts_tpu.data.phonemes import PhonemeDurationLabelGen
    from idiaptts_tpu.data.questions import QuestionLabelGen
    label_dir = os.path.join(args.fixtures, "labels",
                             "label_state_align")
    q_file = _question_file(args)
    QuestionLabelGen.gen_data(
        label_dir, q_file,
        dir_out=os.path.join(args.work_dir, "questions"), id_list=ids)
    PhonemeDurationLabelGen.gen_data(
        label_dir, dir_out=os.path.join(args.work_dir, "dur"),
        id_list=ids)
    logger.info("questions + durations done")


def _dur_trainer(args, ids):
    import numpy as np
    from idiaptts_tpu.data.phonemes import PhonemeDurationLabelGen
    from idiaptts_tpu.data.questions import QuestionLabelGen
    from idiaptts_tpu.data.normalisation import MinMaxExtractor
    from idiaptts_tpu.train.duration import DurationModelTrainer

    # Phone-level questions (first frame of each phone).
    dir_q_phone = os.path.join(args.work_dir, "questions_phone")
    num_questions = _num_questions(args)
    if not os.path.isdir(dir_q_phone):
        os.makedirs(dir_q_phone, exist_ok=True)
        extractor = MinMaxExtractor()
        for id_name in ids:
            q = QuestionLabelGen.load_sample(
                id_name, os.path.join(args.work_dir, "questions"),
                num_questions=num_questions)
            dur = PhonemeDurationLabelGen.load_sample(
                id_name, os.path.join(args.work_dir, "dur"))
            frames = dur.sum(axis=1).astype(np.int64)
            starts = np.minimum(np.cumsum(frames) - frames,
                                len(q) - 1)
            phone_q = q[starts]
            extractor.add_sample(phone_q)
            phone_q.astype(np.float32).tofile(
                os.path.join(dir_q_phone, id_name + ".questions"))
        extractor.save(os.path.join(dir_q_phone, "all"))

    hparams = DurationModelTrainer.create_hparams()
    hparams.num_questions = num_questions
    hparams.out_dir = os.path.join(args.work_dir, "dur_model")
    hparams.model_name = "duration"
    hparams.epochs = args.epochs
    hparams.batch_size_train = 4
    hparams.seed = 1
    hparams.test_set_perc = 0.0
    hparams.val_set_perc = 0.25
    # Stage-3 reruns resume training on the existing checkpoint
    # (logged by stage3_duration); no later stage loads this model.
    hparams.load_newest_checkpoint = True
    trainer = DurationModelTrainer(
        hparams, ids, dir_phoneme_labels=dir_q_phone,
        dir_durations=os.path.join(args.work_dir, "dur"))
    return trainer, hparams


def stage3_duration(args, ids):
    trainer, hparams = _dur_trainer(args, ids)
    _log_resume_state(hparams, "stage 3 (duration)")
    trainer.init(hparams)
    trainer.train(hparams)
    logger.info("duration model trained")


def _log_resume_state(hparams, what):
    nn_dir = os.path.join(hparams.out_dir, hparams.model_name,
                          hparams.get("networks_dir", "nn"))
    if os.path.isdir(nn_dir) and os.listdir(nn_dir):
        logger.info("%s: existing checkpoint in %s — training resumes "
                    "on top of it; use a fresh --work_dir to retrain "
                    "from scratch.", what, nn_dir)


def _acoustic_trainer(args, ids, strict_load=False):
    from idiaptts_tpu.train.acoustic import AcousticModelTrainer
    hparams = AcousticModelTrainer.create_hparams()
    hparams.num_questions = _num_questions(args)
    hparams.num_coded_sps = NUM_SPS
    hparams.out_dir = os.path.join(args.work_dir, "am")
    hparams.model_name = "acoustic"
    hparams.epochs = args.epochs
    hparams.batch_size_train = 2
    hparams.batch_size_val = 9
    hparams.batch_size_benchmark = 9
    hparams.seed = 1
    hparams.test_set_perc = 0.0
    hparams.val_set_perc = 0.25
    hparams.synth_fs = 16000
    # Kaldi-style stage resume.  Later stages (benchmark/synth/serve)
    # demand the TRAINED model and fail loudly if it is missing
    # (strict); stage 4 loads leniently so a fresh work_dir still
    # trains from scratch (a found checkpoint resumes, logged).
    if strict_load:
        hparams.load_from_checkpoint = True
    else:
        hparams.load_newest_checkpoint = True
    trainer = AcousticModelTrainer(
        hparams, ids,
        dir_question_labels=os.path.join(args.work_dir, "questions"),
        dir_world_features=os.path.join(args.work_dir, "WORLD"))
    return trainer, hparams


def stage4_acoustic(args, ids):
    trainer, hparams = _acoustic_trainer(args, ids)
    _log_resume_state(hparams, "stage 4 (acoustic)")
    if args.small_models:
        from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
        cfg = convert_legacy_string(
            "RNNDYN-1_RELU_128-1_BiLSTM_64-1_FC_67",
            _num_questions(args))
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred_acoustic_features",)
        trainer.init(hparams, model_config=cfg)
    else:
        trainer.init(hparams)
    trainer.train(hparams)
    logger.info("acoustic model trained")


def stage5_benchmark(args, ids):
    trainer, hparams = _acoustic_trainer(args, ids, strict_load=True)
    if args.small_models:
        from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
        cfg = convert_legacy_string(
            "RNNDYN-1_RELU_128-1_BiLSTM_64-1_FC_67",
            _num_questions(args))
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred_acoustic_features",)
        trainer.init(hparams, model_config=cfg)
    else:
        trainer.init(hparams)
    scores = trainer.benchmark(hparams, ids)
    logger.info("benchmark (MCD dB, F0-RMSE Hz, VDE, BAP dB): %s",
                scores)
    return scores


def stage6_synth(args, ids):
    trainer, hparams = _acoustic_trainer(args, ids, strict_load=True)
    if args.small_models:
        from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
        cfg = convert_legacy_string(
            "RNNDYN-1_RELU_128-1_BiLSTM_64-1_FC_67",
            _num_questions(args))
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred_acoustic_features",)
        trainer.init(hparams, model_config=cfg)
    else:
        trainer.init(hparams)
    hparams.synth_dir = os.path.join(args.work_dir, "synth")
    paths = trainer.synth(hparams, ids[:2])
    import numpy as np
    from idiaptts_tpu.ops.audio_io import get_raw
    for id_name, path in paths.items():
        raw, _ = get_raw(path)
        logger.info("synthesised %s (rms %.4f)", path,
                    float(np.sqrt((raw ** 2).mean())))
    logger.info("NOTE: with the smoke settings (--small_models, few "
                "epochs, 9 utterances) the VUV head often predicts "
                "all-unvoiced, giving a very quiet waveform; "
                "copy-synthesis (trainer.copy_synth) and the full-size "
                "default model at 25+ epochs produce loud speech "
                "(README quality numbers).")
    return paths


def stage7_serve(args, ids):
    """Online serving: trainer.serve() wraps the trained model's fused
    pipeline in a request-batching SynthesisServer; submit all test
    utterances concurrently and report occupancy / realtime factor."""
    import numpy as np

    trainer, hparams = _acoustic_trainer(args, ids)
    if args.small_models:
        from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
        cfg = convert_legacy_string(
            "RNNDYN-1_RELU_128-1_BiLSTM_64-1_FC_67",
            _num_questions(args))
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred_acoustic_features",)
        trainer.init(hparams, model_config=cfg)
    else:
        trainer.init(hparams)
    server = trainer.serve(hparams, max_batch=8, max_wait_ms=20.0)
    _, _, load_inputs = trainer.build_serving(hparams)
    futures = [(i, server.submit(load_inputs(i))) for i in ids]
    out_dir = os.path.join(args.work_dir, "served")
    os.makedirs(out_dir, exist_ok=True)
    from idiaptts_tpu.ops.audio_io import raw_to_file
    for id_name, fut in futures:
        wav = fut.result(timeout=600)
        raw_to_file(os.path.join(out_dir, id_name + ".wav"), wav,
                    hparams.get("synth_fs", 16000))
    stats = server.stats()
    logger.info("served %d requests in %d batches (occupancy %.1f, "
                "%.0fx realtime)", stats["requests"], stats["batches"],
                stats["mean_batch_occupancy"], stats["x_realtime"])
    server.shutdown()
    return stats


def stage8_wavenet(args, ids):
    """WaveNet neural vocoder: train on (WORLD cond, waveform) pairs,
    export a standalone bundle, neural-vocode one test utterance."""
    import numpy as np

    from idiaptts_tpu.models.wavenet import WaveNetWrapper
    from idiaptts_tpu.ops.audio_io import get_raw
    from idiaptts_tpu.train.wavenet_trainer import WaveNetVocoderTrainer

    hparams = WaveNetVocoderTrainer.create_hparams()
    hparams.out_dir = os.path.join(args.work_dir, "wavenet")
    hparams.model_name = "wavenet_voc"
    hparams.epochs = args.epochs
    hparams.batch_size_train = 2
    hparams.learning_rate = 1e-3
    hparams.seed = 1
    hparams.test_set_perc = 0.0
    hparams.val_set_perc = 0.25
    hparams.use_best_as_final_model = False
    hparams.max_input_train_sec = 0.4
    hparams.num_coded_sps_cond = NUM_SPS
    hparams.num_coded_sps = NUM_SPS
    hparams.load_newest_checkpoint = True
    hparams.synth_dir = os.path.join(args.work_dir, "wavenet_synth")
    trainer = WaveNetVocoderTrainer(
        hparams, ids,
        dir_world_features=os.path.join(args.work_dir, "WORLD"),
        dir_audio=os.path.join(args.fixtures, "database", "wav"))
    _log_resume_state(hparams, "stage 8 (wavenet)")
    if args.small_models:
        cfg = WaveNetWrapper.Config(
            input_names=("cond_features",),
            output_names=("pred_logits",),
            target_name="target_quantised", out_channels=256,
            residual_channels=16, gate_channels=32, skip_channels=16,
            num_layers=4, num_stacks=2)
        trainer.init(hparams, model_config=cfg)
    else:
        trainer.init(hparams)
    trainer.train(hparams)
    bundle = trainer.save_for_vocoding(
        hparams, os.path.join(args.work_dir, "wavenet_bundle",
                              "wavenet_voc"))
    logger.info("vocoder bundle exported to %s", bundle)
    paths = trainer.synth(hparams, ids[:1])
    for id_name, path in paths.items():
        raw, _ = get_raw(path)
        logger.info("neural-vocoded %s (rms %.4f)", path,
                    float(np.sqrt((raw ** 2).mean())))
    return paths


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--work_dir", required=True)
    default_fixtures = "/root/reference/test/integration/fixtures"
    if not os.path.isdir(default_fixtures):
        default_fixtures = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "..", "..",
            "tests", "fixtures")
    parser.add_argument("--fixtures", default=default_fixtures)
    parser.add_argument("--stage", type=int, default=1)
    parser.add_argument("--stop_stage", type=int, default=7)
    parser.add_argument("--epochs", type=int, default=8)
    parser.add_argument("--small_models", action="store_true",
                        help="small architectures for CPU smoke runs")
    args = parser.parse_args()
    os.makedirs(args.work_dir, exist_ok=True)

    with open(os.path.join(args.fixtures, "file_id_list.txt")) as f:
        ids = [line.strip().split("/")[-1] for line in f
               if line.strip()]

    recipe_common.run_stages(
        {1: stage1_world, 2: stage2_labels, 3: stage3_duration,
         4: stage4_acoustic, 5: stage5_benchmark, 6: stage6_synth,
         7: stage7_serve, 8: stage8_wavenet},
        args, ids)


if __name__ == "__main__":
    main()
