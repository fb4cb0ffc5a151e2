"""Checkpoint semantics tests (mirrors
test_ModularModelHandlerPyTorch.py save->load equality via
equal_checkpoint, plus ignore_layers and layer_map regex renaming)."""

import os

import jax
import numpy as np
import pytest

from idiaptts_tpu.data.dataset import collate_batch
from idiaptts_tpu.hparams import ExtendedHParams
from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
from idiaptts_tpu.train.handler import (ModularModelHandler,
                                        _apply_layer_map,
                                        _merge_ignored)
from idiaptts_tpu.utils.equality import equal_checkpoint, equal_model


def _make_handler(seed=0):
    import numpy as np
    cfg = convert_legacy_string("RNNDYN-1_RELU_8-1_FC_4", 6)
    cfg.input_names = ("x",)
    cfg.output_names = ("pred",)
    handler = ModularModelHandler()
    batch = collate_batch([{"x": np.ones((10, 6), np.float32)}])
    handler.create_model(cfg, example_batch=batch)
    hparams = ExtendedHParams.create_hparams()
    handler.set_optimiser(hparams)
    handler.set_scheduler(hparams)
    return handler


def test_save_load_roundtrip(tmp_path):
    handler = _make_handler()
    out_dir = handler.save_checkpoint(str(tmp_path), "model",
                                      epoch=3, best=True,
                                      best_loss=1.23)
    assert os.path.isfile(os.path.join(out_dir, "config.json"))
    assert os.path.isfile(os.path.join(out_dir, "params_e3"))
    assert os.path.isfile(os.path.join(out_dir, "params_best"))
    # Same weights under both suffixes.
    assert equal_checkpoint(out_dir, "e3", out_dir, "best")

    handler2 = ModularModelHandler()
    hparams = ExtendedHParams.create_hparams()
    best_loss, epoch, _ = handler2.load_checkpoint(str(tmp_path),
                                                   "model", epoch=3)
    assert epoch == 3
    assert equal_model(handler.params, handler2.params)


def test_load_best_restores_loss(tmp_path):
    handler = _make_handler()
    handler.save_checkpoint(str(tmp_path), "m", best=True,
                            best_loss=0.5)
    handler2 = ModularModelHandler()
    hparams = ExtendedHParams.create_hparams()
    handler2.set_optimiser = lambda *a: None
    handler2.model = handler.model
    handler2.model_config = handler.model_config
    handler2.params = handler.params
    handler2.optimiser = handler.optimiser
    best_loss, _, _ = handler2.load_checkpoint(str(tmp_path), "m",
                                               best=True)
    assert best_loss == pytest.approx(0.5)


def test_newest_checkpoint_scan(tmp_path):
    import time
    handler = _make_handler()
    handler.save_checkpoint(str(tmp_path), "m", epoch=1)
    time.sleep(0.05)
    handler.save_checkpoint(str(tmp_path), "m", epoch=2)
    handler2 = ModularModelHandler()
    _, epoch, _ = handler2.load_checkpoint(str(tmp_path), "m")
    assert epoch == 2


def test_ignore_layers():
    from idiaptts_tpu.utils import serialization
    a = {"layer1": {"kernel": np.ones((2, 2))},
         "layer2": {"kernel": np.ones((2, 2))}}
    current = {"layer1": {"kernel": np.zeros((2, 2))},
               "layer2": {"kernel": np.zeros((2, 2))}}
    merged = _merge_ignored(a, current, ["layer1"])
    assert merged["layer1"]["kernel"].sum() == 0   # kept current
    assert merged["layer2"]["kernel"].sum() == 4   # loaded


def test_layer_map_regex():
    params = {"old_name": {"kernel": np.ones(2)},
              "keep": {"bias": np.zeros(2)}}
    renamed = _apply_layer_map(params, [("old_name", "new_name")])
    assert "new_name" in renamed and "old_name" not in renamed
    assert "keep" in renamed

def test_orbax_backend_roundtrip(tmp_path):
    """checkpoint_backend='orbax': directory checkpoints round-trip
    params, optimiser state, and bookkeeping."""
    import jax
    handler = _make_handler()
    handler.checkpoint_backend = "orbax"
    out_dir = handler.save_checkpoint(str(tmp_path), "model",
                                      epoch=2, best=True,
                                      best_loss=0.77)
    assert os.path.isdir(os.path.join(out_dir, "params_e2"))
    assert os.path.isdir(os.path.join(out_dir, "params_best"))

    handler2 = ModularModelHandler()
    hparams = ExtendedHParams.create_hparams()
    handler2.checkpoint_backend = "orbax"
    best_loss, epoch, steps = handler2.load_checkpoint(
        str(tmp_path), "model", best=True, load_optimiser=False)
    assert best_loss == pytest.approx(0.77)
    leaves1 = jax.tree_util.tree_leaves(handler.params)
    leaves2 = jax.tree_util.tree_leaves(handler2.params)
    assert len(leaves1) == len(leaves2)
    for a, b in zip(leaves1, leaves2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    # Optimiser restore path with a live optimiser.
    handler2.set_optimiser(hparams)
    handler2.load_checkpoint(str(tmp_path), "model", epoch=2,
                             load_optimiser=True)
    assert handler2.opt_state is not None
    # _newest_suffix sees orbax dirs.
    assert handler2._newest_suffix(out_dir) in ("e2", "best")


def test_ema_checkpoint_serves_shadow_resumes_raw(tmp_path):
    """EMA checkpoints store the shadow as "params" (what inference
    loads, reference ModularModelHandlerPyTorch:102-106) PLUS the raw
    optimised weights, so a resume (load_optimiser=True) continues
    from the weights the optimiser moments belong to."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    handler = _make_handler()
    hparams = ExtendedHParams.create_hparams()
    hparams.setattr_no_type_check("ema_decay", 0.5)
    handler.set_ema(hparams)
    # Make shadow and raw params differ.
    handler.params = jax.tree_util.tree_map(lambda p: p + 1.0,
                                            handler.params)
    handler.ema.update(handler.params)
    shadow = handler.ema.shadow
    raw = handler.params
    assert not equal_model(shadow, raw)
    handler.save_checkpoint(str(tmp_path), "m", last=True)

    # Inference load (no optimiser state wanted): gets the shadow —
    # this is how ModularTrainer.init loads for synthesis.
    h_inf = ModularModelHandler()
    h_inf.load_checkpoint(str(tmp_path), "m", last=True,
                          load_optimiser=False)
    assert equal_model(h_inf.params, shadow)

    # Resume load: gets the raw weights back, shadow restored to EMA.
    h_res = _make_handler()
    h_res.set_ema(hparams)
    h_res.load_checkpoint(str(tmp_path), "m", last=True,
                          load_optimiser=True)
    assert equal_model(h_res.params, raw)
    assert equal_model(h_res.ema.shadow, shadow)


def test_frozen_layers_updates_only_unfrozen():
    """hparams.frozen_layers: gradients of matching paths are zeroed
    before clipping/Adam, so frozen parameters stay bit-identical while
    the rest train (transfer-learning freeze, e.g. SSW'19 VTLN
    adaptation: frozen average-voice pre-net + trainable warp layer)."""
    from idiaptts_tpu.utils import serialization

    from idiaptts_tpu.models.losses import NamedLoss

    cfg = convert_legacy_string("RNNDYN-1_RELU_8-1_FC_4", 6)
    cfg.input_names = ("x",)
    cfg.output_names = ("pred",)
    handler = ModularModelHandler()
    rng = np.random.RandomState(0)
    batch = collate_batch([{
        "x": rng.randn(10, 6).astype(np.float32),
        "target": rng.randn(10, 4).astype(np.float32)}])
    handler.create_model(cfg, example_batch=batch)
    hparams = ExtendedHParams.create_hparams()
    hparams.frozen_layers = ["g0_Linear_0"]
    handler.set_optimiser(hparams)
    handler.set_scheduler(hparams)
    handler.set_losses([NamedLoss.Config("l", "MSELoss",
                                         ("pred", "target"))])
    before = serialization.flatten_dict(
        jax.tree_util.tree_map(np.asarray, handler.params), sep="/")
    handler.process_batches([batch], training=True)
    handler.process_batches([batch], training=True)
    after = serialization.flatten_dict(
        jax.tree_util.tree_map(np.asarray, handler.params), sep="/")
    for path in before:
        if "g0_Linear_0" in path:
            np.testing.assert_array_equal(before[path], after[path])
        else:
            assert np.abs(before[path] - after[path]).max() > 0, path
