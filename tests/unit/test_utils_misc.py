"""Tests for misc utils, equality helpers, registry, and new layers."""

import numpy as np
import pytest


def test_equality_utils(tmp_path):
    from idiaptts_tpu.utils import serialization
    from idiaptts_tpu.utils.equality import (equal_checkpoint,
                                             equal_iterable,
                                             equal_model, tensor_pad)
    a = {"w": np.ones((3, 2)), "b": [np.zeros(2)]}
    b = {"w": np.ones((3, 2)), "b": [np.zeros(2)]}
    assert equal_iterable(a, b)
    b["w"] = b["w"] + 1
    assert not equal_iterable(a, b)
    assert equal_model({"l": {"k": np.ones(3)}},
                       {"l": {"k": np.ones(3)}})
    # Checkpoint comparison via files.
    for name, params in [("a", a), ("c", {"w": np.ones((3, 2)),
                                          "b": [np.zeros(2)]})]:
        with open(tmp_path / ("params_" + name), "wb") as f:
            f.write(serialization.msgpack_serialize(
                {"params": params}))
    # a vs a copy with same values
    assert equal_checkpoint(str(tmp_path), "a", str(tmp_path), "a")
    padded = tensor_pad(np.ones((4, 2)), 6)
    assert padded.shape == (6, 2) and padded[4:].sum() == 0


def test_model_registry():
    from idiaptts_tpu.models.registry import create_model_config
    cfg = create_model_config("RNNDYN-1_RELU_8-1_FC_4", 10)
    assert cfg.layer_configs[-1].out_dim == 4
    wn = create_model_config("WaveNet", 10, out_dim=64)
    assert wn.out_channels == 64
    with pytest.raises(NotImplementedError):
        create_model_config("NopeNet", 10)


def test_mask_and_apply_function_layers():
    import jax
    import jax.numpy as jnp
    from idiaptts_tpu.models.rnn_dyn import Config, LayerConfig, RNNDyn
    cfg = Config(in_dim=4, layer_configs=[
        LayerConfig("Linear", out_dim=4),
        LayerConfig("ApplyFunction", out_dim=4, function="Tanh"),
        LayerConfig("Mask", out_dim=4),
    ])
    model = RNNDyn(config=cfg)
    x = jnp.ones((2, 6, 4))
    lengths = jnp.array([6, 3])
    params = model.init(jax.random.PRNGKey(0), x, lengths=lengths)
    out = model.apply(params, x, lengths=lengths)
    assert np.abs(np.asarray(out)).max() <= 1.0  # tanh bound
    assert np.asarray(out)[1, 3:].sum() == 0     # masked padding


def test_misc_utils():
    from idiaptts_tpu.utils.misc import (get_memory_usage_mb,
                                         log_git_hash,
                                         ndarray_to_string,
                                         parse_int_set,
                                         pretty_print_nested)
    assert parse_int_set("0,2-4") == {0, 2, 3, 4}
    assert get_memory_usage_mb() > 10
    assert isinstance(log_git_hash("/root/repo"), str)
    s = pretty_print_nested({"a": np.ones(3), "b": [1, 2]})
    assert "a" in s
    assert "1." in ndarray_to_string(np.ones(2))


def test_remat_layer_group():
    """remat=True on a layer group must not change outputs/grads."""
    import jax
    import jax.numpy as jnp
    from idiaptts_tpu.models.rnn_dyn import Config, LayerConfig, RNNDyn
    x = jnp.asarray(np.random.RandomState(0).randn(2, 8, 6),
                    np.float32)

    def build(remat):
        cfg = Config(in_dim=6, layer_configs=[
            LayerConfig("Linear", out_dim=16, nonlin="ReLU",
                        remat=remat),
            LayerConfig("Linear", out_dim=4),
        ])
        return RNNDyn(config=cfg)

    m1, m2 = build(False), build(True)
    p = m1.init(jax.random.PRNGKey(0), x)
    out1 = m1.apply(p, x)
    out2 = m2.apply(p, x)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out2),
                               atol=1e-6)
    g1 = jax.grad(lambda p: jnp.sum(m1.apply(p, x) ** 2))(p)
    g2 = jax.grad(lambda p: jnp.sum(m2.apply(p, x) ** 2))(p)
    flat1 = jax.tree_util.tree_leaves(g1)
    flat2 = jax.tree_util.tree_leaves(g2)
    for a, b in zip(flat1, flat2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-5)

def test_custom_layer_in_rnn_dyn():
    """Custom layer type embeds an arbitrary module in the stack
    (rnn_dyn/CustomWrapper.py role)."""
    from idiaptts_tpu.models import nn
    import jax
    import jax.numpy as jnp
    from idiaptts_tpu.models.rnn_dyn import Config, LayerConfig, RNNDyn

    class Doubler(nn.Module):
        def __call__(self, x):
            return x * 2.0

    cfg = Config(in_dim=4, layer_configs=[
        LayerConfig("Custom", out_dim=4, module=Doubler),
        LayerConfig("Linear", out_dim=3),
    ])
    model = RNNDyn(config=cfg)
    x = jnp.ones((2, 5, 4))
    params = model.init(jax.random.PRNGKey(0), x)
    out = model.apply(params, x)
    assert out.shape == (2, 5, 3)
    # Missing module raises a clear error.
    bad = RNNDyn(config=Config(in_dim=4, layer_configs=[
        LayerConfig("Custom", out_dim=4)]))
    import pytest
    with pytest.raises(ValueError, match="Custom layer"):
        bad.init(jax.random.PRNGKey(0), x)


def test_convert_to_npz(tmp_path):
    from idiaptts_tpu.data.convert_to_npz import convert_dir
    from idiaptts_tpu.data.reader import NpzDataReader
    rng = np.random.RandomState(0)
    data = {}
    for i in range(3):
        arr = rng.randn(40, 5).astype(np.float32)
        arr.tofile(str(tmp_path / ("utt%d.feat" % i)))
        data["utt%d" % i] = arr
    written = convert_dir(str(tmp_path), "feat", dim=5)
    assert len(written) == 3
    reader = NpzDataReader(NpzDataReader.Config(
        name="feat", directory=str(tmp_path),
        norm_type=NpzDataReader.Config.NormType.NONE))
    np.testing.assert_allclose(reader.load("utt1"), data["utt1"])
    # Size not divisible by dim is skipped, not crashed.
    np.ones(7, np.float32).tofile(str(tmp_path / "bad.feat"))
    written = convert_dir(str(tmp_path), "feat", dim=5)
    assert not any("bad" in w for w in written) or len(written) == 3

def test_small_utils():
    from idiaptts_tpu.utils.misc import (local_modification_time, ncr,
                                         pretty_print_decimal_places,
                                         select_skip)
    # select 2, skip 3 pattern over 0..9 -> 0,1,5,6
    assert select_skip(range(10), 2, 3) == [0, 1, 5, 6]
    assert select_skip(range(10), 2, 3, start_index=1) == [1, 2, 6, 7]
    assert ncr(5, 2) == 10
    assert pretty_print_decimal_places(0.002) == "002"
    import re
    assert re.match(r"\d{4}-\d{2}-\d{2} ",
                    local_modification_time("/root/repo/README.md"))


def test_input_to_str_list_and_split_return_values(tmp_path):
    """Reference-surface helpers: flexible id input parsing
    (ModularTrainer.py:794-812) and batched-output splitting
    (:127-186), mirroring the reference's unit tests."""
    import numpy as np
    from idiaptts_tpu.train.trainer import ModularTrainer

    # Tuple of non-strings -> list of strings.
    assert ModularTrainer._input_to_str_list((121, 122)) == ["121",
                                                             "122"]
    # Path to a file id list.
    p = tmp_path / "ids.txt"
    p.write_text("a\nb \n c\n")
    assert ModularTrainer._input_to_str_list(str(p)) == ["a", "b", "c"]
    # Single id.
    assert ModularTrainer._input_to_str_list("121") == ["121"]
    # Wrong input raises.
    import pytest
    with pytest.raises(ValueError):
        ModularTrainer._input_to_str_list(np.array([1, 2]))

    # split_return_values: batched array -> trimmed per-utterance list.
    batched = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    out = ModularTrainer._split_return_values(
        batched, np.array([5, 3]), batch_first=True)
    assert len(out) == 2
    assert out[0].shape == (5, 3) and out[1].shape == (3, 3)
    np.testing.assert_array_equal(out[1], batched[1, :3])
    # Time-major variant.
    out_tm = ModularTrainer._split_return_values(
        np.moveaxis(batched, 0, 1), np.array([5, 3]), batch_first=False)
    np.testing.assert_array_equal(out_tm[0], out[0])
    # Singleton batch still trims (this repo's collate pads to bucket
    # lengths even for one sample, unlike the reference's max-in-batch).
    out_1 = ModularTrainer._split_return_values(
        batched[:1], np.array([3]), batch_first=True)
    assert out_1[0].shape == (3, 3)
    # Nested tuple with None entries (bidirectional hidden-state shape).
    nested = (batched, None)
    out_n = ModularTrainer._split_return_values(
        nested, np.array([5, 3]), batch_first=True)
    assert isinstance(out_n, tuple) and len(out_n) == 2
    assert out_n[0][1] is None
    np.testing.assert_array_equal(out_n[1][0], batched[1, :3])
    # An all-None tuple BEFORE the array must not poison the batch size.
    out_nn = ModularTrainer._split_return_values(
        ((None, None), batched), np.array([5, 5, 5][:2]),
        batch_first=True)
    assert len(out_nn) == 2 and out_nn[0][0] == (None, None)
    # Permutation unsorts back to original order.
    out_p = ModularTrainer._split_return_values(
        batched, np.array([5, 5]), permutation=[1, 0], batch_first=True)
    np.testing.assert_array_equal(out_p[0], batched[1])
    # split_batch dict front door.
    d = ModularTrainer.split_batch(
        {"x": batched}, {"x": np.array([5, 3])})
    assert d["x"][1].shape == (3, 3)
