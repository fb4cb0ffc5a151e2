"""The ``lax.scan`` WaveNet generator: teacher-forced logits equal the
parallel net across ring-buffer wrap-around, greedy sampling is the
argmax, free-running output stays in range."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from idiaptts_tpu.models.wavenet import (WaveNetWrapper, _dilations,
                                         _generate_scan_jit, generate,
                                         teacher_forced_logits)

C = 23


def _setup(B, T, num_layers=6, seed=0):
    # 6 layers in 2 stacks: dilations 1, 2, 4 -> rings of 2, 3, 5 slots,
    # which a 40-step sequence wraps many times.
    cfg = WaveNetWrapper.Config(input_names=("cond",),
                                output_names=("logits",),
                                target_name="target", out_channels=64,
                                residual_channels=16, gate_channels=32,
                                skip_channels=16, num_layers=num_layers,
                                num_stacks=2)
    rs = np.random.RandomState(seed)
    cond = jnp.asarray(rs.randn(B, T, C).astype(np.float32) * 0.3)
    target = jnp.asarray(rs.randint(0, cfg.out_channels, (B, T)),
                         jnp.int32)
    model = cfg.create_model()
    params = model.init(jax.random.PRNGKey(seed),
                        {"cond": cond, "target": target})
    return cfg, model, params, cond, target


@pytest.mark.parametrize("B", [1, 3, 8])
def test_forced_logits_match_parallel_net(B):
    cfg, model, params, cond, target = _setup(B, 40, seed=B)
    parallel = np.asarray(model.apply(
        params, {"cond": cond, "target": target})["logits"])
    forced = np.asarray(teacher_forced_logits(params, cfg, cond, target))
    assert forced.shape == parallel.shape == (B, 40, cfg.out_channels)
    # bf16 parallel net vs float32 generator.
    assert np.abs(forced - parallel).max() < 0.02 * np.abs(parallel).max()
    assert np.corrcoef(forced.ravel(), parallel.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("B", [1, 4])
def test_greedy_equals_argmax_of_logits(B):
    cfg, _, params, cond, _ = _setup(B, 30, seed=10 + B)
    samples, logits = _generate_scan_jit(
        params["params"]["wavenet"], _dilations(cfg), cfg, cond,
        jax.random.PRNGKey(0), 0.0, want_logits=True)
    np.testing.assert_array_equal(np.asarray(samples),
                                  np.argmax(np.asarray(logits), axis=-1))


@pytest.mark.parametrize("B", [1, 5])
def test_free_run_output_in_range(B):
    cfg, _, params, cond, _ = _setup(B, 60, seed=20 + B)
    wav = np.asarray(generate(params, cfg, cond,
                              rng=jax.random.PRNGKey(3)))
    assert wav.shape == (B, 60)
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    # Near-uniform random-init logits must not collapse to a constant.
    assert len(np.unique(wav)) > 5


def test_single_utterance_conditioning():
    cfg, _, params, cond, _ = _setup(1, 25, seed=30)
    wav = generate(params, cfg, cond[0], rng=jax.random.PRNGKey(1))
    batched = generate(params, cfg, cond, rng=jax.random.PRNGKey(1))
    assert wav.shape == (25,)
    np.testing.assert_array_equal(wav, np.asarray(batched)[0])
