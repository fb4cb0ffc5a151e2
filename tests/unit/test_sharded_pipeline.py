import numpy as np


def test_sharded_serving_pipeline_matches_single_device():
    """FusedAcousticPipeline over an 8-device data mesh: the batch
    shards over chips, each synthesises its shard, outputs equal the
    unsharded run."""
    import jax
    import jax.numpy as jnp
    from idiaptts_tpu.parallel.mesh import make_data_mesh
    from idiaptts_tpu.synth.pipeline import FusedAcousticPipeline

    if len(jax.devices()) < 8:
        import pytest
        pytest.skip("needs 8 devices")
    D, NB, nq = 20, 1, 33
    rng = np.random.RandomState(0)
    W = jnp.asarray(rng.randn(nq, 3 * (D + 1 + NB) + 1) * 0.01,
                    jnp.float32)

    def model_apply(params, q, lengths):
        return q @ params["W"]

    variances = {"sp": np.abs(rng.randn(3 * D)) + 0.1,
                 "lf0": np.abs(rng.randn(3)) + 0.1,
                 "bap": np.abs(rng.randn(3 * NB)) + 0.1}
    questions = [rng.randn(100 + 10 * i, nq).astype(np.float32)
                 for i in range(8)]
    params = {"W": W}

    plain = FusedAcousticPipeline(model_apply, variances,
                                  num_coded_sps=D, fs=16000)
    mesh = make_data_mesh(8)
    sharded = FusedAcousticPipeline(model_apply, variances,
                                    num_coded_sps=D, fs=16000,
                                    mesh=mesh)
    out_plain = plain(params, questions)
    out_sharded = sharded(params, questions)
    assert len(out_plain) == len(out_sharded) == 8
    for a, b in zip(out_plain, out_sharded):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_padded_tail_is_silent():
    """Zero-padded tail frames must not synthesise audio: all-zero
    features decode to a FULL-SCALE aperiodic frame (mcep c=0 ->
    amplitude 1, bap 0 -> ap 1) whose noise previously bled into the
    valid tail through the overlap-add window, drowning quiet signals
    by ~6 orders of magnitude."""
    import numpy as np
    import jax.numpy as jnp
    from idiaptts_tpu.synth.pipeline import (BatchedWorldSynth,
                                             _vocode_one)
    import jax

    rng = np.random.RandomState(0)
    T, D, NB = 229, 20, 1           # bucket-pads to 256
    post = np.zeros((T, D + 2 + NB), np.float32)
    post[:, 0] = -11.87             # very quiet envelope
    post[:, 1:D] = rng.randn(T, D - 1) * 0.3
    post[:, D] = 5.24
    post[:, D + 2] = -6.51
    bws = BatchedWorldSynth(D, 16000)
    w = np.asarray(bws([post])[0])
    # Reference: the unpadded single-frame vocoder on the same features.
    ref = np.asarray(_vocode_one(
        jnp.asarray(post[:, :D]), jnp.asarray(post[:, D]),
        jnp.zeros((T,), bool), jnp.asarray(post[:, D + 2:D + 2 + NB]),
        jnp.full((T,), 150.0), jax.random.PRNGKey(0),
        16000, 80, 513, 0.41, 112))
    assert np.abs(w).max() < 10 * max(np.abs(ref).max(), 1e-12), (
        np.abs(w).max(), np.abs(ref).max())


def test_pcm16_packed_path_matches_float_path():
    """The packed-transfer pcm16 surface (concatenated un-padded
    frames h2d, padded batch rebuilt on device, loudness-norm + int16
    encode in the jit) must reproduce the float path + host-side
    normalisation/quantisation exactly (CPU keeps f32 transfer, so the
    rebuild is bit-identical)."""
    import jax.numpy as jnp
    from idiaptts_tpu.synth.pipeline import FusedAcousticPipeline

    D, NB, nq = 20, 1, 33
    rng = np.random.RandomState(1)
    W = jnp.asarray(rng.randn(nq, 3 * (D + 1 + NB) + 1) * 0.01,
                    jnp.float32)

    def model_apply(params, q, lengths):
        return q @ params["W"]

    variances = {"sp": np.abs(rng.randn(3 * D)) + 0.1,
                 "lf0": np.abs(rng.randn(3)) + 0.1,
                 "bap": np.abs(rng.randn(3 * NB)) + 0.1}
    # 5 utterances: exercises the two-group pipelined dispatch
    # (B >= 4 splits 3 + 2).
    questions = [rng.randn(90 + 17 * i, nq).astype(np.float32)
                 for i in range(5)]
    params = {"W": W}
    pipeline = FusedAcousticPipeline(model_apply, variances,
                                     num_coded_sps=D, fs=16000)
    assert pipeline.pack_bits       # the same on every backend

    floats = pipeline(params, questions, seed=3)
    pcms = pipeline(params, questions, seed=3, pcm16=True)
    assert len(pcms) == len(floats) == 5
    for f, p in zip(floats, pcms):
        assert p.dtype == np.int16 and len(p) == len(f)
        peak = np.abs(f).max()
        ref = f / peak * 0.85 if peak > 0.85 else f
        want = (np.clip(ref, -1.0, 1.0) * 32767.0).astype(np.int16)
        # 1 LSB slack: host/device float rounding at the int16 cast
        # boundary (the documented pcm16 contract).
        np.testing.assert_allclose(p.astype(np.int32),
                                   want.astype(np.int32), atol=1)


def test_pcm16_bit_packed_path_is_exact():
    """The bit-packed question transfer (two-valued columns shipped
    1 bit/value + per-column (lo, hi); numeric columns f32) must be
    EXACT vs the dense-f32 pcm16 path — reconstruction is a select
    between the original float values, so the int16 waveforms are
    bit-identical."""
    import jax.numpy as jnp
    from idiaptts_tpu.synth.pipeline import FusedAcousticPipeline

    D, NB, nq = 20, 1, 41
    rng = np.random.RandomState(7)
    W = jnp.asarray(rng.randn(nq, 3 * (D + 1 + NB) + 1) * 0.01,
                    jnp.float32)

    def model_apply(params, q, lengths):
        return q @ params["W"]

    variances = {"sp": np.abs(rng.randn(3 * D)) + 0.1,
                 "lf0": np.abs(rng.randn(3)) + 0.1,
                 "bap": np.abs(rng.randn(3 * NB)) + 0.1}
    # 32 two-valued "question" columns (normalised binary: arbitrary
    # lo/hi per column, incl. a constant column) + 9 numeric columns.
    questions = []
    lo = rng.randn(32).astype(np.float32)
    hi = lo + np.abs(rng.randn(32)).astype(np.float32)
    hi[3] = lo[3]                                    # constant column
    for i in range(4):
        T = 70 + 13 * i
        bits = rng.randint(0, 2, (T, 32))
        q = np.concatenate([
            np.where(bits, hi[None, :], lo[None, :]),
            rng.randn(T, 9)], axis=1).astype(np.float32)
        questions.append(q)
    params = {"W": W}
    pipeline = FusedAcousticPipeline(model_apply, variances,
                                     num_coded_sps=D, fs=16000)
    assert pipeline.pack_bits              # default on every backend
    packed = pipeline(params, questions, seed=5, pcm16=True)
    pipeline.pack_bits = False
    dense = pipeline(params, questions, seed=5, pcm16=True)
    for d, p in zip(dense, packed):
        np.testing.assert_array_equal(d, p)
