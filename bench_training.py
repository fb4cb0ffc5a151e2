"""Secondary benchmark: acoustic-model training and WaveNet generation.

``bench.py`` reports the label->wav synthesis path; this module the
training side (full jit train step of the Interspeech'18 acoustic
architecture: forward, masked MSE, grads, adam update), the plain
acoustic forward, autoregressive WaveNet generation and the
reference-surface ``trainer.synth``.  The measurement bodies return
dicts so ``bench.py`` can embed them in its JSON line; ``main`` prints
one JSON line per metric for standalone use.  Every time is taken with
``block_until_ready`` on the device the run reports.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
_FIXTURES = os.path.join(_REPO, "tests", "fixtures")


def _median_time(fn, runs):
    """Median wall time of ``fn()`` (which must block on its result)."""
    samples = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples))


def acoustic_flops_per_frame(d_in=409, d_out=67, ff=1024, f=512):
    """Forward matmul FLOPs per frame of ``2_RELU_ff-3_BiLSTM_f-1_FC``:
    dense layers 2*in*out; each BiLSTM direction a projection
    2*in*4f and a recurrence 2*f*4f."""
    return (2 * (d_in * ff + ff * ff)
            + 2 * (2 * ff * 4 * f + 2 * f * 4 * f)
            + 2 * 2 * (2 * 2 * f * 4 * f + 2 * f * 4 * f)
            + 2 * 2 * f * d_out)


def _acoustic_setup(B, T, D_in=409, D_out=67):
    import jax
    import jax.numpy as jnp

    from idiaptts_tpu.models.rnn_dyn import convert_legacy_string

    cfg = convert_legacy_string(
        "RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_{}".format(D_out), D_in)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred",)
    model = cfg.create_model()
    x = jnp.asarray(np.random.RandomState(0).randn(B, T, D_in),
                    jnp.float32)
    y = jnp.asarray(np.random.RandomState(1).randn(B, T, D_out),
                    jnp.float32)
    lengths = jnp.full((B,), T, jnp.int32)
    params = model.init({"params": jax.random.PRNGKey(0)},
                        {"questions": x[:1]}, lengths=lengths[:1],
                        training=True)
    return model, params, x, y, lengths


def forward_numbers(B=9, T=2048, runs=10):
    """Forward frames/s of the Interspeech'18 acoustic architecture
    (plain ``lax.scan`` BiLSTMs, the serving model stage) at batch
    ``B``, bucket ``T``."""
    import jax

    model, params, x, _, lengths = _acoustic_setup(B, T)

    @jax.jit
    def forward(params, x, lengths):
        return model.apply(params, {"questions": x}, lengths=lengths,
                           training=False)["pred"]

    t0 = time.perf_counter()
    forward(params, x, lengths).block_until_ready()
    first = time.perf_counter() - t0
    fwd_s = _median_time(
        lambda: forward(params, x, lengths).block_until_ready(), runs)
    flops = acoustic_flops_per_frame()
    return {"batch": B, "bucket_T": T,
            "forward_ms": round(fwd_s * 1e3, 3),
            "forward_frames_per_s": round(B * T / fwd_s),
            "forward_tflop_per_s": round(flops * B * T / fwd_s / 1e12, 3),
            "first_call_s": round(first, 2)}


def training_numbers(B=32, T=1024, runs=10):
    """Train-step frames/s of the Interspeech'18 acoustic architecture
    (plain ``lax.scan`` BiLSTMs) at batch ``B``, bucket ``T``."""
    import jax
    import jax.numpy as jnp
    import optax

    model, params, x, y, lengths = _acoustic_setup(B, T)
    optimiser = optax.adam(1e-3)
    opt_state = optimiser.init(params)

    @jax.jit
    def train_step(params, opt_state, x, y, lengths):
        def loss_fn(p):
            out = model.apply(p, {"questions": x}, lengths=lengths,
                              training=False)["pred"]
            return jnp.mean((out - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimiser.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    state = [params, opt_state]

    def step():
        state[0], state[1], loss = train_step(state[0], state[1], x, y,
                                              lengths)
        loss.block_until_ready()

    t0 = time.perf_counter()
    step()
    first = time.perf_counter() - t0
    train_s = _median_time(step, runs)
    flops = acoustic_flops_per_frame()
    return {"batch": B, "bucket_T": T,
            "train_step_ms": round(train_s * 1e3, 3),
            "train_frames_per_s": round(B * T / train_s),
            "train_tflop_per_s": round(3 * flops * B * T / train_s / 1e12,
                                       3),
            "first_call_s": round(first, 2)}


def wavenet_numbers(batches=(1, 16, 64), seconds=0.5, runs=3):
    """Autoregressive generation of the full-size WaveNet (20 layers,
    64/128/64 channels, 256-way mu-law) through the public
    ``generate()``: seconds per call and aggregate x realtime
    (B * seconds of audio / elapsed) at each batch size."""
    import jax
    import jax.numpy as jnp

    from idiaptts_tpu.models.wavenet import WaveNetWrapper, generate

    cfg = WaveNetWrapper.Config(input_names=("cond",),
                                output_names=("logits",),
                                target_name="target")
    T, C = int(16000 * seconds), 63
    base = jnp.asarray(np.random.RandomState(0)
                       .randn(1, T, C).astype(np.float32) * 0.1)
    params = cfg.create_model().init(
        jax.random.PRNGKey(0),
        {"cond": base[:, :16], "target": jnp.zeros((1, 16), jnp.int32)})
    results = {"samples": T}
    for B in batches:
        cond = jnp.tile(base, (B, 1, 1))
        t0 = time.perf_counter()
        generate(params, cfg, cond, rng=jax.random.PRNGKey(1),
                 device_output=True).block_until_ready()
        first = time.perf_counter() - t0
        elapsed = _median_time(
            lambda: generate(params, cfg, cond, rng=jax.random.PRNGKey(2),
                             device_output=True).block_until_ready(),
            runs)
        results["B{}".format(B)] = {
            "generate_s": round(elapsed, 4),
            "step_us": round(elapsed / T * 1e6, 2),
            "x_realtime": round(B * seconds / elapsed, 3),
            "first_call_s": round(first, 2)}
    return results


def ref_surface_numbers(runs=5):
    """``trainer.synth`` through the reference-surface API (fused
    model+MLPG+vocoder program plus wav writing) on the committed
    fixture corpus, with an untrained full-width Interspeech'18 model:
    the number a user of trainer.synth sees."""
    from idiaptts_tpu.data.questions import QuestionSet
    from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
    from idiaptts_tpu.ops.audio_io import get_raw
    from idiaptts_tpu.train.acoustic import AcousticModelTrainer

    num_questions = QuestionSet(os.path.join(
        _FIXTURES, "questions-gen_dnn.hed")).dict_size + 9
    with open(os.path.join(_FIXTURES, "file_id_list.txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    with tempfile.TemporaryDirectory(prefix="bench_synth_") as tmp:
        hparams = AcousticModelTrainer.create_hparams()
        hparams.num_questions = num_questions
        hparams.num_coded_sps = 20
        hparams.out_dir = tmp
        hparams.model_name = "bench"
        hparams.epochs = 0
        hparams.seed = 1
        hparams.test_set_perc = 0.0
        hparams.val_set_perc = 0.0
        hparams.use_best_as_final_model = False
        hparams.synth_fs = 16000
        hparams.synth_dir = os.path.join(tmp, "wavs")
        trainer = AcousticModelTrainer(
            hparams, ids,
            dir_question_labels=os.path.join(_FIXTURES, "questions"),
            dir_world_features=os.path.join(_FIXTURES, "WORLD"))
        cfg = convert_legacy_string(
            "RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_67", num_questions)
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred_acoustic_features",)
        trainer.init(hparams, model_config=cfg)
        paths = trainer.synth(hparams, ids)      # compile
        elapsed = _median_time(lambda: trainer.synth(hparams, ids), runs)
        audio_seconds = sum(len(get_raw(p)[0]) / 16000.0
                            for p in paths.values())
    return {"synth_x_realtime": round(audio_seconds / elapsed, 3),
            "synth_s": round(elapsed, 4),
            "audio_seconds": round(audio_seconds, 3),
            "utterances": len(ids)}


def main():
    from idiaptts_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    for name, fn in (("acoustic training", training_numbers),
                     ("acoustic forward", forward_numbers),
                     ("wavenet generation", wavenet_numbers),
                     ("trainer.synth", ref_surface_numbers)):
        print(json.dumps({"metric": name, "detail": fn()}), flush=True)


if __name__ == "__main__":
    main()
