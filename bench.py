"""Benchmark of the label->waveform synthesis path on one GPU.

Measures, on the device JAX runs on (it refuses anything but a GPU):

- ``synthesis``: the fused label->wav program (Interspeech'18 acoustic
  model at full width, 409 question inputs, random weights from a seed
  -> denormalisation -> MLPG -> mcep decode -> WORLD synthesis) at
  B=9 and B=72 utterances of T=2048 frames, with the MLPG substitutions
  as the Triton kernel and as plain scans, in the order plain, kernel,
  kernel, plain;
- ``stages``: the model, MLPG (both ways) and vocoder stages at B=9;
- ``training`` / ``forward``: the acoustic train step at B=32, T=1024
  and the forward at B=9, T=2048;
- ``wavenet``: full-size WaveNet generation at B=1, 16, 64;
- ``synth``: ``trainer.synth`` on the committed fixture corpus.

Every time is the median of several calls that end in
``block_until_ready``; the first call of each shape (compilation) is
reported apart.  The parent process stays off JAX and runs one worker;
a failing stage fails the run.  Prints one JSON line; ``--out PATH``
also writes it to a file.
"""

import json
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

FS = 16000
NUM_SPS = 20
NUM_QUESTIONS = 409


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0].strip()


def _variances():
    import numpy as np

    from idiaptts_tpu.data.normalisation import MeanCovarianceExtractor

    def diag(name):
        _, cov = MeanCovarianceExtractor.load(os.path.join(
            _REPO, "tests", "fixtures", "WORLD", "cmp_mcep20",
            name + "-mean-covariance.npz"))
        return np.ascontiguousarray(np.diagonal(cov))

    return {"sp": diag("mcep20"), "lf0": diag("lf0"), "bap": diag("bap")}


def synthesis_numbers(batches=(9, 72), T=2048, runs=5):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench_training import _median_time
    from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
    from idiaptts_tpu.synth.pipeline import FusedAcousticPipeline

    cfg = convert_legacy_string(
        "RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_67", NUM_QUESTIONS)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred",)
    model = cfg.create_model()
    rs = np.random.RandomState(0)
    params = model.init({"params": jax.random.PRNGKey(0)},
                        {"questions": jnp.zeros((1, 16, NUM_QUESTIONS))},
                        lengths=jnp.array([16]), training=False)

    def model_apply(params, questions_b, lengths_b):
        return model.apply(params, {"questions": questions_b},
                           lengths=lengths_b, training=False)["pred"]

    variances = _variances()
    pipelines = {k: FusedAcousticPipeline(model_apply, variances,
                                          num_coded_sps=NUM_SPS, fs=FS,
                                          mlpg_kernel=k)
                 for k in (False, True)}
    result = {"T": T}
    for B in batches:
        questions = jnp.asarray(
            (rs.rand(B, T, NUM_QUESTIONS) > 0.9).astype(np.float32))
        lengths = jnp.full((B,), T, jnp.int32)
        audio_s = B * T * 0.005
        entry = {}
        for kernel in (False, True, True, False):
            pipe = pipelines[kernel]
            name = "mlpg_kernel" if kernel else "mlpg_scan"

            def call(pipe=pipe):
                pipe(params, questions, lengths,
                     device_output=True).block_until_ready()

            if name not in entry:
                t0 = time.perf_counter()
                call()
                entry[name] = {"first_call_s": round(
                    time.perf_counter() - t0, 2), "ms": []}
            entry[name]["ms"].append(round(_median_time(call, runs) * 1e3,
                                           3))
        for name in entry:
            ms = float(np.median(entry[name]["ms"]))
            entry[name]["x_realtime"] = round(audio_s / (ms / 1e3), 2)
        result["B{}".format(B)] = entry
        if B == batches[0]:
            result["stages_B{}".format(B)] = _stage_numbers(
                pipelines, params, questions, lengths, runs)
    return result


def _stage_numbers(pipelines, params, questions, lengths, runs):
    import jax

    from bench_training import _median_time

    B, T = questions.shape[:2]
    out = {}
    for kernel, pipe in pipelines.items():
        model_j, mlpg_j, vocoder_j = pipe.stage_jits()
        factors, tau = pipe._factors_for(T)
        f0_cont = pipe._default_f0_cont(B, T)
        key = jax.random.PRNGKey(0)
        pred = model_j(params, questions, lengths).block_until_ready()
        smoothed, vuv = mlpg_j(pred, lengths, factors, tau)
        smoothed.block_until_ready()
        vocoder_j(smoothed, vuv, f0_cont, key).block_until_ready()
        name = "mlpg_kernel_ms" if kernel else "mlpg_scan_ms"
        out[name] = round(_median_time(
            lambda: mlpg_j(pred, lengths, factors, tau)[0]
            .block_until_ready(), runs) * 1e3, 3)
        if not kernel:
            out["model_ms"] = round(_median_time(
                lambda: model_j(params, questions, lengths)
                .block_until_ready(), runs) * 1e3, 3)
            out["vocoder_ms"] = round(_median_time(
                lambda: vocoder_j(smoothed, vuv, f0_cont, key)
                .block_until_ready(), runs) * 1e3, 3)
    return out


def _worker(out_path):
    import jax

    import bench_training
    from idiaptts_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("bench: JAX runs on {!r}, not a GPU".format(
            dev.platform))
    enable_compile_cache()
    t0 = time.time()
    detail = {
        "synthesis": synthesis_numbers(),
        "training": bench_training.training_numbers(B=32, T=1024),
        "forward": bench_training.forward_numbers(B=9, T=2048),
        "wavenet": bench_training.wavenet_numbers(),
        "synth": bench_training.ref_surface_numbers(),
    }
    line = {"metric": "label->wav synthesis, B=9 T=2048",
            "value": detail["synthesis"]["B9"]["mlpg_kernel"][
                "x_realtime"],
            "unit": "x realtime",
            "card": _card(),
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "seconds": round(time.time() - t0, 1),
            "detail": detail}
    text = json.dumps(line)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)


def main(argv):
    out_path = None
    if "--out" in argv:
        out_path = argv[argv.index("--out") + 1]
    if "--worker" in argv:
        _worker(out_path)
        return 0
    args = [sys.executable, os.path.abspath(__file__), "--worker"]
    if out_path:
        args += ["--out", out_path]
    return subprocess.run(args, check=False).returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
