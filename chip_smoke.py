#!/usr/bin/env python3
"""Smoke test of the system on one NVIDIA GPU.

    python chip_smoke.py           # one GPU: phases 1-6 below
    python chip_smoke.py --four    # four GPUs: data-parallel training
                                   # and sharded serving only

Phases (one process, one card, committed fixture corpus):

1. device: JAX must run on a GPU; there is no CPU fallback.
2. kernels: the MLPG Triton kernel at real widths against float64
   ``mlpg_numpy`` (scipy).
3. train: ``AcousticModelTrainer`` with the Interspeech'18 acoustic
   model at full width; the loss must be finite and fall.
4. serve: ``trainer.synth`` writes wavs, ``trainer.serve`` answers
   concurrent requests, and the fused label->wav program agrees with
   the same program run on the CPU.
5. wavenet: full-size WaveNet generation at B=1 and B=16, and
   teacher-forced logits of the generator against the parallel net.
6. world: ``WorldFeatLabelGen.gen_data`` on a 16 kHz and a 48 kHz wav
   against features extracted on the CPU.

Each phase prints one JSON line naming the card and its power limit;
any failure raises and the script exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
ACOUSTIC_MODEL = "RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_67"
NUM_CODED_SPS = 20

# Tolerances, each with its reason.
# MLPG in float32 (factor and solve) vs scipy's float64 solve: the
# factor's rounding error grows with T; relative to the trajectory's
# scale this stays near 1e-5 at T=2048 for the fixture variances.
MLPG_REL_TOL = 1e-4
# GPU vs CPU runs of one program: the model's matmuls take bf16
# operands (8 significant bits) with sums in another order, and float32
# matmuls may run in TF32 on the GPU.  Relative L2 error of the model
# and MLPG outputs within 3e-2; waveforms are compared by their frame
# energy envelope, as a voicing flip or a tiny F0 difference moves the
# phase of every later sample.
GPU_CPU_REL_TOL = 3e-2
ENVELOPE_CORR_MIN = 0.98
# WaveNet: the parallel net runs in bf16, the generator in float32.
WAVENET_LOGIT_TOL = 0.02          # max |diff| / max |logit|
# WORLD analysis on GPU vs CPU: FFT rounding can move an F0 candidate
# or a voicing decision on a few frames.
WORLD_VUV_AGREE_MIN = 0.98
WORLD_LF0_RMSE_MAX = 0.02         # log Hz, frames voiced in both
WORLD_MCD_MAX_DB = 0.5
# The committed features come from an earlier revision of the
# extractor: on a CPU today 219 of gen-0001's 229 frames (95.6 %) agree
# on voicing with them, so that comparison allows 5 % more flips.
WORLD_VUV_AGREE_COMMITTED_MIN = 0.93
# Data-parallel training over four cards vs one: relative L2 of the
# parameter update after two SGD steps (bf16 gradient sums in another
# order).
DP_UPDATE_REL_TOL = 2e-2


def card_info():
    """The card as nvidia-smi names it: 'name, power.limit'."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def check_device(jax):
    """Phase 1: refuse anything but a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("chip_smoke: JAX runs on {!r}, not a GPU; "
                         "nothing to test".format(dev.platform))
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


class Reporter:
    def __init__(self, card):
        self.card = card

    def phase(self, name, fn):
        t0 = time.time()
        try:
            result = fn()
        except BaseException as exc:
            print(json.dumps({"phase": name, "ok": False,
                              "card": self.card,
                              "error": "{}: {}".format(
                                  type(exc).__name__, exc)[:2000]}),
                  flush=True)
            raise
        line = {"phase": name, "ok": True, "card": self.card,
                "seconds": round(time.time() - t0, 3)}
        line.update(result or {})
        print(json.dumps(line, default=float), flush=True)
        return result


def _memory(compiled):
    stats = compiled.memory_analysis()
    if stats is None:
        return None
    return {k: int(getattr(stats, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(stats, k)}


def _mlpg_variances():
    from idiaptts_tpu.data.normalisation import MeanCovarianceExtractor
    import numpy as np

    def diag(name):
        _, cov = MeanCovarianceExtractor.load(os.path.join(
            FIXTURES, "WORLD", "cmp_mcep20", name + "-mean-covariance.npz"))
        return np.diagonal(cov)

    sp, lf0, bap = diag("mcep20"), diag("lf0"), diag("bap")
    D = NUM_CODED_SPS
    # Fused MLPG order [statics | deltas | double deltas] over
    # (mcep, lf0, bap), as FusedAcousticPipeline assembles it.
    return np.concatenate([sp[:D], lf0[:1], bap[:1], sp[D:2 * D],
                           lf0[1:2], bap[1:2], sp[2 * D:], lf0[2:],
                           bap[2:]]).astype(np.float32), D + 2


def phase_kernels(T=2048, batches=(9, 72), seed=0):
    """MLPG kernel at real widths vs float64 scipy."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from idiaptts_tpu.ops.mlpg import mlpg_factorise, mlpg_numpy, mlpg_solve

    var, F = _mlpg_variances()
    factors, tau = mlpg_factorise(jnp.asarray(var), F, T)
    rs = np.random.RandomState(seed)
    out = {}
    for B in batches:
        static = np.cumsum(rs.randn(B, T, F) * 0.05, axis=1)
        feats = np.concatenate(
            [static, np.gradient(static, axis=1),
             np.gradient(np.gradient(static, axis=1), axis=1)],
            axis=-1).astype(np.float32)
        feats += rs.randn(*feats.shape).astype(np.float32) * 0.01
        solve = jax.jit(lambda f: mlpg_solve(f, factors, tau, F,
                                             kernel=True))
        compiled = solve.lower(jnp.asarray(feats)).compile()
        got = np.asarray(compiled(jnp.asarray(feats)))
        cov = np.diag(var.astype(np.float64))
        ref = np.stack([mlpg_numpy(feats[b], cov, F) for b in range(B)])
        err = np.abs(got - ref)
        scale = np.abs(ref).max()
        rel = float(err.max() / scale)
        if not np.isfinite(got).all() or rel > MLPG_REL_TOL:
            raise AssertionError("MLPG kernel B={}: max rel err {} > {}"
                                 .format(B, rel, MLPG_REL_TOL))
        out["B{}".format(B)] = {
            "T": T, "lanes": B * F, "max_abs_err": float(err.max()),
            "max_rel_err": rel, "tol_rel": MLPG_REL_TOL,
            "memory": _memory(compiled)}
    return {"mlpg_solve_kernel": out}


def _trainer(out_dir, epochs):
    from idiaptts_tpu.data.questions import QuestionSet
    from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
    from idiaptts_tpu.train.acoustic import AcousticModelTrainer

    num_q = QuestionSet(os.path.join(
        FIXTURES, "questions-gen_dnn.hed")).dict_size + 9
    with open(os.path.join(FIXTURES, "file_id_list.txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    hp = AcousticModelTrainer.create_hparams()
    hp.num_questions = num_q
    hp.num_coded_sps = NUM_CODED_SPS
    hp.out_dir = out_dir
    hp.model_name = "smoke"
    hp.epochs = epochs
    hp.batch_size_train = 2
    hp.batch_size_val = 6
    hp.batch_size_synth = 6
    hp.learning_rate = 2e-3
    hp.seed = 1
    hp.use_best_as_final_model = False
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.0
    hp.synth_fs = 16000
    hp.synth_dir = os.path.join(out_dir, "wav")
    trainer = AcousticModelTrainer(
        hp, ids, dir_question_labels=os.path.join(FIXTURES, "questions"),
        dir_world_features=os.path.join(FIXTURES, "WORLD"))
    cfg = convert_legacy_string(ACOUSTIC_MODEL, num_q)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_acoustic_features",)
    trainer.init(hp, model_config=cfg)
    return trainer, hp, ids


def phase_train(state, out_dir):
    import numpy as np

    # Enough steps that the model speaks: an untrained one predicts
    # near-silence, which would make the synthesis checks vacuous.
    trainer, hp, ids = _trainer(out_dir, epochs=20)
    _, losses = trainer.train(hp)
    losses = [float(x) for x in losses]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("training loss did not fall: {}".format(
            losses))
    state.update(trainer=trainer, hp=hp, ids=ids)
    return {"model": ACOUSTIC_MODEL, "inputs": hp.num_questions,
            "train_utterances": len(trainer.id_list_train),
            "epoch_losses": losses}


def _envelope(wav, hop=80):
    import numpy as np
    n = len(wav) // hop
    frames = np.asarray(wav[:n * hop], np.float64).reshape(n, hop)
    return np.log(np.sqrt((frames ** 2).mean(axis=1)) + 1e-5)


def _rel_l2(a, b):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def phase_serve(state):
    import jax
    import numpy as np

    from idiaptts_tpu.ops.audio_io import get_raw

    trainer, hp, ids = state["trainer"], state["hp"], state["ids"]
    paths = trainer.synth(hp, ids)
    for path in paths.values():
        raw, fs = get_raw(path)
        if not (fs == 16000 and len(raw) > fs / 2
                and 1e-4 < np.abs(raw).max() <= 1.0):
            raise AssertionError("trivial synth output " + path)

    server = trainer.serve(hp, max_batch=4, max_wait_ms=20.0)
    try:
        _, _, load_inputs = trainer.build_serving(hp)
        hop = int(hp.synth_fs * hp.frame_size_ms / 1000)
        futures = [(i, server.submit(load_inputs(i))) for i in ids]
        for id_name, fut in futures:
            wav = fut.result(timeout=600)
            if len(wav) != len(load_inputs(id_name)) * hop \
                    or not np.isfinite(wav).all():
                raise AssertionError("bad served wav " + id_name)
        stats = server.stats()
    finally:
        server.shutdown()

    # The fused program on the GPU vs the same program on the CPU.
    pipeline, params, load_inputs = trainer.build_serving(hp)
    questions = [load_inputs(i) for i in ids]
    stages_gpu = _fused_stages(pipeline, params, questions)
    cpu = jax.devices("cpu")[0]
    trainer._fused_pipelines = {}
    with jax.default_device(cpu):
        pipeline_cpu, _, _ = trainer.build_serving(hp)
        params_cpu = jax.device_put(params, cpu)
        stages_cpu = _fused_stages(pipeline_cpu, params_cpu, questions)
    trainer._fused_pipelines = {}
    errs = {"model_rel_l2": _rel_l2(stages_gpu[0], stages_cpu[0]),
            "mlpg_rel_l2": _rel_l2(stages_gpu[1], stages_cpu[1])}
    corr = []
    for a, b in zip(stages_gpu[2], stages_cpu[2]):
        if len(a) != len(b) or not np.isfinite(a).all():
            raise AssertionError("fused wav length/finiteness")
        corr.append(float(np.corrcoef(_envelope(a), _envelope(b))[0, 1]))
    errs["envelope_corr_min"] = min(corr)
    if errs["model_rel_l2"] > GPU_CPU_REL_TOL \
            or errs["mlpg_rel_l2"] > GPU_CPU_REL_TOL \
            or errs["envelope_corr_min"] < ENVELOPE_CORR_MIN:
        raise AssertionError("GPU vs CPU fused program: {}".format(errs))
    return {"synth_wavs": len(paths), "served": stats["requests"],
            "server_batches": stats["batches"], "gpu_vs_cpu": errs,
            "tol_rel_l2": GPU_CPU_REL_TOL,
            "tol_envelope_corr": ENVELOPE_CORR_MIN}


def _fused_stages(pipeline, params, questions):
    """Model output, MLPG output and trimmed waveforms of the fused
    program on one padded batch."""
    import jax.numpy as jnp
    import numpy as np

    lengths = np.array([len(q) for q in questions], np.int32)
    T = int(np.ceil(lengths.max() / pipeline.bucket) * pipeline.bucket)
    batch = np.zeros((len(questions), T, questions[0].shape[1]),
                     np.float32)
    for i, q in enumerate(questions):
        batch[i, :len(q)] = q
    model_j, mlpg_j, _ = pipeline.stage_jits()
    factors, tau = pipeline._factors_for(T)
    out = model_j(params, jnp.asarray(batch), jnp.asarray(lengths))
    smoothed, _ = mlpg_j(out, jnp.asarray(lengths), factors, tau)
    wavs = pipeline(params, questions, seed=0)
    mask = (np.arange(T)[None, :] < lengths[:, None])[..., None]
    return (np.asarray(out) * mask, np.asarray(smoothed) * mask, wavs)


def phase_wavenet(seconds=0.25, batches=(1, 16)):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from idiaptts_tpu.models.wavenet import (WaveNetWrapper, generate,
                                             teacher_forced_logits)

    cfg = WaveNetWrapper.Config(input_names=("cond",),
                                output_names=("logits",),
                                target_name="target")
    model = cfg.create_model()
    C = 63
    rs = np.random.RandomState(0)
    # Teacher forcing over 1200 samples: past the largest dilation (512)
    # so every ring buffer wraps.
    Tf = 1200
    cond = jnp.asarray(rs.randn(2, Tf, C).astype(np.float32) * 0.3)
    target = jnp.asarray(rs.randint(0, cfg.out_channels, (2, Tf)),
                         jnp.int32)
    params = model.init(jax.random.PRNGKey(0),
                        {"cond": cond, "target": target})
    parallel = np.asarray(model.apply(
        params, {"cond": cond, "target": target})["logits"])
    forced = np.asarray(teacher_forced_logits(params, cfg, cond, target))
    rel = float(np.abs(forced - parallel).max() / np.abs(parallel).max())
    if rel > WAVENET_LOGIT_TOL:
        raise AssertionError("WaveNet forced logits rel err {}".format(
            rel))
    out = {"forced_logits_max_rel_err": rel, "tol": WAVENET_LOGIT_TOL,
           "layers": cfg.num_layers, "channels": [
               cfg.residual_channels, cfg.gate_channels,
               cfg.skip_channels], "classes": cfg.out_channels}
    T = int(16000 * seconds)
    for B in batches:
        c = jnp.asarray(rs.randn(B, T, C).astype(np.float32) * 0.3)
        generate(params, cfg, c, rng=jax.random.PRNGKey(1),
                 device_output=True).block_until_ready()
        t0 = time.time()
        wav = generate(params, cfg, c, rng=jax.random.PRNGKey(2),
                       device_output=True).block_until_ready()
        elapsed = time.time() - t0
        wav = np.asarray(wav)
        if wav.shape != (B, T) or not np.isfinite(wav).all() \
                or np.abs(wav).max() > 1.0 or len(np.unique(wav)) < 5:
            raise AssertionError("WaveNet generation B={}".format(B))
        out["B{}".format(B)] = {"samples": T,
                                "generate_seconds": round(elapsed, 4)}
    return out


def _world_compare(a, b):
    """a, b: (T, D+3) [mcep | lf0 | vuv | bap] statics."""
    import numpy as np
    D = NUM_CODED_SPS
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    vuv_a, vuv_b = a[:, D + 1] > 0.5, b[:, D + 1] > 0.5
    both = vuv_a & vuv_b
    diff = a[:, 1:D] - b[:, 1:D]
    mcd = float(np.mean(np.sqrt(np.sum(diff ** 2, axis=1)))
                * 10 * np.sqrt(2) / np.log(10))
    return {"frames": int(n), "len_diff": abs(len(a) - len(b)),
            "vuv_agree": float(np.mean(vuv_a == vuv_b)),
            "lf0_rmse": float(np.sqrt(np.mean(
                (a[both, D] - b[both, D]) ** 2))) if both.any() else 0.0,
            "mcd_db": mcd}


def _world_ok(stats, vuv_min=WORLD_VUV_AGREE_MIN):
    return (stats["len_diff"] == 0
            and stats["vuv_agree"] >= vuv_min
            and stats["lf0_rmse"] <= WORLD_LF0_RMSE_MAX
            and stats["mcd_db"] <= WORLD_MCD_MAX_DB)


def phase_world(out_dir):
    import jax

    from idiaptts_tpu.data.world_feat import WorldFeatLabelGen

    result = {}
    for sub, utt in (("wav", "gen-0001"), ("wav48", "gen48-0001")):
        num_sps = NUM_CODED_SPS
        gen = WorldFeatLabelGen(dir_labels=out_dir, add_deltas=False,
                                num_coded_sps=num_sps)
        wav_dir = os.path.join(FIXTURES, "database", sub)
        feats, _ = gen.gen_data(wav_dir, id_list=[utt], return_dict=True)
        with jax.default_device(jax.devices("cpu")[0]):
            feats_cpu, _ = gen.gen_data(wav_dir, id_list=[utt],
                                        return_dict=True)
        stats = _world_compare(feats[utt], feats_cpu[utt])
        if not _world_ok(stats):
            raise AssertionError("WORLD {} GPU vs CPU: {}".format(
                utt, stats))
        result[utt] = stats
    # The committed 16 kHz features (extracted on a CPU when the
    # fixtures were made).
    committed = WorldFeatLabelGen.load_sample(
        "gen-0001", os.path.join(FIXTURES, "WORLD"), add_deltas=False,
        num_coded_sps=NUM_CODED_SPS, sp_type="mcep")
    gen = WorldFeatLabelGen(dir_labels=out_dir, add_deltas=False,
                            num_coded_sps=NUM_CODED_SPS)
    feats, _ = gen.gen_data(os.path.join(FIXTURES, "database", "wav"),
                            id_list=["gen-0001"], return_dict=True)
    stats = _world_compare(feats["gen-0001"], committed)
    if not _world_ok(stats, WORLD_VUV_AGREE_COMMITTED_MIN):
        raise AssertionError("WORLD gen-0001 vs committed: {}".format(
            stats))
    result["gen-0001_vs_committed"] = stats
    result["tol"] = {"vuv_agree_min": WORLD_VUV_AGREE_MIN,
                     "vuv_agree_committed_min":
                         WORLD_VUV_AGREE_COMMITTED_MIN,
                     "lf0_rmse_max": WORLD_LF0_RMSE_MAX,
                     "mcd_db_max": WORLD_MCD_MAX_DB}
    return result


def _dp_handler(batch, num_questions, mesh_devices=None):
    from idiaptts_tpu.hparams import ExtendedHParams
    from idiaptts_tpu.models.losses import NamedLoss
    from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
    from idiaptts_tpu.train.handler import ModularModelHandler

    cfg = convert_legacy_string(ACOUSTIC_MODEL, num_questions)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred",)
    handler = ModularModelHandler()
    handler.create_model(cfg, example_batch=batch)
    hp = ExtendedHParams.create_hparams()
    hp.optimiser_type = "SGD"
    hp.learning_rate = 0.01
    handler.set_optimiser(hp)
    handler.set_scheduler(hp)
    handler.set_losses([NamedLoss.Config("mse", "MSELoss",
                                         ("pred", "target"),
                                         seq_mask="_seq_mask")])
    if mesh_devices:
        handler.setup_mesh(mesh_devices)
    return handler


def phase_four_train(n=4, B=8, steps=2):
    """Data-parallel training step over n cards vs one card."""
    import jax
    import numpy as np

    from idiaptts_tpu.data.dataset import collate_batch
    from idiaptts_tpu.utils.serialization import flatten_dict

    rs = np.random.RandomState(0)
    nq = 409
    samples = [{"questions": rs.randn(L, nq).astype(np.float32),
                "target": rs.randn(L, 67).astype(np.float32)}
               for L in (400, 512, 350, 480, 290, 505, 444, 380)[:B]]
    batch = collate_batch(samples)
    one = _dp_handler(batch, nq)
    many = _dp_handler(batch, nq, mesh_devices=n)
    init = flatten_dict(jax.tree_util.tree_map(np.array, one.params))
    loss_one = [one.process_batches([batch], training=True)[0]
                for _ in range(steps)]
    loss_many = [many.process_batches([batch], training=True)[0]
                 for _ in range(steps)]
    p1 = flatten_dict(jax.tree_util.tree_map(np.asarray, one.params))
    pn = flatten_dict(jax.tree_util.tree_map(np.asarray, many.params))
    # Compare what training changed: a wrong gradient reduction over
    # the cards (a sum where a mean belongs, a missing all-reduce)
    # shows as an O(1) error in the update.
    upd_1 = np.concatenate([(p1[k] - init[k]).ravel() for k in init])
    upd_n = np.concatenate([(pn[k] - init[k]).ravel() for k in init])
    upd_rel = _rel_l2(upd_n, upd_1)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss_many,
                                                       loss_one))
    # bf16 matmuls with the batch split over cards: sums in another
    # order, so agreement at bf16 scale.
    if not np.isfinite(loss_many).all() or loss_rel > 1e-2 \
            or upd_rel > DP_UPDATE_REL_TOL:
        raise AssertionError("dp({}) vs 1 card: loss {} vs {}, update "
                             "rel l2 {}".format(n, loss_many, loss_one,
                                                upd_rel))
    return {"cards": n, "batch": B, "losses_dp": loss_many,
            "losses_one": loss_one, "loss_max_rel_diff": loss_rel,
            "update_rel_l2": upd_rel, "tol_loss_rel": 1e-2,
            "tol_update_rel_l2": DP_UPDATE_REL_TOL}


def phase_four_serve(out_dir, n=4):
    """Sharded fused pipeline over n cards vs one card."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    trainer, hp, ids = _trainer(out_dir, epochs=20)
    trainer.train(hp)
    pipeline, params, load_inputs = trainer.build_serving(hp)
    questions = [load_inputs(i) for i in ids]
    questions = (questions * n)[:max(n, len(questions) // n * n)]
    wavs_one = pipeline(params, questions, seed=0)
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    sharded, _, _ = trainer.build_serving(hp, mesh=mesh)
    wavs_many = sharded(params, questions, seed=0)
    corr = []
    for a, b in zip(wavs_many, wavs_one):
        if len(a) != len(b) or not np.isfinite(a).all():
            raise AssertionError("sharded wav length/finiteness")
        corr.append(float(np.corrcoef(_envelope(a), _envelope(b))[0, 1]))
    if min(corr) < ENVELOPE_CORR_MIN:
        raise AssertionError("sharded vs one card: envelope corr "
                             "{}".format(corr))
    return {"cards": n, "utterances": len(questions),
            "envelope_corr_min": min(corr),
            "tol_envelope_corr": ENVELOPE_CORR_MIN}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run the four-card data-parallel training "
                             "and sharded serving checks only")
    args = parser.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "idiaptts_tpu")):
        sys.stderr.write("chip_smoke: run from a checkout of the "
                         "repository\n")
        return 2
    sys.path.insert(0, REPO)
    import jax

    device = check_device(jax)
    if args.four and device["count"] < 4:
        raise SystemExit("chip_smoke --four needs four GPUs, found "
                         "{}".format(device["count"]))
    card = card_info()
    print("card: " + card, flush=True)

    from idiaptts_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    report = Reporter(card)
    report.phase("device", lambda: {"device": device})
    state = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four:
            report.phase("dp_train", phase_four_train)
            report.phase("sharded_serve",
                         lambda: phase_four_serve(tmp))
        else:
            report.phase("kernels", phase_kernels)
            report.phase("train", lambda: phase_train(state, tmp))
            report.phase("serve", lambda: phase_serve(state))
            report.phase("wavenet", phase_wavenet)
            report.phase("world", lambda: phase_world(tmp))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
