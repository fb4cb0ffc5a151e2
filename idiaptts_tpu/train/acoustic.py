"""Acoustic model trainer: linguistic questions -> WORLD features.

Capability parity with ``model_trainers/AcousticModelTrainer.py``
(:55-528): questions input, cmp (coded_sp+lf0+vuv+bap with deltas)
target, default biLSTM model from the legacy string (:169-177), default
MSE loss (:179-185), MCD/F0-RMSE/VDE/BAP benchmark (``compute_score``
:402-432 using original WORLD features from ``hparams.world_dir``),
WORLD synthesis and org-feature synth override (:457-520).
"""

import logging
import os

import numpy as np

from idiaptts_tpu.data.questions import QuestionLabelGen
from idiaptts_tpu.data.world_feat import WorldFeatLabelGen
from idiaptts_tpu.hparams import ExtendedHParams
from idiaptts_tpu.models.losses import NamedLoss
from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
from idiaptts_tpu.synth.metrics import Metrics
from idiaptts_tpu.synth.synthesiser import Synthesiser
from idiaptts_tpu.train.trainer import ModularTrainer

logger = logging.getLogger(__name__)


class AcousticModelTrainer(ModularTrainer):

    def __init__(self, hparams, id_list, dir_question_labels=None,
                 dir_world_features=None):
        super().__init__(hparams, id_list)
        self.dir_question_labels = dir_question_labels \
            or hparams.get("dir_question_labels")
        self.dir_world_features = dir_world_features \
            or hparams.get("world_dir")
        self.post_processing_mapping = {"pred_acoustic_features":
                                        "cmp_features"}

    @staticmethod
    def create_hparams(hparams_string=None, verbose=False):
        hparams = ExtendedHParams.create_hparams(hparams_string, verbose)
        hparams.add_hparams(
            num_questions=409,
            question_file=None,
            num_coded_sps_acoustic=None,
            metrics=[Metrics.MCD, Metrics.F0_RMSE, Metrics.VDE,
                     Metrics.BAP_distortion],
            # One fused jit program for model+MLPG+vocoder in synth
            # (measured 111x vs 3.2x realtime on the fixture corpus).
            use_fused_synth=True,
            # Per-stream ground-truth overrides at synthesis time
            # (AcousticModelTrainer.synthesize :457-520): replace the
            # predicted stream with the extracted one from world_dir.
            synth_load_org_sp=False,
            synth_load_org_lf0=False,
            synth_load_org_vuv=False,
            synth_load_org_bap=False,
            synth_feature_names=None,
        )
        hparams.setattr_no_type_check("add_deltas", True)
        return hparams

    def default_data_reader_configs(self, hparams):
        input_config = QuestionLabelGen.Config(
            name="questions",
            directory=self.dir_question_labels,
            num_questions=hparams.get("num_questions", 409),
            norm_params=None)
        output_config = WorldFeatLabelGen.Config(
            name="cmp_features",
            output_names=("acoustic_features",),
            directory=self.dir_world_features,
            add_deltas=hparams.get("add_deltas", True),
            num_coded_sps=hparams.get("num_coded_sps", 60),
            sp_type=hparams.get("sp_type", "mcep"),
            match_length="questions")
        input_config.match_length = ("acoustic_features",)
        return [input_config, output_config]

    def default_model_config(self, hparams, dim_in, dim_out):
        cfg = convert_legacy_string(
            "RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_{}".format(dim_out),
            dim_in, dropout=hparams.get("dropout", 0.0)
            if "dropout" in hparams else 0.0)
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred_acoustic_features",)
        return cfg

    def default_loss_configs(self, hparams):
        return [NamedLoss.Config(
            "mse", "MSELoss",
            ("pred_acoustic_features", "acoustic_features"),
            seq_mask="_seq_mask", reduction="mean_per_frame")]

    def init(self, hparams, model_config=None, loss_configs=None,
             data_reader_configs=None):
        if data_reader_configs is None:
            data_reader_configs = self.default_data_reader_configs(
                hparams)
        self.data_reader_configs = data_reader_configs
        self._setup_datareaders(hparams)
        self._setup_datasets(hparams)
        if model_config is None \
                and not hparams.get("load_from_checkpoint"):
            # Strict checkpoint loads rebuild the model from its saved
            # config.json; no example batch needed.  load_newest still
            # probes so the no-checkpoint-yet case trains fresh.
            example = self._example_batch(hparams)
            dim_in = example["questions"].shape[-1]
            dim_out = example["acoustic_features"].shape[-1]
            model_config = self.default_model_config(hparams, dim_in,
                                                     dim_out)
        if loss_configs is None:
            loss_configs = self.default_loss_configs(hparams)
        return super().init(hparams, model_config, loss_configs,
                            data_reader_configs)

    # -- benchmark --------------------------------------------------------
    def compute_score(self, hparams, results):
        """MCD / F0-RMSE / VDE / BAP against original WORLD features
        (compute_score :402-432 role)."""
        num_coded_sps = hparams.get("num_coded_sps", 60)
        metric_names = hparams.get(
            "metrics", [Metrics.MCD, Metrics.F0_RMSE, Metrics.VDE,
                        Metrics.BAP_distortion])
        metrics = Metrics(metric_names)
        for id_name, sample in results.items():
            output = np.asarray(sample["pred_acoustic_features"])
            out_sp, out_lf0, out_vuv, out_bap = \
                WorldFeatLabelGen.convert_to_world_features(
                    output, contains_deltas=False,
                    num_coded_sps=num_coded_sps)
            org = WorldFeatLabelGen.load_sample(
                id_name, self.dir_world_features, add_deltas=False,
                num_coded_sps=num_coded_sps,
                sp_type=hparams.get("sp_type", "mcep"))
            org_sp, org_lf0, org_vuv, org_bap = \
                WorldFeatLabelGen.convert_to_world_features(
                    org, contains_deltas=False,
                    num_coded_sps=num_coded_sps)
            metrics.accumulate(id_name, Metrics.get_metrics(
                metric_names, org_coded_sp=org_sp, org_lf0=org_lf0,
                org_vuv=org_vuv, org_bap=org_bap,
                output_coded_sp=out_sp, output_lf0=out_lf0,
                output_vuv=out_vuv, output_bap=out_bap))
        metrics.log()
        return tuple(metrics.get_cum_values())

    # -- synthesis --------------------------------------------------------
    def gen_waveform(self, hparams, results, use_org_features=False):
        num_coded_sps = hparams.get("num_coded_sps", 60)
        num_bap = hparams.get("num_bap", 1)
        load_streams = [s for s in ("sp", "lf0", "vuv", "bap")
                        if hparams.get("synth_load_org_" + s)]
        # synth_feature_names (AcousticModelTrainer.synthesize
        # :461-479): pick which named outputs feed the vocoder; several
        # names concatenate along features (multi-head models).
        feature_names = hparams.get("synth_feature_names") \
            or ("pred_acoustic_features",)
        if not isinstance(feature_names, (list, tuple)):
            feature_names = (feature_names,)
        synth_output = {}
        for id_name, sample in results.items():
            if use_org_features:
                feats = WorldFeatLabelGen.load_sample(
                    id_name, self.dir_world_features, add_deltas=False,
                    num_coded_sps=num_coded_sps,
                    sp_type=hparams.get("sp_type", "mcep"))
            else:
                feats = np.concatenate(
                    [np.atleast_2d(np.asarray(sample[n]))
                     for n in feature_names], axis=1) \
                    if len(feature_names) > 1 \
                    else np.asarray(sample[feature_names[0]])
                if load_streams:
                    # Per-stream ground-truth override
                    # (AcousticModelTrainer.synthesize :457-520): swap
                    # selected predicted streams for the extracted
                    # ones — the standard stream-ablation diagnostic.
                    feats = np.array(feats, copy=True)
                    org = WorldFeatLabelGen.load_sample(
                        id_name, self.dir_world_features,
                        add_deltas=False, num_coded_sps=num_coded_sps,
                        sp_type=hparams.get("sp_type", "mcep"))
                    n = min(len(org), len(feats))
                    if "sp" in load_streams:
                        feats[:n, :num_coded_sps] = \
                            org[:n, :num_coded_sps]
                    if "lf0" in load_streams:
                        feats[:n, num_coded_sps] = org[:n, num_coded_sps]
                    if "vuv" in load_streams:
                        feats[:n, num_coded_sps + 1] = \
                            org[:n, num_coded_sps + 1]
                    if "bap" in load_streams:
                        feats[:n, num_coded_sps + 2:
                              num_coded_sps + 2 + num_bap] = \
                            org[:n, num_coded_sps + 2:
                                num_coded_sps + 2 + num_bap]
            synth_output[id_name] = feats
        vocoder = hparams.get("synth_vocoder", "WORLD")
        if vocoder == "WORLD":
            return Synthesiser.run_world_synth(
                synth_output, hparams, epoch=self.total_epoch)
        if vocoder == "raw":
            return Synthesiser.run_raw_synth(synth_output, hparams)
        if vocoder == "GriffinLim":
            return Synthesiser.run_griffin_lim(synth_output, hparams)
        if vocoder == "r9y9wavenet" or vocoder == "wavenet":
            return Synthesiser.run_wavenet_vocoder(synth_output, hparams)
        raise NotImplementedError("Unknown vocoder " + vocoder)

    def synth(self, hparams, id_list, use_org_features=False):
        if use_org_features:
            return self.gen_waveform(hparams,
                                     {i: {} for i in id_list},
                                     use_org_features=True)
        feature_names = hparams.get("synth_feature_names")
        if hparams.get("use_fused_synth", True) \
                and hparams.get("synth_vocoder", "WORLD") == "WORLD" \
                and not any(hparams.get("synth_load_org_" + s)
                            for s in ("sp", "lf0", "vuv", "bap")) \
                and (not feature_names or tuple(np.atleast_1d(
                    feature_names)) == ("pred_acoustic_features",)):
            try:
                return self._synth_fused(hparams, id_list)
            except Exception as e:  # fall back to the modular path
                logger.warning("Fused synthesis unavailable (%s); "
                               "using the per-stage path.", e)
        return super().synth(hparams, id_list)

    def build_serving(self, hparams, mesh=None):
        """The serving assets of the trained model: ``(pipeline,
        params, load_inputs)`` where ``pipeline`` is the
        :class:`FusedAcousticPipeline` (model forward, denorm, MLPG,
        mcep decode, WORLD synthesis as one jit program per bucket),
        ``params`` the inference parameters (EMA shadow when enabled)
        and ``load_inputs(id_name)`` the question-matrix loader
        (multi-input models ride as trailing columns).  Used by
        ``synth`` and by :meth:`serve`.  With ``mesh`` (1-D) the
        pipeline shards each batch over the mesh's devices."""
        from idiaptts_tpu.synth.pipeline import FusedAcousticPipeline

        handler = self.model_handler
        reader_q = self.datareaders["questions"]
        reader_cmp = self.datareaders["cmp_features"]
        if reader_cmp.covs[0] is None or reader_cmp.norm_params is None:
            raise ValueError("cmp reader has no covariances/norm stats")
        # Multi-input models (e.g. speaker-index EMB columns): extra
        # inputs ride as trailing columns of the questions matrix and
        # the model_apply closure splits them back into the data dict,
        # so the pipeline itself stays single-tensor.
        input_names = tuple(getattr(handler.model_config,
                                    "input_names", None)
                            or ("questions",))
        extra_names = tuple(n for n in input_names if n != "questions")

        def load_inputs(id_name):
            q = np.asarray(reader_q[id_name]["questions"], np.float32)
            if not extra_names:
                return q
            cols = [q]
            for name in extra_names:
                feat = np.atleast_2d(np.asarray(
                    self.datareaders[name][id_name][name], np.float32))
                if feat.shape[0] == 1:
                    feat = np.broadcast_to(feat,
                                           (len(q), feat.shape[1]))
                elif feat.shape[0] != len(q):
                    raise ValueError(
                        "fused synth: input '%s' has %d frames vs %d "
                        "question frames" % (name, feat.shape[0],
                                             len(q)))
                cols.append(feat)
            return np.concatenate(cols, axis=1)

        widths = None
        if extra_names:
            # Probe per-input column widths on any known utterance.
            known = ((self.id_list_train or []) +
                     (self.id_list_val or []) +
                     (self.id_list_test or []))
            if not known:
                raise ValueError(
                    "serving a multi-input model needs at least one "
                    "known utterance id to probe input widths; "
                    "construct the trainer with a non-empty id_list")
            probe_id = known[0]
            nq = np.asarray(reader_q[probe_id]["questions"]).shape[1]
            widths = [nq]
            for name in extra_names:
                feat = np.atleast_2d(np.asarray(
                    self.datareaders[name][probe_id][name]))
                widths.append(feat.shape[1])
            widths = tuple(widths)
        pipe_key = (hparams.get("num_coded_sps", 60),
                    hparams.get("synth_fs", 16000),
                    hparams.get("frame_size_ms", 5),
                    hparams.get("num_bap", 1),
                    bool(hparams.get("do_post_filtering")),
                    hparams.get("mgc_alpha"),
                    input_names, widths, mesh)
        cache = getattr(self, "_fused_pipelines", None)
        if cache is None:
            cache = self._fused_pipelines = {}
        pipeline = cache.get(pipe_key)
        if pipeline is None:
            variances = {
                "sp": np.ascontiguousarray(
                    np.diagonal(reader_cmp.covs[0])),
                "lf0": np.ascontiguousarray(
                    np.diagonal(reader_cmp.covs[1])),
                "bap": np.ascontiguousarray(
                    np.diagonal(reader_cmp.covs[3])),
            }
            mean, scale = reader_cmp.norm_params
            model = handler.model
            batch_stats = handler.batch_stats
            output_name = handler.model_config.output_names[0]

            def model_apply(params, questions_b, lengths_b):
                variables = {"params": params}
                if batch_stats is not None:
                    variables["batch_stats"] = batch_stats
                if widths is None:
                    data = {"questions": questions_b}
                else:
                    data, ofs = {}, 0
                    for name, w in zip(("questions",) + extra_names,
                                       widths):
                        data[name] = questions_b[..., ofs:ofs + w]
                        ofs += w
                out = model.apply(variables, data,
                                  lengths=lengths_b, training=False)
                return out[output_name]

            fs = hparams.get("synth_fs", 16000)
            from idiaptts_tpu.ops import mcep as mcep_ops
            pipeline = FusedAcousticPipeline(
                model_apply, variances,
                num_coded_sps=hparams.get("num_coded_sps", 60),
                fs=fs,
                frame_shift_ms=hparams.get("frame_size_ms", 5),
                num_bap=hparams.get("num_bap", 1),
                num_bins=mcep_ops.fs_to_frame_length(fs) // 2 + 1,
                post_filter=bool(hparams.get("do_post_filtering")),
                mean=np.asarray(mean).reshape(-1),
                scale=np.asarray(scale).reshape(-1),
                mgc_alpha=hparams.get("mgc_alpha"),
                mesh=mesh)
            cache[pipe_key] = pipeline
        params = handler.ema.shadow if handler.ema is not None \
            else handler.params
        return pipeline, params, load_inputs

    def serve(self, hparams, max_batch=32, max_wait_ms=5.0):
        """Online serving front door: a
        :class:`~idiaptts_tpu.synth.server.SynthesisServer` bound to
        the trained model's fused pipeline.  ``server.submit(load(id))``
        / ``server.submit(question_matrix)`` return futures resolving
        to waveforms; concurrent requests batch per length bucket."""
        from idiaptts_tpu.synth.server import SynthesisServer
        pipeline, params, _ = self.build_serving(hparams)
        return SynthesisServer(pipeline, params, max_batch=max_batch,
                               max_wait_ms=max_wait_ms)

    def _synth_fused(self, hparams, id_list):
        """label->wav through :class:`FusedAcousticPipeline`: model
        forward, denormalisation, MLPG, mcep decode and WORLD synthesis
        compiled as ONE jit program per length bucket — the whole batch
        costs a single device round trip (vs the reference's chain of
        per-utterance stages, ModularTrainer.py:644-676 ->
        Synthesiser.py:38-80)."""
        from idiaptts_tpu.ops.audio_io import raw_to_file

        pipeline, params, load_inputs = self.build_serving(hparams)
        questions = [load_inputs(i) for i in id_list]
        # pcm16: loudness-norm + int16 encode happen ON DEVICE, so the
        # host receives write-ready samples in half the bytes — the
        # device->host transfer is the reference-surface path's
        # dominant cost.
        wavs = pipeline(params, questions, pcm16=True)
        fs = hparams.get("synth_fs", 16000)
        suffix = "_e{}".format(self.total_epoch) \
            if self.total_epoch is not None else ""
        if hparams.get("model_name"):
            suffix += "_" + str(hparams.model_name)
        paths = {}
        for id_name, raw in zip(id_list, wavs):
            path = Synthesiser._out_path(id_name, hparams, suffix)
            raw_to_file(path, raw, fs)
            paths[id_name] = path
        return paths

    def copy_synth(self, hparams, id_list):
        """Synthesise directly from the original extracted features
        (ModularTrainer.copy_synth :1093-1119 role)."""
        return self.gen_waveform(hparams, {i: {} for i in id_list},
                                 use_org_features=True)

    def gen_figure_from_output(self, id_name, sample, hparams):
        """Acoustic figure: coded-sp spectrogram image, lf0 curves
        (pred vs org) and VUV areas (AcousticModelTrainer.gen_figure
        role)."""
        from idiaptts_tpu.utils.plotter import DataPlotter
        num_coded_sps = hparams.get("num_coded_sps", 60)
        out_dir = hparams.get("synth_dir") or hparams.get("out_dir") \
            or "."
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "{}{}".format(
            id_name, hparams.get("gen_figure_ext", ".pdf")))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        pred = np.asarray(sample["pred_acoustic_features"])
        sp, lf0, vuv, bap = \
            WorldFeatLabelGen.convert_to_world_features(
                pred, contains_deltas=False,
                num_coded_sps=num_coded_sps)
        with DataPlotter() as plotter:
            plotter.set_spec_data(0, sp, label="coded sp (pred)")
            curves = [(lf0, "pred lf0")]
            try:
                org = WorldFeatLabelGen.load_sample(
                    id_name, self.dir_world_features, add_deltas=False,
                    num_coded_sps=num_coded_sps,
                    sp_type=hparams.get("sp_type", "mcep"))
                _, org_lf0, org_vuv, _ = \
                    WorldFeatLabelGen.convert_to_world_features(
                        org, contains_deltas=False,
                        num_coded_sps=num_coded_sps)
                curves.append((org_lf0, "org lf0"))
                plotter.set_area_list(1, [(org_vuv, "gray", 0.2,
                                           "org vuv")])
            except (FileNotFoundError, ValueError):
                pass
            plotter.set_data_list(1, curves)
            plotter.set_label(1, xlabel="frames", ylabel="lf0")
            plotter.gen_plot()
            plotter.save_to_file(path)
        return path
