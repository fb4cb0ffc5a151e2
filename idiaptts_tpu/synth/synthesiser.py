"""Synthesiser: vocoder backend dispatch.

Capability parity with ``idiaptts/src/Synthesiser.py`` (:35-351):
``run_world_synth`` :38-80 (WORLD features -> wav files),
``run_raw_synth`` :167-180, ``raw_to_file`` :181-201,
``run_wavenet_vocoder`` :244-319 (neural vocoder hook) and
``run_griffin_lim(_on_log)`` :320-351 — with the DSP running on the JAX
kernels instead of pyworld/librosa, and plain WAV output instead of
pydub/ffmpeg.
"""

import logging
import os

import numpy as np

from idiaptts_tpu.data.world_feat import WorldFeatLabelGen
from idiaptts_tpu.ops import audio_io
from idiaptts_tpu.ops import mcep as mcep_ops
from idiaptts_tpu.ops import stft as stft_ops

logger = logging.getLogger(__name__)


class Synthesiser:

    @staticmethod
    def _out_path(id_name, hparams, suffix=""):
        out_dir = hparams.get("synth_dir") or os.path.join(
            hparams.get("out_dir") or ".", "synth")
        os.makedirs(out_dir, exist_ok=True)
        ext = hparams.get("synth_ext", "wav")
        suffix += hparams.get("synth_file_suffix") or ""
        return os.path.join(out_dir, "{}{}.{}".format(id_name, suffix,
                                                      ext))

    @staticmethod
    def run_world_synth(synth_output, hparams, epoch=None,
                        use_model_name=True):
        """{id: [coded_sp, lf0, vuv, bap]} -> wav files
        (Synthesiser.run_world_synth :38-80 role)."""
        fs = hparams.get("synth_fs", 16000)
        num_coded_sps = hparams.get("num_coded_sps", 60)
        num_bap = hparams.get("num_bap", 1)
        post_filter = bool(hparams.get("do_post_filtering"))
        sp_type = hparams.get("sp_type", "mcep")
        if sp_type not in ("mcep", "mgc"):
            # Non-cepstral codings (mfbanks/amp_sp): decode to the
            # amplitude spectrum (AudioProcessing.decode_sp dispatch)
            # and synthesise through the amp-sp WORLD path.
            suffix = "_e{}".format(epoch) if epoch is not None else ""
            if use_model_name and hparams.get("model_name"):
                suffix += "_" + str(hparams.model_name)
            paths = {}
            for id_name, feats in synth_output.items():
                feats = np.asarray(feats, np.float32)
                coded, lf0, vuv, bap = \
                    WorldFeatLabelGen.convert_to_world_features(
                        feats, contains_deltas=False,
                        num_coded_sps=num_coded_sps, num_bap=num_bap)
                amp_sp = WorldFeatLabelGen.decode_sp(
                    coded, sp_type=sp_type, fs=fs,
                    post_filtering=post_filter)
                raw = WorldFeatLabelGen.world_features_to_raw(
                    amp_sp, lf0, vuv, bap, fs,
                    hparams.get("frame_size_ms", 5))
                path = Synthesiser._out_path(id_name, hparams, suffix)
                audio_io.raw_to_file(path, _norm_loudness(raw), fs)
                paths[id_name] = path
            return paths
        # One fused jit program per bucket synthesises the WHOLE batch
        # in a single device round trip (the reference loops pysptk /
        # pyworld per utterance).
        synth = Synthesiser._batched_world_synth(
            num_coded_sps, fs, hparams.get("frame_size_ms", 5),
            num_bap, post_filter, hparams.get("mgc_alpha"))
        ids = list(synth_output)
        samples = [np.asarray(synth_output[i], np.float32)[
            :, :num_coded_sps + 2 + num_bap] for i in ids]
        wavs = synth(samples)
        suffix = "_e{}".format(epoch) if epoch is not None else ""
        if use_model_name and hparams.get("model_name"):
            suffix += "_" + str(hparams.model_name)
        paths = {}
        for id_name, raw in zip(ids, wavs):
            path = Synthesiser._out_path(id_name, hparams, suffix)
            audio_io.raw_to_file(path, _norm_loudness(raw), fs)
            logger.info("Wrote %s", path)
            paths[id_name] = path
        return paths

    _world_synth_cache = {}

    @staticmethod
    def _batched_world_synth(num_coded_sps, fs, frame_size_ms, num_bap,
                             post_filter, mgc_alpha=None):
        from idiaptts_tpu.synth.pipeline import BatchedWorldSynth
        key = (num_coded_sps, fs, frame_size_ms, num_bap, post_filter,
               mgc_alpha)
        cache = Synthesiser._world_synth_cache
        if key not in cache:
            cache[key] = BatchedWorldSynth(
                num_coded_sps, fs, frame_size_ms, num_bap=num_bap,
                post_filter=post_filter, mgc_alpha=mgc_alpha)
        return cache[key]

    @staticmethod
    def run_raw_synth(synth_output, hparams, epoch=None):
        """{id: waveform} -> wav files (run_raw_synth :167-180)."""
        fs = hparams.get("synth_fs", 16000)
        paths = {}
        for id_name, raw in synth_output.items():
            path = Synthesiser._out_path(id_name, hparams)
            audio_io.raw_to_file(path, _norm_loudness(np.squeeze(raw)),
                                 fs)
            paths[id_name] = path
        return paths

    @staticmethod
    def raw_to_file(id_name, raw, hparams):
        path = Synthesiser._out_path(id_name, hparams)
        return audio_io.raw_to_file(path, _norm_loudness(raw),
                                    hparams.get("synth_fs", 16000))

    @staticmethod
    def run_griffin_lim(synth_output, hparams, epoch=None,
                        on_log=False):
        """{id: amplitude spectrogram (T, bins)} -> wav files via
        Griffin-Lim (run_griffin_lim(_on_log) :320-351)."""
        import jax.numpy as jnp
        fs = hparams.get("synth_fs", 16000)
        hop = int(fs * hparams.get("frame_size_ms", 5) / 1000)
        paths = {}
        for id_name, amp in synth_output.items():
            amp = np.asarray(amp)
            if on_log:
                amp = np.exp(amp)
            n_fft = (amp.shape[1] - 1) * 2
            raw = np.asarray(stft_ops.griffin_lim(
                jnp.asarray(amp), n_fft, hop, num_iters=60))
            path = Synthesiser._out_path(id_name, hparams)
            audio_io.raw_to_file(path, _norm_loudness(raw), fs)
            paths[id_name] = path
        return paths

    @staticmethod
    def run_wavenet_vocoder(synth_output, hparams, epoch=None):
        """{id: conditioning features} -> wav via the WaveNet vocoder
        (run_wavenet_vocoder :244-319 role).  Requires a trained
        WaveNet checkpoint at hparams.synth_vocoder_path."""
        from idiaptts_tpu.models.wavenet import WaveNetVocoder
        vocoder = WaveNetVocoder.load(hparams.synth_vocoder_path,
                                      hparams)
        fs = hparams.get("synth_fs", 16000)
        # Batch all utterances into ONE autoregressive scan (padded to
        # the longest): per-step matvecs become matmuls, so B
        # utterances cost about as much as one.
        ids = list(synth_output.keys())
        conds = [np.asarray(synth_output[i], np.float32) for i in ids]
        lengths = [len(c) for c in conds]
        t_max = max(lengths)
        batch = np.stack([np.pad(c, ((0, t_max - len(c)), (0, 0)))
                          for c in conds])
        raws = vocoder.generate(batch)
        paths = {}
        for id_name, raw, length in zip(ids, raws, lengths):
            path = Synthesiser._out_path(id_name, hparams)
            audio_io.raw_to_file(path, _norm_loudness(raw[:length]), fs)
            paths[id_name] = path
        return paths


    @staticmethod
    def run_griffin_lim_on_log(synth_output, hparams, epoch=None,
                               use_model_name=True):
        """Log-amplitude variant (run_griffin_lim_on_log :320-322)."""
        return Synthesiser.run_griffin_lim(
            {k: np.exp(np.asarray(v)) for k, v in synth_output.items()},
            hparams, epoch=epoch)

    @staticmethod
    def run_r9y9wavenet_mulaw_world_feats_synth(synth_output, hparams,
                                                epoch=None):
        """WaveNet vocoder conditioned on WORLD frame features
        (run_r9y9wavenet_mulaw_world_feats_synth :204-243 role):
        optional merlin post-filter on the coded sp, frame->sample-rate
        upsampling of the conditioning, then the neural vocoder."""
        from idiaptts_tpu.data.world_feat import WorldFeatLabelGen
        from idiaptts_tpu.ops.interpolation import sample_linearly
        fs = hparams.get("synth_fs", 16000)
        num_coded_sps = hparams.get("num_coded_sps", 60)
        samples_per_frame = int(
            fs * hparams.get("frame_size_ms",
                             hparams.get("frame_shift_ms", 5.0))
            / 1000.0)
        out = {}
        for id_name, feats in synth_output.items():
            feats = np.asarray(feats)
            if hparams.get("do_post_filtering"):
                sp, lf0, vuv, bap = \
                    WorldFeatLabelGen.convert_to_world_features(
                        feats, contains_deltas=False,
                        num_coded_sps=num_coded_sps)
                sp = mcep_ops.merlin_post_filter(
                    sp, mcep_ops.fs_to_mgc_alpha(fs))
                feats = WorldFeatLabelGen.convert_from_world_features(
                    sp, lf0, vuv, bap)
            out[id_name] = sample_linearly(feats, samples_per_frame)
        return Synthesiser.run_wavenet_vocoder(out, hparams,
                                               epoch=epoch)

    @staticmethod
    def copy_synth(hparams, file_id_list, epoch=None, feature_dir=None):
        """Reference audio containing only the vocoder degradation
        (Synthesiser.copy_synth :110-166): load original features
        (plain or with deltas) and synthesise them."""
        from idiaptts_tpu.data.world_feat import WorldFeatLabelGen
        vocoder = hparams.get("synth_vocoder", "WORLD")
        synth_dict = {}
        if vocoder == "WORLD":
            for id_name in file_id_list:
                try:
                    output = WorldFeatLabelGen.load_sample(
                        id_name, feature_dir,
                        num_coded_sps=hparams.get("num_coded_sps", 60),
                        sp_type=hparams.get("sp_type", "mcep"))
                except FileNotFoundError:
                    with_deltas = WorldFeatLabelGen.load_sample(
                        id_name, feature_dir, add_deltas=True,
                        num_coded_sps=hparams.get("num_coded_sps", 60),
                        sp_type=hparams.get("sp_type", "mcep"))
                    output = \
                        WorldFeatLabelGen.convert_from_world_features(
                            *WorldFeatLabelGen.convert_to_world_features(
                                with_deltas, contains_deltas=True,
                                num_coded_sps=hparams.get(
                                    "num_coded_sps", 60)))
                synth_dict[id_name] = output
            return Synthesiser.run_world_synth(
                synth_dict, hparams, epoch=epoch, use_model_name=False)
        if vocoder == "raw" or vocoder.startswith("r9y9wavenet") \
                or vocoder == "wavenet":
            from idiaptts_tpu.data.audio_gen import RawWaveformLabelGen
            for id_name in file_id_list:
                synth_dict[id_name] = RawWaveformLabelGen.load_sample(
                    os.path.join(feature_dir, id_name + ".wav"),
                    hparams.get("frame_rate_output_Hz",
                                hparams.get("synth_fs", 16000)))
            return Synthesiser.run_raw_synth(synth_dict, hparams,
                                             epoch=epoch)
        raise NotImplementedError("Unknown vocoder " + vocoder)


def _norm_loudness(raw, peak=0.85):
    raw = np.asarray(raw, np.float32)
    max_abs = np.abs(raw).max()
    if max_abs > peak:
        raw = raw / max_abs * peak
    return raw
