"""Reference-named ``AudioProcessing`` facade.

Migration surface parity with
``idiaptts/src/data_preparation/audio/AudioProcessing.py`` (:33-339):
every static method of the reference class exists here under the same
name and delegates to the JAX kernels (`ops.mcep`, `ops.stft`,
`ops.world`, `ops.audio_io`).  Code written against the reference's
``AudioProcessing.X(...)`` calls keeps working with an import swap;
new code can call the ops modules directly.
"""

import numpy as np

from idiaptts_tpu.ops import audio_io
from idiaptts_tpu.ops import mcep as mcep_ops
from idiaptts_tpu.ops import stft as stft_ops


class AudioProcessing:
    """Static spectral coding/decoding helpers (AudioProcessing.py
    role).  All heavy math runs on the JAX kernels; inputs/outputs are
    numpy arrays like the reference."""

    # -- fs-derived constants (reference :33-105) ------------------------
    @staticmethod
    def fs_to_mgc_alpha(fs):
        """All-pass warping coefficient for a sample rate
        (AudioProcessing.py:33-51, pysptk.mcepalpha parity)."""
        return mcep_ops.fs_to_mgc_alpha(fs)

    @staticmethod
    def fs_to_frame_length(fs):
        """CheapTrick FFT size for a sample rate
        (AudioProcessing.py:53-69)."""
        return mcep_ops.fs_to_frame_length(fs)

    @staticmethod
    def fs_to_num_bap(fs):
        """Number of coded band aperiodicities
        (AudioProcessing.py:71-77, pyworld.get_num_aperiodicities)."""
        from idiaptts_tpu.ops.world.d4c import get_num_aperiodicities
        return get_num_aperiodicities(fs)

    # -- IO / framing ----------------------------------------------------
    @staticmethod
    def get_raw(audio_name, preemphasis=0.0):
        """Load audio as float raw with optional pre-emphasis
        (AudioProcessing.py:108-120).  Returns (raw, fs)."""
        return audio_io.get_raw(audio_name, preemphasis)

    @staticmethod
    def framing(raw, frame_length, hop_length):
        """Strided frame view (AudioProcessing.framing :79-106 role)."""
        import jax.numpy as jnp
        return np.asarray(stft_ops.frame_signal(
            jnp.asarray(raw, jnp.float32), int(frame_length),
            int(hop_length), center=False))

    @staticmethod
    def preemphasis(raw, coefficient=0.97):
        return audio_io.apply_preemphasis(raw, coefficient)

    @staticmethod
    def depreemphasis(raw, coefficient=0.97):
        """Inverse pre-emphasis IIR (AudioProcessing.py:330-331)."""
        return audio_io.depreemphasis(raw, coefficient)

    # -- analysis (reference :123-228) -----------------------------------
    @staticmethod
    def extract_mcep(amp_sp, num_coded_sps, mgc_alpha):
        """Amplitude spectrum -> mel-cepstrum
        (AudioProcessing.extract_mcep :142-153, pysptk.mcep itype=3
        role)."""
        import jax.numpy as jnp
        return np.asarray(mcep_ops.amp_sp_to_mcep(
            jnp.asarray(amp_sp, jnp.float32), num_coded_sps - 1,
            mgc_alpha))

    @staticmethod
    def extract_mgc(amp_sp, num_coded_sps=60, fs=None, mgc_alpha=None,
                    mgc_gamma=None):
        """Mel-generalised cepstrum (AudioProcessing.extract_mgc
        :123-140).  The gamma!=0 generalisation is approximated by the
        mel-cepstral (gamma=0) solution — the reference's own default
        path for acoustic features."""
        if mgc_alpha is None:
            mgc_alpha = mcep_ops.fs_to_mgc_alpha(fs)
        return AudioProcessing.extract_mcep(amp_sp, num_coded_sps,
                                            mgc_alpha)

    @staticmethod
    def librosa_extract_amp_sp(raw, fs, n_fft=None, hop_size_ms=5,
                               win_length=None, center=True):
        """STFT magnitude with librosa conventions
        (AudioProcessing.py:156-184)."""
        import jax.numpy as jnp
        if n_fft is None:
            n_fft = mcep_ops.fs_to_frame_length(fs)
        hop = int(fs * hop_size_ms / 1000.0)
        amp = stft_ops.amp_spectrum(jnp.asarray(raw, jnp.float32),
                                    n_fft, hop, win_length,
                                    center=center)
        return np.asarray(amp) / np.sqrt(amp.shape[1])

    @staticmethod
    def extract_mfbanks(raw=None, fs=16000, amp_sp=None, n_fft=None,
                        hop_size_ms=5, num_coded_sps=80):
        """Mel-filterbank features (AudioProcessing.extract_mfbanks
        :187-228): LINEAR amplitude-mel like the reference
        (``librosa.melspectrogram(S=amp_sp)``), not the log-power
        coding WorldFeatLabelGen uses internally."""
        if amp_sp is None:
            amp_sp = AudioProcessing.librosa_extract_amp_sp(
                raw, fs, n_fft, hop_size_ms)
        if num_coded_sps == -1:
            return np.asarray(amp_sp, np.float32)
        fbank = stft_ops.mel_filterbank(
            fs, (amp_sp.shape[1] - 1) * 2, n_mels=num_coded_sps)
        return (np.asarray(amp_sp, np.float32)
                @ fbank.T).astype(np.float32)

    # -- decoding (reference :248-327) -----------------------------------
    @staticmethod
    def mcep_to_amp_sp(coded_sp, fs, alpha=None):
        """Mel-cepstrum -> amplitude spectrum
        (AudioProcessing.py:248-258, pysptk.mgc2sp role)."""
        from idiaptts_tpu.data.world_feat import WorldFeatLabelGen
        return WorldFeatLabelGen.mcep_to_amp_sp(coded_sp, fs,
                                                alpha=alpha)

    @staticmethod
    def mgc_to_amp_sp(coded_sp, fs, alpha=None, gamma=None, n_fft=None):
        """(AudioProcessing.py:260-275; gamma handled as mcep)."""
        num_bins = None if n_fft is None else n_fft // 2 + 1
        from idiaptts_tpu.data.world_feat import WorldFeatLabelGen
        return WorldFeatLabelGen.mcep_to_amp_sp(coded_sp, fs,
                                                alpha=alpha,
                                                num_bins=num_bins)

    @staticmethod
    def mfbanks_to_amp_sp(coded_sp, fs, n_fft=None):
        """NNLS mel inversion (AudioProcessing.py:291-301) of the
        LINEAR amplitude-mel coding of :meth:`extract_mfbanks` (the
        solver is scale-agnostic, so it runs directly on amplitude)."""
        import jax.numpy as jnp
        if n_fft is None:
            n_fft = mcep_ops.fs_to_frame_length(fs)
        return np.asarray(stft_ops.mel_power_to_power_sp(
            jnp.asarray(coded_sp, jnp.float32), int(fs), int(n_fft)))

    @staticmethod
    def decode_sp(coded_sp, sp_type="mcep", fs=None, alpha=None,
                  mgc_gamma=None, n_fft=None, post_filtering=False):
        """Coded-spectrum decode dispatch (AudioProcessing.py:304-327).

        The "mfbanks" branch inverts THIS facade's linear
        amplitude-mel coding (:meth:`extract_mfbanks`), not the
        log-power coding WorldFeatLabelGen uses internally."""
        if sp_type == "mfbanks":
            if post_filtering:
                import logging
                logging.warning("Post-filtering only implemented for "
                                "cepstrum features.")
            return AudioProcessing.mfbanks_to_amp_sp(coded_sp, fs,
                                                     n_fft=n_fft)
        from idiaptts_tpu.data.world_feat import WorldFeatLabelGen
        return WorldFeatLabelGen.decode_sp(
            coded_sp, sp_type=sp_type, fs=fs, alpha=alpha, n_fft=n_fft,
            post_filtering=post_filtering)

    @staticmethod
    def amp_sp_to_raw(amp_sp, fs, hop_size_ms=5, preemphasis=0.97,
                      num_iters=60):
        """Griffin-Lim reconstruction + de-emphasis
        (AudioProcessing.py:278-288)."""
        import jax.numpy as jnp
        amp = jnp.asarray(amp_sp, jnp.float32) * np.sqrt(amp_sp.shape[1])
        n_fft = (amp_sp.shape[1] - 1) * 2
        raw = np.asarray(stft_ops.griffin_lim(
            amp, n_fft, int(fs * hop_size_ms / 1000.0),
            num_iters=num_iters))
        return AudioProcessing.depreemphasis(raw, preemphasis)

    # -- scales (reference :334-339) -------------------------------------
    @staticmethod
    def amp_to_db(amp):
        return np.asarray(stft_ops.amp_to_db(amp))

    @staticmethod
    def db_to_amp(db):
        return np.asarray(stft_ops.db_to_amp(db))
