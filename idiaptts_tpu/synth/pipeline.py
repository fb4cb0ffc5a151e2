"""Fused batched label->waveform synthesis pipeline.

The production-serving path: acoustic model forward, optional
denormalisation, MLPG trajectory smoothing (banded system factorised
ONCE per length bucket), mcep decode, and WORLD harmonic+noise
synthesis — compiled as ONE jit program per bucket, so a batch of
utterances costs a single device round trip.  `bench.py` measures this
path at several hundred times real time per chip.

Role: the composition that the reference performs across
``ModularTrainer.synth`` -> ``WorldFeatLabelGen.postprocess_sample`` ->
``Synthesiser.run_world_synth`` (each stage a host round trip there).
"""

import numpy as np

from idiaptts_tpu.ops import mcep as mcep_ops


def _vocode_one(coded, lf0, vuv, bap, f0_cont, key, fs, hop, num_bins,
                alpha, max_harmonics):
    """One utterance's WORLD vocoder body (traced inside jit; shared by
    FusedAcousticPipeline and BatchedWorldSynth)."""
    import jax.numpy as jnp
    from idiaptts_tpu.ops.world.d4c import decode_aperiodicity
    from idiaptts_tpu.ops.world.synthesis import (_harmonic_part_mcep,
                                                  _noise_part)
    # Cap lf0 before exp: a divergent model prediction otherwise
    # overflows to inf (above-Nyquist pitch is meaningless anyway).
    f0 = jnp.where(vuv, jnp.exp(jnp.minimum(lf0, jnp.log(fs / 2.0))),
                   0.0)
    # Harmonic amplitudes evaluated straight from the coded features
    # (no 513-bin envelope render / re-cepstrum on this path).
    harm = _harmonic_part_mcep(f0, f0_cont, coded, bap, fs, hop,
                               alpha, max_harmonics)
    # Noise shaping on a coarse grid: the target spectrum (order-20
    # mcep envelope x band-interpolated ap) has no structure finer than
    # ~400 Hz, so 129 bins (n_fft 256 vs 1024) lose nothing and cut
    # the noise path's FFT work 4x.  The grid must still cover one hop
    # (n_fft = 2*(nb-1) >= hop) so the noise overlap-add window fits —
    # large hops (48 kHz / 10 ms -> 480 samples) raise it as needed.
    nb_small = max(min(num_bins, 129), hop // 2 + 1 + (hop % 2))
    amp_small = mcep_ops.mcep_to_amp_sp(coded, nb_small, alpha)
    ap_small = decode_aperiodicity(bap, nb_small, fs)
    noise = _noise_part(f0, amp_small ** 2, ap_small, fs, hop, key)
    return harm + noise


class FusedAcousticPipeline:
    """questions (B, T, D) -> waveforms (B, T*hop) in one program.

    Args:
      model_apply: callable ``(questions_b, lengths_b) -> (B, T, C)``
        producing cmp-ordered features ``[sp(3*D)|lf0(3)|vuv|bap(3*N)]``.
      variances: per-stream MLPG variances — dict with keys ``sp``
        (3*D,), ``lf0`` (3,), ``bap`` (3*num_bap,).
      mean/scale: optional denormalisation applied to the model output
        before MLPG (cmp ordering).
      num_coded_sps: mcep order + 1 (D).
      fs, frame_shift_ms: synthesis rate.
      mlpg_kernel: None runs the MLPG substitutions as the Triton
        kernel on a single GPU and as scans elsewhere; True/False
        forces one (``ops/mlpg.py:mlpg_solve``).
    """

    def __init__(self, model_apply, variances, num_coded_sps, fs=16000,
                 frame_shift_ms=5.0, num_bap=1, mean=None, scale=None,
                 max_harmonics=112, bucket=256, num_bins=513,
                 mesh=None, data_axis="data", post_filter=False,
                 mgc_alpha=None, mlpg_kernel=None):
        """With ``mesh`` (a 1-D ``jax.sharding.Mesh``), serving scales
        out over chips: the batch shards over ``data_axis`` on its
        leading dim, parameters replicate, and each chip synthesises
        its shard — no collectives on the forward path."""
        import jax
        import jax.numpy as jnp
        from idiaptts_tpu.ops.mlpg import mlpg_factorise, mlpg_solve

        self._jax = jax
        self._jnp = jnp
        self.model_apply = model_apply
        self.num_coded_sps = int(num_coded_sps)
        self.num_bap = int(num_bap)
        self.fs = int(fs)
        self.hop = int(fs * frame_shift_ms / 1000.0)
        self.bucket = int(bucket)
        self._factor_cache = {}
        self._key_cache = {}
        self._mlpg_factorise = mlpg_factorise
        D = self.num_coded_sps
        NB = self.num_bap
        # cmp order -> MLPG fused order [statics | deltas | ddeltas].
        var_sp = np.asarray(variances["sp"], np.float32)
        var_lf0 = np.asarray(variances["lf0"], np.float32)
        var_bap = np.asarray(variances["bap"], np.float32)
        self._perm_var = jnp.asarray(np.concatenate([
            var_sp[:D], var_lf0[:1], var_bap[:NB],
            var_sp[D:2 * D], var_lf0[1:2], var_bap[NB:2 * NB],
            var_sp[2 * D:], var_lf0[2:], var_bap[2 * NB:]]))
        if (mean is None) != (scale is None):
            raise ValueError(
                "FusedAcousticPipeline needs BOTH mean and scale for "
                "denormalisation (got only one)")
        self._mean = None if mean is None else jnp.asarray(mean,
                                                           jnp.float32)
        self._scale = None if scale is None else jnp.asarray(
            scale, jnp.float32)
        alpha = mgc_alpha if mgc_alpha is not None \
            else mcep_ops.fs_to_mgc_alpha(fs)
        F = D + 1 + NB  # fused MLPG feature dim

        # The pipeline as three composable stages; ``run`` fuses them
        # into one jit program, ``stage_jits`` exposes them separately
        # so bench.py can localise throughput regressions per stage.
        def model_stage(params, questions_b, lengths_b):
            out = model_apply(params, questions_b, lengths_b)
            if self._mean is not None:
                out = out * self._scale + self._mean
            return out

        def mlpg_stage(out, lengths_b, factors, tau):
            sp_blk = out[..., :3 * D]
            lf0_blk = out[..., 3 * D:3 * D + 3]
            vuv_b = out[..., 3 * D + 3] > 0.5
            bap_blk = out[..., 3 * D + 4:]
            fused = jnp.concatenate([
                sp_blk[..., :D], lf0_blk[..., :1], bap_blk[..., :NB],
                sp_blk[..., D:2 * D], lf0_blk[..., 1:2],
                bap_blk[..., NB:2 * NB],
                sp_blk[..., 2 * D:], lf0_blk[..., 2:],
                bap_blk[..., 2 * NB:]], axis=-1)
            smoothed = mlpg_solve(fused, factors, tau, F,
                                  kernel=mlpg_kernel)
            # Silence the padded tail (same hazard as in
            # BatchedWorldSynth.__call__): whatever the model predicts
            # on zero-padded questions must not synthesise audio that
            # bleeds into the valid frames via the noise overlap-add.
            t_idx = jnp.arange(smoothed.shape[1])
            valid = t_idx[None, :] < lengths_b[:, None]
            silent = jnp.zeros((smoothed.shape[-1],),
                               smoothed.dtype).at[0].set(-100.0)
            smoothed = jnp.where(valid[..., None], smoothed, silent)
            vuv_b = vuv_b & valid
            return smoothed, vuv_b

        def vocoder_stage(smoothed, vuv_b, f0_cont_b, key):
            def per_utt(sm, vuv, f0_cont):
                coded = sm[:, :D]
                if post_filter:
                    coded = mcep_ops.merlin_post_filter(coded, alpha)
                return _vocode_one(coded, sm[:, D],
                                   vuv, sm[:, D + 1:D + 1 + NB],
                                   f0_cont, key, fs, self.hop, num_bins,
                                   alpha, max_harmonics)

            return jax.vmap(per_utt)(smoothed, vuv_b, f0_cont_b)

        def run(params, questions_b, lengths_b, f0_cont_b, factors,
                tau, key):
            out = model_stage(params, questions_b, lengths_b)
            smoothed, vuv_b = mlpg_stage(out, lengths_b, factors, tau)
            return vocoder_stage(smoothed, vuv_b, f0_cont_b, key)

        def run_pcm(params, questions_b, lengths_b, f0_cont_b, factors,
                    tau, key):
            # Loudness-norm + PCM16 encode ON DEVICE: the wav-file
            # surface (trainer.synth) then moves int16 device->host —
            # half the bytes of float32, and no host-side numpy pass.
            # Matches audio_io.float_to_pcm16 +
            # synthesiser._norm_loudness (peak-normalise only above
            # 0.85) bit-for-bit on finite inputs.
            wavs = run(params, questions_b, lengths_b, f0_cont_b,
                       factors, tau, key)
            peak = jnp.max(jnp.abs(wavs), axis=1, keepdims=True)
            wavs = wavs * jnp.where(peak > 0.85, 0.85 / peak, 1.0)
            wavs = jnp.nan_to_num(wavs, nan=0.0, posinf=1.0,
                                  neginf=-1.0)
            return (jnp.clip(wavs, -1.0, 1.0)
                    * 32767.0).astype(jnp.int16)

        def rebuild_padded(flat_f32, lengths_b, T):
            # Rebuild the padded (B, T, D) batch from concatenated
            # un-padded frames with a row gather (index sumT = an
            # appended zero row for the padding).
            flat_f32 = jnp.concatenate(
                [flat_f32,
                 jnp.zeros((1, flat_f32.shape[-1]), jnp.float32)])
            offs = jnp.concatenate(
                [jnp.zeros((1,), jnp.int32),
                 jnp.cumsum(lengths_b)[:-1].astype(jnp.int32)])
            t_idx = jnp.arange(T, dtype=jnp.int32)
            idx = jnp.where(t_idx[None, :] < lengths_b[:, None],
                            offs[:, None] + t_idx[None, :],
                            flat_f32.shape[0] - 1)
            return flat_f32[idx]

        def run_pcm_packed(params, flat, lengths_b, f0_cont_b,
                           factors, tau, key, B, T):
            # Packed-transfer variant: ``flat`` is the CONCATENATED
            # un-padded question frames (sumT, D) — zero padding to the
            # bucket is typically 3-6x the real payload.
            questions_b = rebuild_padded(flat, lengths_b, T)
            return run_pcm(params, questions_b, lengths_b, f0_cont_b,
                           factors, tau, key)

        def run_pcm_bits(params, packed, lo, hi, numeric, lengths_b,
                         f0_cont_b, factors, tau, key, B, T, inv_perm,
                         nb):
            # Bit-packed transfer: HTS question answers are binary
            # (two-valued per column even after mean/std
            # normalisation), so the host ships them 1 BIT per value
            # (np.packbits rows) plus each packed column's two values
            # (lo, hi) and the few genuinely numeric columns (subphone
            # features / continuous questions) in f32 — far fewer h2d
            # bytes than the dense stream, and EXACT: reconstruction is
            # a select between the original f32 values, not
            # arithmetic.  ``inv_perm`` is a static tuple so the
            # column restore compiles to a constant gather.
            shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
            bits = (packed[:, :, None] >> shifts) & jnp.uint8(1)
            bits = bits.reshape(packed.shape[0], -1)[:, :nb]
            vals = jnp.where(bits > 0, hi[None, :], lo[None, :])
            full = jnp.concatenate(
                [vals, numeric.astype(jnp.float32)], axis=1)
            full = jnp.take(full, jnp.asarray(inv_perm, jnp.int32),
                            axis=1)
            questions_b = rebuild_padded(full, lengths_b, T)
            return run_pcm(params, questions_b, lengths_b, f0_cont_b,
                           factors, tau, key)

        self._stage_fns = (model_stage, mlpg_stage, vocoder_stage)
        self._stage_jits = None

        self.mesh = mesh
        self._batch_sharding = None
        self._run_shmap = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            self._batch_sharding = NamedSharding(mesh, P(data_axis))
            self._replicated = NamedSharding(mesh, P())
            # shard_map variant: the forward path has NO collectives
            # (each device synthesises its batch shard), so running the
            # per-device program explicitly is semantically identical
            # to the GSPMD jit.
            self._run_shmap = jax.jit(jax.shard_map(
                run, mesh=mesh,
                in_specs=(P(), P(data_axis), P(data_axis),
                          P(data_axis), P(), P(), P()),
                out_specs=P(data_axis), check_vma=False))
        self._run = jax.jit(run)
        self._run_pcm = jax.jit(run_pcm)
        self._run_pcm_packed = jax.jit(run_pcm_packed,
                                       static_argnames=("B", "T"))
        self._run_pcm_bits = jax.jit(
            run_pcm_bits, static_argnames=("B", "T", "inv_perm", "nb"))
        # Bit-packed h2d for two-valued (question) columns.  Exact, so
        # it is on for every backend; set False to ship dense f32.
        self.pack_bits = True

    def stage_jits(self):
        """Individually jitted (model, mlpg, vocoder) stage functions —
        the profiling view of the fused ``run`` program (bench.py's
        per-stage breakdown)."""
        if self._stage_jits is None:
            self._stage_jits = tuple(self._jax.jit(f)
                                     for f in self._stage_fns)
        return self._stage_jits

    def _default_f0_cont(self, B, T):
        key = (B, T)
        cache = getattr(self, "_f0_cont_cache", None)
        if cache is None:
            cache = self._f0_cont_cache = {}
        if key not in cache:
            cache[key] = self._jnp.full((B, T), 150.0,
                                        self._jnp.float32)
        return cache[key]

    def _prng_key(self, seed):
        # PRNGKey construction dispatches a device op; serving calls
        # reuse a handful of seeds, so cache the key arrays.
        key = self._key_cache.get(seed)
        if key is None:
            key = self._jax.random.PRNGKey(seed)
            if len(self._key_cache) > 64:
                self._key_cache.clear()
            self._key_cache[seed] = key
        return key

    def _factors_for(self, T):
        if T not in self._factor_cache:
            self._factor_cache[T] = self._mlpg_factorise(
                self._perm_var, self.num_coded_sps + 1 + self.num_bap,
                T)
        return self._factor_cache[T]

    def __call__(self, params, questions, lengths=None, f0_cont=None,
                 seed=0, device_output=False, pcm16=False):
        """questions: list of (T_i, D) arrays or one (B, T, D) array.
        Returns a list of (T_i * hop,) float32 waveforms trimmed to the
        true lengths — or, with ``device_output``, the untrimmed
        (B, T*hop) device array (skips the device->host transfer; use
        when the consumer is another device computation).  With
        ``pcm16`` the waveforms come back loudness-normalised int16
        (encode on device, half the transfer bytes) ready for wav
        writing."""
        jnp = self._jnp
        if isinstance(questions, (list, tuple)):
            lengths = np.array([len(q) for q in questions], np.int32)
            T = int(np.ceil(max(lengths) / self.bucket) * self.bucket)
            if pcm16:
                # Packed transfer: concatenated un-padded frames — the
                # h2d payload drops by the payload/padding ratio; the
                # padded batch is rebuilt on device inside the jit.  One
                # group, one dispatch, one fetch.
                if device_output:
                    raise ValueError("pcm16 output is host-side only")
                B = len(questions)
                factors, tau = self._factors_for(T)
                key = self._prng_key(seed)
                flat = np.concatenate(
                    [np.asarray(q, np.float32) for q in questions])
                if f0_cont is None:
                    f0_cont = self._default_f0_cont(B, T)
                # Bit-pack the two-valued columns (HTS question
                # answers stay two-valued through mean/std
                # normalisation) when they dominate: 1 bit/value +
                # per-column (lo, hi), EXACT (on-device select between
                # the original f32 values).  Column split recomputed
                # per call — a column that stops being two-valued just
                # reroutes to the dense path (the jit keys on the
                # static split).
                lo = flat.min(axis=0)
                hi = flat.max(axis=0)
                two_valued = np.logical_or(flat == lo, flat == hi) \
                    .all(axis=0)
                if (self.pack_bits
                        and two_valued.sum() >= flat.shape[1] // 2):
                    bin_idx = np.where(two_valued)[0]
                    num_idx = np.where(~two_valued)[0]
                    perm = np.concatenate([bin_idx, num_idx])
                    inv_perm = tuple(int(i) for i in np.argsort(perm))
                    packed = np.packbits(
                        flat[:, bin_idx] == hi[bin_idx], axis=1)
                    numeric = np.ascontiguousarray(flat[:, num_idx])
                    wavs = np.asarray(self._run_pcm_bits(
                        params, jnp.asarray(packed),
                        jnp.asarray(lo[bin_idx]),
                        jnp.asarray(hi[bin_idx]),
                        jnp.asarray(numeric), jnp.asarray(lengths),
                        jnp.asarray(f0_cont), factors, tau, key,
                        B=B, T=T, inv_perm=inv_perm,
                        nb=int(len(bin_idx))))
                    return [wavs[i, :int(l) * self.hop]
                            for i, l in enumerate(lengths)]
                wavs = np.asarray(self._run_pcm_packed(
                    params, jnp.asarray(flat), jnp.asarray(lengths),
                    jnp.asarray(f0_cont), factors, tau, key,
                    B=B, T=T))
                return [wavs[i, :int(l) * self.hop]
                        for i, l in enumerate(lengths)]
            batch = np.zeros((len(questions), T, questions[0].shape[-1]),
                             np.float32)
            for i, q in enumerate(questions):
                batch[i, :len(q)] = q
        else:
            # Device arrays pass through untouched (np.asarray would
            # force a device->host round trip).
            batch = questions if hasattr(questions, "devices") \
                else np.asarray(questions, np.float32)
            T = batch.shape[1]
            if lengths is None:
                lengths = np.full(batch.shape[0], T, np.int32)
        factors, tau = self._factors_for(T)
        if f0_cont is None:
            f0_cont = self._default_f0_cont(batch.shape[0], T)
        key = self._prng_key(seed)
        batch_d = jnp.asarray(batch)
        f0_cont_d = jnp.asarray(f0_cont)
        if pcm16:
            if device_output or (self._batch_sharding is not None
                                 and batch_d.shape[0]
                                 % self.mesh.devices.size == 0):
                raise ValueError("pcm16 output is host-side and "
                                 "single-device only")
            wavs = np.asarray(self._run_pcm(
                params, batch_d, jnp.asarray(lengths), f0_cont_d,
                factors, tau, key))
            return [wavs[i, :int(l) * self.hop]
                    for i, l in enumerate(lengths)]
        if self._batch_sharding is not None \
                and batch_d.shape[0] % self.mesh.devices.size == 0:
            put = self._jax.device_put
            batch_d = put(batch_d, self._batch_sharding)
            f0_cont_d = put(f0_cont_d, self._batch_sharding)
            params = self._jax.tree_util.tree_map(
                lambda x: put(x, self._replicated), params)
            wavs = self._run_shmap(params, batch_d, jnp.asarray(lengths),
                                   f0_cont_d, factors, tau, key)
        else:
            wavs = self._run(params, batch_d,
                             jnp.asarray(lengths), f0_cont_d,
                             factors, tau, key)
        if device_output:
            return wavs
        wavs = np.asarray(wavs)
        return [wavs[i, :int(l) * self.hop]
                for i, l in enumerate(lengths)]


class BatchedWorldSynth:
    """Batched WORLD synthesis from postprocessed statics: one jit
    program per length bucket turns (B, T, D+2+NB) ``[coded_sp | lf0 |
    vuv | bap]`` into (B, T*hop) waveforms — a single device round trip
    for the whole batch instead of the reference's per-utterance
    mgc2sp/decode_ap/synthesize hops (Synthesiser.py:38-80).

    This is the vocoder back half of :class:`FusedAcousticPipeline`,
    exposed for the reference-surface ``Synthesiser.run_world_synth``
    path (``trainer.synth``/``copy_synth``)."""

    def __init__(self, num_coded_sps, fs=16000, frame_shift_ms=5.0,
                 num_bap=1, post_filter=False, max_harmonics=112,
                 bucket=256, mgc_alpha=None):
        import jax
        import jax.numpy as jnp

        self._jax = jax
        self._jnp = jnp
        self.fs = int(fs)
        self.hop = int(fs * frame_shift_ms / 1000.0)
        self.bucket = int(bucket)
        D = self.num_coded_sps = int(num_coded_sps)
        NB = self.num_bap = int(num_bap)
        alpha = mgc_alpha if mgc_alpha is not None \
            else mcep_ops.fs_to_mgc_alpha(fs)
        num_bins = mcep_ops.fs_to_frame_length(fs) // 2 + 1

        def run(feats, f0_cont_b, key):
            coded = feats[..., :D]
            lf0 = feats[..., D]
            vuv_b = feats[..., D + 1] > 0.5
            bap = feats[..., D + 2:D + 2 + NB]
            if post_filter:
                coded = mcep_ops.merlin_post_filter(coded, alpha)

            def per_utt(coded_u, lf0_u, vuv_u, bap_u, f0_cont):
                return _vocode_one(coded_u, lf0_u, vuv_u, bap_u,
                                   f0_cont, key, fs, self.hop, num_bins,
                                   alpha, max_harmonics)

            return jax.vmap(per_utt)(coded, lf0, vuv_b, bap, f0_cont_b)

        self._run = jax.jit(run)

    def __call__(self, samples, seed=0):
        """samples: list of (T_i, D+2+NB) static-feature arrays.
        Returns a list of (T_i * hop,) float32 waveforms."""
        jnp = self._jnp
        if not samples:
            return []
        lengths = np.array([len(s) for s in samples], np.int32)
        T = int(np.ceil(max(lengths) / self.bucket) * self.bucket)
        batch = np.zeros((len(samples), T, samples[0].shape[-1]),
                         np.float32)
        for i, s in enumerate(samples):
            batch[i, :len(s)] = s
            # Silence the padded tail: all-zero features decode to a
            # FULL-SCALE aperiodic frame (mcep c=0 -> amplitude 1,
            # bap 0 -> ap 1) whose noise bleeds into the valid tail
            # through the overlap-add window.
            batch[i, len(s):, 0] = -100.0
        f0_cont = jnp.full((len(samples), T), 150.0, jnp.float32)
        key = self._jax.random.PRNGKey(seed)
        wavs = np.asarray(self._run(jnp.asarray(batch), f0_cont, key))
        return [wavs[i, :int(l) * self.hop]
                for i, l in enumerate(lengths)]
