"""Model handler: the training/inference engine.

Capability parity with ``ModularModelHandlerPyTorch.py`` (:42-1019):
model create/save/load with config.json + ``params_{e<N>|s<N>|best|last}``
checkpoint layout (:71-262), ``layer_map`` regex renaming (:264-283),
``ignore_layers`` partial loading (:285-309), optimiser/scheduler
factories (:553-656), the epoch loop ``process_dataloader`` (:683-882),
batched ``inference`` (:964-993), EMA (:57,672-681), gradient clipping
and inf-replacement (:807-818, 898-910).

Design: the train step is one jit-compiled pure function (forward,
masked losses, grads, optax update, EMA) specialised per batch bucket
shape; data parallelism is a 1-D ``jax.sharding.Mesh`` with the batch
sharded over the ``data`` axis and parameters replicated — XLA inserts
the gradient all-reduce (no DataParallel scatter / gather, no remainder
dropping).
"""

import contextlib
import glob
import json
import logging
import os
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from idiaptts_tpu.data.dataset import collate_batch
from idiaptts_tpu.models.config import ModelConfig
from idiaptts_tpu.train.model_handler_base import ModelHandler
from idiaptts_tpu.utils import serialization
from idiaptts_tpu.train.schedulers import create_scheduler

logger = logging.getLogger(__name__)

_null_ctx = contextlib.nullcontext


class ExponentialMovingAverage:
    """Shadow parameter EMA (ExponentialMovingAverage.py:13-45 role)."""

    def __init__(self, params, decay=0.9999):
        self.decay = decay
        self.shadow = jax.tree_util.tree_map(jnp.copy, params)
        # One fused jitted program instead of per-leaf eager dispatches
        # every training step.
        self._update = jax.jit(
            lambda shadow, params: jax.tree_util.tree_map(
                lambda s, p: s * decay + (1.0 - decay) * p,
                shadow, params))

    def update(self, params):
        self.shadow = self._update(self.shadow, params)


class ModularModelHandler(ModelHandler):
    """Backend engine for one model."""

    def __init__(self):
        self.model = None
        self.model_config = None
        self.params = None
        self.batch_stats = None
        self.optimiser = None
        self.opt_state = None
        self.scheduler = None
        self.losses = []
        self.ema = None
        self.model_type = None
        self.dim_in = None
        self.dim_out = None
        self.mesh = None
        self.total_steps = 0
        # "msgpack" (single-file blobs) or "orbax" (directory
        # checkpoints; saves sharded multi-device arrays natively).
        self.checkpoint_backend = "msgpack"
        # "auto" trains through the GSPMD step; True selects the
        # explicit shard_map step.
        self.use_shard_map = "auto"
        self._train_step_fn = None
        self._eval_step_fn = None
        self._infer_fn = None
        self._shmap_steps = {}
        self._rng = jax.random.PRNGKey(42)

    # -- mesh / sharding --------------------------------------------------
    def setup_mesh(self, num_devices=None, axis_name="data",
                   model_parallel=1, use_shard_map="auto"):
        """Build the device mesh the engine trains over.

        ``model_parallel=1``: 1-D data-parallel mesh (the reference's
        DataParallel role, ModularModelHandlerPyTorch.py:731-735).
        ``model_parallel=M``: 2-D ``(data, model)`` mesh — weights'
        trailing dims shard over the ``model`` axis
        (tensor parallelism), batches over ``data``; GSPMD inserts the
        collectives.

        ``use_shard_map``: ``True`` trains through an explicit
        ``jax.shard_map`` per-device program instead of a GSPMD-sharded
        jit (1-D mesh only); "auto" and ``False`` use the GSPMD step,
        which keeps dropout bit-identical to one device."""
        devices = jax.devices()
        if num_devices is not None:
            devices = devices[:num_devices]
        model_parallel = model_parallel or 1
        if model_parallel > 1:
            num = len(devices)
            if num % model_parallel:
                raise ValueError(
                    "model_parallel={} does not divide {} devices"
                    .format(model_parallel, num))
            grid = np.array(devices).reshape(num // model_parallel,
                                             model_parallel)
            self.mesh = Mesh(grid, (axis_name, "model"))
            self.model_axis = "model"
        else:
            self.mesh = Mesh(np.array(devices), (axis_name,))
            self.model_axis = None
        self.axis_name = axis_name
        self.use_shard_map = use_shard_map
        self._shmap_steps = {}
        if self.params is not None:
            self._apply_param_shardings()
        return self.mesh

    def _apply_param_shardings(self):
        """Place parameters on the mesh — tensor-parallel over the
        ``model`` axis when present, replicated otherwise — and rebuild
        any state derived from them (optimiser via ``init`` inherits
        each param's sharding through ``zeros_like``; EMA shadows;
        compiled steps)."""
        if self.mesh is None:
            return
        if self.model_axis:
            from idiaptts_tpu.parallel.mesh import make_param_shardings
            shardings = make_param_shardings(self.params, self.mesh,
                                             self.model_axis)
            self.params = jax.tree_util.tree_map(
                lambda x, s: jax.device_put(x, s), self.params,
                shardings)
        else:
            repl = NamedSharding(self.mesh, P())
            self.params = jax.tree_util.tree_map(
                lambda x: jax.device_put(x, repl), self.params)
        if self.optimiser is not None:
            self.opt_state = self.optimiser.init(self.params)
        if self.ema is not None:
            self.ema = ExponentialMovingAverage(self.params,
                                                self.ema.decay)
        self._train_step_fn = None
        self._eval_step_fn = None
        self._infer_fn = None
        self._shmap_steps = {}

    @property
    def _data_axis_size(self):
        if self.mesh is None:
            return 1
        return dict(zip(self.mesh.axis_names,
                        self.mesh.devices.shape))[self.axis_name]

    def _shard_batch(self, batch):
        if self.mesh is None or len(self.mesh.devices.flat) == 1:
            return batch
        sharding = NamedSharding(self.mesh, P(self.axis_name))
        num = self._data_axis_size

        def put(x):
            if isinstance(x, np.ndarray) and x.ndim >= 1 \
                    and x.shape[0] % num == 0:
                return jax.device_put(x, sharding)
            return x
        return {k: put(v) if not isinstance(v, dict) else v
                for k, v in batch.items()}

    # -- model creation ---------------------------------------------------
    def create_model(self, model_config, hparams=None, dim_in=None,
                     dim_out=None, example_batch=None):
        self.model_config = model_config
        self.model = model_config.create_model()
        self.dim_in, self.dim_out = dim_in, dim_out
        if example_batch is not None:
            self.init_params(example_batch)
        return self.model

    def init_params(self, example_batch, seed=1234):
        rng = jax.random.PRNGKey(seed)
        data, lengths = self._batch_to_model_input(example_batch)
        variables = self.model.init(
            {"params": rng, "dropout": rng, "latent": rng},
            data, lengths=lengths, training=True)
        self.params = variables["params"]
        self.batch_stats = variables.get("batch_stats")
        return self.params

    @staticmethod
    def _batch_to_model_input(batch):
        data = {k: jnp.asarray(v) for k, v in batch.items()
                if not k.startswith("_")
                or k.startswith("_seq_mask")}
        lengths_dict = batch.get("_lengths")
        lengths = None
        if lengths_dict:
            arrays = {k: jnp.asarray(v) for k, v in lengths_dict.items()}
            if len(arrays) == 1:
                lengths = next(iter(arrays.values()))
            else:
                # Multi-rate batches keep per-feature lengths; modules
                # select their own via ``select_lengths`` (per-reader
                # lengths of prepare_batch,
                # ModularModelHandlerPyTorch.py:388-465).
                lengths = arrays
        return data, lengths

    # -- optimiser / scheduler / losses -----------------------------------
    def set_optimiser(self, hparams):
        name = hparams.get("optimiser_type", "Adam")
        args = dict(hparams.get("optimiser_args", {}) or {})
        lr = hparams.get("learning_rate")
        if lr is None:
            lr = args.pop("lr", 1e-3)
        else:
            args.pop("lr", None)
        self.base_lr = lr
        chain = []
        frozen = hparams.get("frozen_layers") or ()
        if frozen:
            # Zero the gradients of matching parameter paths BEFORE
            # clipping/Adam: frozen parameters then contribute nothing
            # to the clip norm and accumulate no optimiser moments, so
            # their updates are exactly zero (transfer-learning /
            # adaptation freezing, e.g. SSW'19 VTLN: freeze the
            # average-voice pre-net, train only the warp layer).
            def _frozen_mask(tree, _patterns=tuple(frozen)):
                flat = serialization.flatten_dict(tree, sep="/")
                return serialization.unflatten_dict(
                    {path: any(re.search(p, path) for p in _patterns)
                     for path in flat}, sep="/")
            chain.append(optax.masked(optax.set_to_zero(),
                                      _frozen_mask))
        if hparams.get("grad_clip_norm_type") is not None \
                and hparams.get("grad_clip_max_norm") is not None:
            chain.append(optax.clip_by_global_norm(
                hparams.grad_clip_max_norm))
        if hparams.get("grad_clip_thresh") is not None:
            chain.append(optax.clip(hparams.grad_clip_thresh))
        if name == "Adam":
            opt = optax.inject_hyperparams(optax.adam)(
                learning_rate=lr, **args)
        elif name == "SGD":
            opt = optax.inject_hyperparams(optax.sgd)(
                learning_rate=lr, **args)
        elif callable(name):
            opt = name(lr)
        else:
            raise NotImplementedError("Unknown optimiser " + str(name))
        chain.append(opt)
        self.optimiser = optax.chain(*chain)
        self._opt_index = len(chain) - 1
        if self.params is not None:
            self.opt_state = self.optimiser.init(self.params)
        self.replace_inf_grads_by_zero = hparams.get(
            "replace_inf_grads_by_zero", False)
        self._train_step_fn = None

    def set_scheduler(self, hparams):
        self.scheduler = create_scheduler(
            hparams.get("scheduler_type", "default"), self.base_lr,
            hparams.get("scheduler_args", {}), hparams)
        opt_index = getattr(self, "_opt_index", None)
        if self.scheduler is not None and self.opt_state is not None \
                and opt_index is not None \
                and not hasattr(self.opt_state[opt_index],
                                "hyperparams"):
            logger.warning(
                "Scheduler %s configured but the optimiser was built "
                "without inject_hyperparams (callable optimiser_type) "
                "— the learning rate cannot be updated per step and "
                "will stay at %s.",
                hparams.get("scheduler_type"), self.base_lr)
        self.iterations_per_scheduler_step = hparams.get(
            "iterations_per_scheduler_step")
        self.epochs_per_scheduler_step = hparams.get(
            "epochs_per_scheduler_step")

    def _current_lr(self):
        """LR for the upcoming train step.  With
        ``iterations_per_scheduler_step=N`` the scheduler advances once
        every N iterations (run_scheduler :927-951 semantics), so
        step-indexed schedules are indexed by the number of scheduler
        steps taken rather than the raw iteration count."""
        if self.scheduler is None:
            return self.base_lr
        if self.iterations_per_scheduler_step:
            t = (self.total_steps + 1) // self.iterations_per_scheduler_step
            # Epoch-style schedulers (Exponential) advance on the
            # scheduler-step count too; on_epoch is a no-op for
            # step-indexed ones (Noam, ExtendedExponential).
            self.scheduler.on_epoch(t)
            return self.scheduler.lr(t)
        return self.scheduler.lr(self.total_steps + 1)

    def set_losses(self, loss_configs):
        self.losses = [c.create_loss() for c in loss_configs]

    def set_ema(self, hparams):
        decay = hparams.get("ema_decay")
        if decay is None and hparams.get("exponential_moving_average"):
            decay = hparams.get("exponential_moving_average_decay", 0.9999)
        if decay:
            self.ema = ExponentialMovingAverage(self.params, decay)

    # -- jit steps --------------------------------------------------------
    def _apply_model(self, params, batch_stats, batch_data, lengths,
                     rngs, training):
        """Model forward; returns (flat_out, out, new_batch_stats).
        ``flat_out`` is the output dict plus flattened intermediates —
        the namespace the losses read from."""
        variables = {"params": params}
        mutable = ["intermediates"]
        if batch_stats is not None:
            variables["batch_stats"] = batch_stats
            if training:
                mutable.append("batch_stats")
        out, updates = self.model.apply(
            variables, batch_data, lengths=lengths, training=training,
            rngs=rngs, mutable=mutable)
        # Surface VAE intermediates for the KLD loss.
        inter = updates.get("intermediates", {}) if updates else {}
        flat_out = dict(out)
        for key, value in _flatten_intermediates(inter).items():
            flat_out[key] = value
            # Bare leaf alias for single-instance intermediates
            # (losses reference e.g. "vae_mu"); never shadows a model
            # output or an earlier alias.
            flat_out.setdefault(key.rsplit("/", 1)[-1], value)
        return flat_out, out, \
            (updates.get("batch_stats") if updates else None)

    def _losses_total(self, flat_out, step):
        total = 0.0
        loss_values = {}
        backprop = getattr(self, "backprop_loss_names", None)
        for loss in self.losses:
            value = loss(flat_out, step)
            loss_values[loss.name] = value
            # backprop_loss_names (get_summed_losses_subset role,
            # ModularModelHandlerPyTorch.py:915-925): losses outside
            # the subset are computed and logged but excluded from the
            # optimised total (monitor-only).
            if backprop is None or loss.name in backprop:
                total = total + value
        return total, loss_values

    def _loss_fn(self, params, batch_stats, batch_data, lengths, rngs,
                 step, training):
        flat_out, out, new_stats = self._apply_model(
            params, batch_stats, batch_data, lengths, rngs, training)
        total, loss_values = self._losses_total(flat_out, step)
        return total, (loss_values, out, new_stats)

    def _make_train_step(self):
        optimiser = self.optimiser

        # Donate params/opt_state buffers: the caller immediately
        # replaces them, and donation lets XLA update in place instead
        # of allocating + copying the whole parameter set every step.
        @partial(jax.jit, donate_argnums=(0, 2))
        def train_step(params, batch_stats, opt_state, batch_data,
                       lengths, rng, step, lr):
            rngs = {"dropout": rng, "latent": rng}
            (total, (loss_values, _, new_stats)), grads = \
                jax.value_and_grad(self._loss_fn, has_aux=True)(
                    params, batch_stats, batch_data, lengths, rngs, step,
                    True)
            if self.replace_inf_grads_by_zero:
                grads = jax.tree_util.tree_map(
                    lambda g: jnp.where(jnp.isfinite(g), g, 0.0), grads)
            opt_state = _set_lr(opt_state, self._opt_index, lr)
            updates, opt_state = optimiser.update(grads, opt_state,
                                                  params)
            params = optax.apply_updates(params, updates)
            grad_norm = optax.global_norm(grads)
            return params, opt_state, total, loss_values, grad_norm, \
                new_stats

        return train_step

    # -- shard_map data-parallel step --------------------------------------
    def _shard_map_enabled(self):
        """True when training should go through the explicit per-device
        shard_map program (see :meth:`setup_mesh`).  Pure data-parallel
        1-D meshes only — tensor-parallel weights genuinely shard and
        need GSPMD."""
        if (self.mesh is None or self.model_axis
                or self._data_axis_size < 2):
            return False
        return self.use_shard_map is True

    def _get_shmap_step(self, data, lengths):
        """shard_map train step for this batch's sharding pattern, or
        None when a batch leaf cannot shard (non-divisible leading dim:
        per-device shapes would disagree — the GSPMD step handles those
        batches)."""
        num = self._data_axis_size
        for v in data.values():
            if not (getattr(v, "ndim", 0) >= 1 and v.shape[0] % num == 0):
                return None
        if isinstance(lengths, dict):
            for v in lengths.values():
                if v.shape[0] % num:
                    return None
            lengths_spec = {k: P(self.axis_name) for k in lengths}
            lkey = tuple(sorted(lengths))
        elif lengths is None:
            lengths_spec = P()
            lkey = None
        else:
            if lengths.shape[0] % num:
                return None
            lengths_spec = P(self.axis_name)
            lkey = "*"
        key = (tuple(sorted(data)), lkey)
        fn = self._shmap_steps.get(key)
        if fn is None:
            batch_spec = {k: P(self.axis_name) for k in data}
            fn = self._make_train_step_shard_map(batch_spec, lengths_spec)
            self._shmap_steps[key] = fn
        return fn

    def _make_train_step_shard_map(self, batch_spec, lengths_spec):
        """Data-parallel train step as an explicit ``jax.shard_map``.

        Each device runs a single-device program on its batch shard.
        Exactness vs the GSPMD step: the per-device forward's outputs
        (plus intermediates) are all-gathered before the losses run,
        so every device evaluates the losses on the FULL batch — global
        mask denominators included — and the loss/grads/update equal
        the GSPMD program's, not an average of per-shard means.  The
        all-gather moves model *outputs* only (B·T·D_out floats, ~2 MB
        at the headline shape), never activations; its VJP is the
        matching reduce-scatter, and the final grad ``psum`` makes each
        device's shard-restricted gradient global.  Dropout masks are
        drawn per shard (rng folded with the axis index) — statistically
        identical to, but not bit-equal with, the single-trace GSPMD
        masks."""
        optimiser = self.optimiser
        axis = self.axis_name

        def body(params, batch_stats, opt_state, batch_data, lengths,
                 rng, step, lr):
            rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
            rngs = {"dropout": rng, "latent": rng}

            def loss_fn(p):
                flat_out, _, new_stats = self._apply_model(
                    p, batch_stats, batch_data, lengths, rngs, True)
                gathered = {
                    k: (jax.lax.all_gather(v, axis, axis=0, tiled=True)
                        if getattr(v, "ndim", 0) >= 1 else v)
                    for k, v in flat_out.items()}
                total, loss_values = self._losses_total(gathered, step)
                return total, (loss_values, new_stats)

            (total, (loss_values, new_stats)), grads = \
                jax.value_and_grad(loss_fn, has_aux=True)(params)
            # pmean, not psum: every device seeds the SAME replicated
            # loss adjoint, so the all_gather transpose (psum_scatter)
            # already sums ndev identical cotangents into each shard's
            # output cotangent — device d's grad is ndev * (shard d's
            # true contribution).  The cross-device mean therefore
            # yields exactly sum_d(contribution_d) = the global grad.
            grads = jax.lax.pmean(grads, axis)
            if self.replace_inf_grads_by_zero:
                grads = jax.tree_util.tree_map(
                    lambda g: jnp.where(jnp.isfinite(g), g, 0.0), grads)
            opt_state = _set_lr(opt_state, self._opt_index, lr)
            updates, opt_state = optimiser.update(grads, opt_state,
                                                  params)
            params = optax.apply_updates(params, updates)
            grad_norm = optax.global_norm(grads)
            if new_stats is not None:
                # BatchNorm running stats: mean of the per-shard
                # updates (batch-mean statistics over equal shards).
                new_stats = jax.tree_util.tree_map(
                    lambda s: jax.lax.pmean(s, axis), new_stats)
            return params, opt_state, total, loss_values, grad_norm, \
                new_stats

        shmap = jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P(), P(), P(), batch_spec, lengths_spec,
                      P(), P(), P()),
            out_specs=(P(), P(), P(), P(), P(), P()),
            check_vma=False)
        return partial(jax.jit, donate_argnums=(0, 2))(shmap)

    def _make_eval_step(self):
        @jax.jit
        def eval_step(params, batch_stats, batch_data, lengths, step):
            total, (loss_values, out, _) = self._loss_fn(
                params, batch_stats, batch_data, lengths,
                {"dropout": jax.random.PRNGKey(0),
                 "latent": jax.random.PRNGKey(0)}, step, False)
            return total, loss_values, out
        return eval_step

    # -- epoch processing -------------------------------------------------
    def process_batches(self, batches, training=True, step_offset=None,
                        current_epoch=None):
        """Run one pass over collated batches; returns mean total loss
        and per-loss means (process_dataloader :683-882 role)."""
        if training and self._train_step_fn is None:
            self._train_step_fn = self._make_train_step()
        if not training and self._eval_step_fn is None:
            self._eval_step_fn = self._make_eval_step()
        totals, counts = {}, 0
        total_sum = 0.0
        for batch in batches:
            batch = self._shard_batch(batch)
            data, lengths = self._batch_to_model_input(batch)
            if training:
                self._rng, rng = jax.random.split(self._rng)
                lr = self._current_lr()
                step_fn = self._train_step_fn
                if self._shard_map_enabled():
                    shmap_fn = self._get_shmap_step(data, lengths)
                    if shmap_fn is not None:
                        step_fn = shmap_fn
                # step/lr as traced scalars: python ints would retrace
                # the jitted step every iteration.
                (self.params, self.opt_state, total, loss_values,
                 grad_norm, new_stats) = step_fn(
                    self.params, self.batch_stats, self.opt_state,
                    data, lengths, rng, jnp.asarray(self.total_steps),
                    jnp.asarray(lr, jnp.float32))
                if new_stats is not None:
                    self.batch_stats = new_stats
                if self.ema is not None:
                    self.ema.update(self.params)
                self.total_steps += 1
            else:
                total, loss_values, _ = self._eval_step_fn(
                    self.params, self.batch_stats, data, lengths,
                    jnp.asarray(self.total_steps))
            total = float(total)
            if np.isnan(total):
                if training:
                    raise ValueError("Loss is NaN.")
                logger.warning("NaN loss in evaluation.")
            total_sum += total
            for name, value in loss_values.items():
                totals[name] = totals.get(name, 0.0) + float(value)
            counts += 1
        if counts == 0:
            return np.nan, {}
        return total_sum / counts, {k: v / counts
                                    for k, v in totals.items()}

    def inference(self, batch):
        """Forward without training; returns output dict as numpy
        (inference :964-993 role).

        The apply is jit-compiled and cached per batch bucket shape —
        the bucketed collate keeps the shape set small, so after warmup
        every synth/benchmark/forward batch reuses a compiled program
        instead of dispatching eagerly op by op."""
        if self._infer_fn is None:
            def infer(variables, data, lengths):
                return self.model.apply(variables, data, lengths=lengths,
                                        training=False, mutable=False)
            self._infer_fn = jax.jit(infer)
        params = self.ema.shadow if self.ema is not None else self.params
        data, lengths = self._batch_to_model_input(batch)
        variables = {"params": params}
        if self.batch_stats is not None:
            variables["batch_stats"] = self.batch_stats
        out = self._infer_fn(variables, data, lengths)
        return {k: np.asarray(v) for k, v in out.items()
                if not isinstance(v, (list, dict))}

    # -- checkpointing ----------------------------------------------------
    def save_checkpoint(self, directory, model_name=None, epoch=None,
                        step=None, best=False, last=False,
                        best_loss=None, networks_dir="nn"):
        """Write config.json + params_* (+optimiser/scheduler state)
        (save_checkpoint :71-123 layout)."""
        out_dir = os.path.join(directory, model_name or "",
                               networks_dir)
        os.makedirs(out_dir, exist_ok=True)
        if self.model_config is not None:
            with open(os.path.join(out_dir, "config.json"), "w") as f:
                f.write(self.model_config.to_json())
        suffixes = []
        if epoch is not None:
            suffixes.append("e{}".format(epoch))
        if step is not None:
            suffixes.append("s{}".format(step))
        if best:
            suffixes.append("best")
        if last:
            suffixes.append("last")
        params_to_save = self.params
        state = {"params": params_to_save,
                 "batch_stats": self.batch_stats}
        if self.ema is not None:
            # Reference semantics: EMA params are what a checkpoint
            # serves for inference (ModularModelHandlerPyTorch
            # :102-106) — but the RAW optimised params ride along so a
            # resumed run continues from the weights the optimiser
            # moments belong to (load_checkpoint restores both).
            state = {"params": self.ema.shadow,
                     "raw_params": self.params,
                     "batch_stats": self.batch_stats}
        def atomic_write(path, blob, mode="wb"):
            # Write-then-rename so a crash or concurrent reader never
            # sees a truncated checkpoint; the temporary name is per
            # process because every process of a multi-process run
            # writes the same files.
            tmp = "{}.tmp{}".format(path, os.getpid())
            with open(tmp, mode) as f:
                f.write(blob)
            os.replace(tmp, path)

        if self.checkpoint_backend == "orbax":
            import orbax.checkpoint as ocp
            ckptr = ocp.PyTreeCheckpointer()
            tree = {"state": serialization.to_state_dict(state),
                    "meta": {"best_loss": best_loss,
                             "total_steps": self.total_steps}}
            if self.opt_state is not None:
                tree["opt_state"] = _to_serialisable(
                    serialization.to_state_dict(self.opt_state))
            for suffix in suffixes:
                ckptr.save(os.path.abspath(
                    os.path.join(out_dir, "params_" + suffix)),
                    tree, force=True)
                if self.scheduler is not None:
                    atomic_write(
                        os.path.join(out_dir, "scheduler_" + suffix),
                        json.dumps(_jsonable(self.scheduler.state_dict())),
                        mode="w")
            return out_dir

        params_blob = serialization.to_bytes(state)
        opt_blob_bytes = None
        if self.opt_state is not None:
            opt_blob_bytes = serialization.msgpack_serialize(
                _to_serialisable({
                    "opt_state": serialization.to_state_dict(
                        self.opt_state),
                    "best_loss": best_loss,
                    "total_steps": self.total_steps,
                }))
        for suffix in suffixes:
            atomic_write(os.path.join(out_dir, "params_" + suffix),
                         params_blob)
            if opt_blob_bytes is not None:
                atomic_write(os.path.join(out_dir,
                                          "optimiser_" + suffix),
                             opt_blob_bytes)
            if self.scheduler is not None:
                atomic_write(
                    os.path.join(out_dir, "scheduler_" + suffix),
                    json.dumps(_jsonable(self.scheduler.state_dict())),
                    mode="w")
        return out_dir

    def load_checkpoint(self, directory, model_name=None, epoch=None,
                        step=None, best=False, last=False,
                        load_optimiser=True, load_scheduler=True,
                        ignore_layers=(), layer_map=(),
                        networks_dir="nn"):
        """Load params (+opt/scheduler); returns (best_loss, epoch,
        total_steps) bookkeeping (load_checkpoint :125-262 role)."""
        out_dir = os.path.join(directory, model_name or "",
                               networks_dir)
        if epoch is not None:
            suffix = "e{}".format(epoch)
        elif step is not None:
            suffix = "s{}".format(step)
        elif best:
            suffix = "best"
        elif last:
            suffix = "last"
        else:
            suffix = self._newest_suffix(out_dir)
        path = os.path.join(out_dir, "params_" + suffix)
        if self.model is None:
            config_path = os.path.join(out_dir, "config.json")
            with open(config_path) as f:
                self.model_config = ModelConfig.from_json(f.read())
            self.model = self.model_config.create_model()
        orbax_tree = None
        if os.path.isdir(path):                       # orbax directory
            import orbax.checkpoint as ocp
            orbax_tree = ocp.PyTreeCheckpointer().restore(
                os.path.abspath(path))
            raw = orbax_tree["state"]
            if self.params is not None and "raw_params" not in raw:
                state = serialization.from_state_dict(
                    {"params": self.params,
                     "batch_stats": self.batch_stats}, raw)
            else:
                state = raw
        else:
            with open(path, "rb") as f:
                blob = f.read()
            # Restore without a template: checkpoints may carry
            # optional keys (raw_params next to the EMA params) and
            # every consumer below re-materialises leaves with
            # jnp.asarray anyway.
            state = serialization.msgpack_restore(blob)
        new_params = state["params"]
        # EMA checkpoints: "params" is the inference shadow;
        # "raw_params" (when present) are the optimised weights the
        # optimiser moments belong to — use them for resume and seed
        # the EMA shadow from the saved average.
        raw_params = state.get("raw_params") \
            if isinstance(state, dict) else None
        if raw_params is not None and load_optimiser:
            shadow = new_params
            new_params = raw_params
            if self.ema is not None:
                self.ema.shadow = jax.tree_util.tree_map(jnp.asarray,
                                                         shadow)
        if layer_map:
            new_params = _apply_layer_map(new_params, layer_map)
        if ignore_layers and self.params is not None:
            new_params = _merge_ignored(new_params, self.params,
                                        ignore_layers)
        self.params = jax.tree_util.tree_map(jnp.asarray, new_params)
        if state.get("batch_stats") is not None:
            self.batch_stats = jax.tree_util.tree_map(
                jnp.asarray, state["batch_stats"])
        best_loss, total_epoch = None, None
        if orbax_tree is not None:
            meta = orbax_tree.get("meta") or {}
            best_loss = meta.get("best_loss")
            if best_loss is not None:
                best_loss = float(best_loss)
            self.total_steps = int(meta.get("total_steps", 0) or 0)
            if load_optimiser and self.optimiser is not None \
                    and orbax_tree.get("opt_state") is not None:
                try:
                    self.opt_state = serialization.from_state_dict(
                        self.optimiser.init(self.params),
                        orbax_tree["opt_state"])
                except (KeyError, ValueError) as e:
                    logger.warning("Optimiser state mismatch, "
                                   "reinitialised: %s", e)
                    self.opt_state = self.optimiser.init(self.params)
        opt_path = os.path.join(out_dir, "optimiser_" + suffix)
        if os.path.isfile(opt_path):
            # best_loss/total_steps metadata lives in the optimiser
            # sidecar; read it even when the optimiser STATE is not
            # wanted (resume via load_newest must not clobber a better
            # params_best with the resumed run's first validation).
            with open(opt_path, "rb") as f:
                opt_blob = serialization.msgpack_restore(f.read())
            best_loss = opt_blob.get("best_loss")
            if isinstance(best_loss, np.ndarray):
                best_loss = float(best_loss)
            self.total_steps = int(opt_blob.get("total_steps", 0) or 0)
            if load_optimiser and self.optimiser is not None:
                try:
                    self.opt_state = \
                        serialization.from_state_dict(
                            self.optimiser.init(self.params),
                            opt_blob["opt_state"])
                except (KeyError, ValueError) as e:
                    logger.warning("Optimiser state mismatch, "
                                   "reinitialised: %s", e)
                    self.opt_state = self.optimiser.init(self.params)
        sched_path = os.path.join(out_dir, "scheduler_" + suffix)
        if load_scheduler and os.path.isfile(sched_path) \
                and self.scheduler is not None:
            with open(sched_path) as f:
                try:
                    self.scheduler.load_state_dict(json.load(f))
                except Exception as e:  # tolerated with warning
                    logger.warning("Scheduler state mismatch: %s", e)
        match = re.match(r"e(\d+)", suffix)
        if match:
            total_epoch = int(match.group(1))
        self._train_step_fn = None
        self._eval_step_fn = None
        self._infer_fn = None
        return best_loss, total_epoch, self.total_steps

    @staticmethod
    def _newest_suffix(out_dir):
        candidates = [p for p in glob.glob(
            os.path.join(out_dir, "params_*"))
            if not re.search(r"\.tmp\d*$", p)
            and "checkpoint-tmp" not in p]       # orbax in-progress dirs
        if not candidates:
            raise FileNotFoundError("No checkpoint in " + out_dir)
        newest = max(candidates, key=os.path.getctime)
        return os.path.basename(newest)[len("params_"):]


def _flatten_intermediates(tree, prefix=""):
    """Flatten sown intermediates to '<module path>/<leaf>' keys —
    full paths keep same-named leaves from different submodules (two
    VAE branches both sowing 'vae_mu') from clobbering each other."""
    out = {}
    if isinstance(tree, dict):
        for key, value in tree.items():
            qualified = prefix + "/" + key if prefix else key
            out.update(_flatten_intermediates(value, qualified))
    elif isinstance(tree, (tuple, list)):
        if len(tree) > 0:
            out[prefix] = tree[0]
    else:
        out[prefix] = tree
    return out


def _set_lr(opt_state, opt_index, lr):
    inner = opt_state[opt_index]
    if hasattr(inner, "hyperparams"):
        new_hp = dict(inner.hyperparams)
        new_hp["learning_rate"] = jnp.asarray(lr, jnp.float32)
        inner = inner._replace(hyperparams=new_hp)
        opt_state = opt_state[:opt_index] + (inner,) \
            + opt_state[opt_index + 1:]
    return opt_state


def _apply_layer_map(params, layer_map):
    """Regex rename of parameter paths (load_checkpoint :264-283)."""
    flat = serialization.flatten_dict(params, sep="/")
    renamed = {}
    for path, value in flat.items():
        new_path = path
        for pattern, replacement in layer_map:
            new_path = re.sub(pattern, replacement, new_path)
        renamed[new_path] = value
    return serialization.unflatten_dict(renamed, sep="/")


def _merge_ignored(new_params, current_params, ignore_layers):
    """Keep current values for parameters matching ignore patterns
    (load_checkpoint :285-309)."""
    flat_new = serialization.flatten_dict(new_params, sep="/")
    flat_cur = serialization.flatten_dict(current_params, sep="/")
    merged = {}
    for path in flat_cur:
        ignored = any(re.search(pattern, path)
                      for pattern in ignore_layers)
        if ignored or path not in flat_new:
            merged[path] = flat_cur[path]
        else:
            merged[path] = flat_new[path]
    return serialization.unflatten_dict(merged, sep="/")


def _to_serialisable(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jnp.ndarray) else x,
        tree)


def _jsonable(d):
    out = {}
    for key, value in d.items():
        if isinstance(value, (np.floating, np.integer)):
            value = value.item()
        if isinstance(value, (int, float, str, bool, type(None), list)):
            out[key] = value
        elif isinstance(value, float) or value == np.inf:
            out[key] = float(value)
    return out
