"""Named-tensor-dict protocol helpers and wrapper modules.

Capability parity with ``models/NamedForwardModule.py`` (:41-59 gather
named inputs / merge / write named outputs, :116-137 merge types,
:140-149 time-dim broadcasting, :61-77 teacher-forcing input filtering)
and ``NamedForwardWrapper.py`` (:19-107), ``NamedForwardSplitter.py`` /
``NamedForwardCombiner.py``.

All modules operate batch-first (B, T, D) and
take a ``lengths`` vector (B,) for masking.
"""

from idiaptts_tpu.models import nn
import jax.numpy as jnp

from idiaptts_tpu.models.config import ModelConfig


def select_lengths(lengths, *names):
    """Per-feature lengths: ``lengths`` is either one (B,) vector (all
    features share a frame rate) or a dict ``{feature_name: (B,)}``
    (multi-rate batches — the reference's per-reader lengths in
    ``prepare_batch``, ModularModelHandlerPyTorch.py:388-465).  Modules
    select the vector of their first matching named feature."""
    if isinstance(lengths, dict):
        for name in names:
            if name is not None and name in lengths:
                return lengths[name]
        return next(iter(lengths.values())) if lengths else None
    return lengths


def broadcast_time(value, max_time):
    """(B, D) -> (B, 1, D) -> tiled (B, T, D); (B, T, D) passes through
    (NamedForwardModule.py:140-149 role)."""
    if value.ndim == 2:
        value = value[:, None, :]
    if value.shape[1] == 1 and max_time > 1:
        value = jnp.broadcast_to(
            value, (value.shape[0], max_time) + value.shape[2:])
    return value


def merge_inputs(data_dict, input_names, merge_type=ModelConfig.MERGE_CAT,
                 training=True, teacher_forcing_names=()):
    """Gather named inputs from the dict and merge them
    (NamedForwardModule.py:116-137 role)."""
    names = [n for n in input_names
             if training or n not in teacher_forcing_names]
    values = [jnp.asarray(data_dict[name]) for name in names]
    max_time = max((v.shape[1] if v.ndim > 2 else 1) for v in values)
    values = [broadcast_time(v, max_time) for v in values]
    if merge_type == ModelConfig.MERGE_LIST:
        return values
    if merge_type == ModelConfig.MERGE_CAT:
        return jnp.concatenate(values, axis=-1)
    stacked = values[0]
    for v in values[1:]:
        if merge_type == ModelConfig.MERGE_ADD:
            stacked = stacked + v
        elif merge_type in (ModelConfig.MERGE_MUL,
                            ModelConfig.MERGE_ATTENTION):
            stacked = stacked * v
        elif merge_type == ModelConfig.MERGE_MEAN:
            stacked = stacked + v
        else:
            raise NotImplementedError(merge_type)
    if merge_type == ModelConfig.MERGE_MEAN:
        stacked = stacked / len(values)
    elif merge_type == ModelConfig.MERGE_ATTENTION:
        # Attention pooling: weights ⊙ values summed over time, time dim
        # kept (NamedForwardModule.py:127-130, batch-first -> axis 1).
        stacked = jnp.sum(stacked, axis=1, keepdims=True)
    return stacked


def write_outputs(data_dict, output_names, output):
    """Write module output(s) back into the dict."""
    updated = dict(data_dict)
    if len(output_names) == 1:
        updated[output_names[0]] = output
    else:
        if not isinstance(output, (tuple, list)):
            raise ValueError("Multiple output names need multiple outputs")
        for name, value in zip(output_names, output):
            updated[name] = value
    return updated


class NamedForwardWrapper(nn.Module):
    """Wraps an inner module into the dict protocol
    (NamedForwardWrapper.py:19-107 role)."""

    wrapped: nn.Module
    input_names: tuple
    output_names: tuple
    input_merge_type: str = ModelConfig.MERGE_CAT
    teacher_forcing_input_names: tuple = ()

    def __call__(self, data_dict, lengths=None, training=False):
        inputs = merge_inputs(data_dict, self.input_names,
                              self.input_merge_type, training,
                              self.teacher_forcing_input_names)
        lengths = select_lengths(lengths, *self.input_names)
        output = self.wrapped(inputs, lengths=lengths, training=training)
        return write_outputs(data_dict, self.output_names, output)

    class Config(ModelConfig):
        def __init__(self, wrapped_model_config=None, **kwargs):
            super().__init__(**kwargs)
            self.wrapped_model_config = wrapped_model_config

        def create_model(self):
            return NamedForwardWrapper(
                wrapped=self.wrapped_model_config.create_model(),
                input_names=self.input_names,
                output_names=self.output_names,
                input_merge_type=self.input_merge_type,
                teacher_forcing_input_names=
                self.teacher_forcing_input_names)


class NamedForwardSplitter(nn.Module):
    """Splits one named tensor into several named parts along the
    feature axis (NamedForwardSplitter role)."""

    input_names: tuple
    output_names: tuple
    split_sizes: tuple

    def __call__(self, data_dict, lengths=None, training=False):
        value = merge_inputs(data_dict, self.input_names)
        updated = dict(data_dict)
        start = 0
        for name, size in zip(self.output_names, self.split_sizes):
            updated[name] = value[..., start:start + size]
            start += size
        return updated

    class Config(ModelConfig):
        def __init__(self, split_sizes=None, **kwargs):
            super().__init__(**kwargs)
            self.split_sizes = tuple(split_sizes)

        def create_model(self):
            return NamedForwardSplitter(input_names=self.input_names,
                                        output_names=self.output_names,
                                        split_sizes=self.split_sizes)


class NamedForwardCombiner(nn.Module):
    """Concatenates named tensors into one named output."""

    input_names: tuple
    output_names: tuple

    def __call__(self, data_dict, lengths=None, training=False):
        merged = merge_inputs(data_dict, self.input_names)
        return write_outputs(data_dict, self.output_names, merged)

    class Config(ModelConfig):
        def create_model(self):
            return NamedForwardCombiner(input_names=self.input_names,
                                        output_names=self.output_names)


class Sequential(nn.Module):
    """Runs several dict-protocol modules in order (the modular model
    graph used by ModularTrainer when several configs are given)."""

    modules_list: tuple

    def __call__(self, data_dict, lengths=None, training=False):
        for module in self.modules_list:
            data_dict = module(data_dict, lengths=lengths,
                               training=training)
        return data_dict

    class Config(ModelConfig):
        def __init__(self, module_configs=None, **kwargs):
            super().__init__(**kwargs)
            self.module_configs = list(module_configs or [])

        def create_model(self):
            return Sequential(modules_list=tuple(
                c.create_model() for c in self.module_configs))
