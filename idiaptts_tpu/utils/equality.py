"""Equality test utilities for params/checkpoints.

Capability parity with ``neural_networks/pytorch/utils.py`` (:13-118):
``equal_iterable``, ``equal_model`` (parameter pytrees), and
``equal_checkpoint`` (two checkpoint directories/suffixes), plus
``tensor_pad``.
"""

import os

import numpy as np


def equal_iterable(a, b, atol=0.0):
    """Deep equality over nested dicts/lists/arrays."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return False
        return all(equal_iterable(a[k], b[k], atol) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return False
        return all(equal_iterable(x, y, atol) for x, y in zip(a, b))
    try:
        a_arr = np.asarray(a)
        b_arr = np.asarray(b)
    except Exception:
        return a == b
    if a_arr.shape != b_arr.shape:
        return False
    if a_arr.dtype.kind in "OU" or b_arr.dtype.kind in "OU":
        return bool(np.all(a_arr == b_arr))
    return bool(np.allclose(a_arr, b_arr, atol=atol))


def equal_model(params_a, params_b, atol=0.0):
    """Parameter pytree equality (utils.equal_model role)."""
    import jax
    flat_a, tree_a = jax.tree_util.tree_flatten(params_a)
    flat_b, tree_b = jax.tree_util.tree_flatten(params_b)
    if tree_a != tree_b or len(flat_a) != len(flat_b):
        return False
    return all(np.asarray(x).shape == np.asarray(y).shape
               and np.allclose(np.asarray(x), np.asarray(y), atol=atol)
               for x, y in zip(flat_a, flat_b))


def equal_checkpoint(dir_a, suffix_a, dir_b, suffix_b, atol=0.0):
    """Compare two saved checkpoints (utils.equal_checkpoint :62-117
    role): params (+batch stats) loaded from
    ``<dir>/params_<suffix>``."""
    from idiaptts_tpu.utils.serialization import msgpack_restore

    def load(directory, suffix):
        with open(os.path.join(directory, "params_" + suffix),
                  "rb") as f:
            return msgpack_restore(f.read())

    return equal_iterable(load(dir_a, suffix_a), load(dir_b, suffix_b),
                          atol)


def tensor_pad(tensor, target_length, axis=0, value=0.0):
    """Pad along one axis to a target length (utils.tensor_pad role)."""
    tensor = np.asarray(tensor)
    pad = target_length - tensor.shape[axis]
    if pad <= 0:
        return tensor
    widths = [(0, 0)] * tensor.ndim
    widths[axis] = (0, pad)
    return np.pad(tensor, widths, constant_values=value)
