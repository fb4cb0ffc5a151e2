"""Checkpoint serialisation: pytrees <-> msgpack bytes.

The byte format is the one ``flax.serialization`` writes (arrays as
msgpack extension 1 holding ``(shape, dtype name, C-order bytes)``,
numpy scalars as extension 3, tuples and lists as ``{"0": ..., "1":
...}`` state dicts), so checkpoints written by either can be read by
the other.
"""

import msgpack
import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_state_dict(target):
    """Nested dicts of leaves: namedtuples by field, lists and tuples by
    index as string keys."""
    if isinstance(target, dict):
        return {str(k): to_state_dict(v) for k, v in target.items()}
    if _is_namedtuple(target):
        return {f: to_state_dict(getattr(target, f))
                for f in target._fields}
    if isinstance(target, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(target)}
    return target


def from_state_dict(target, state):
    """Inverse of :func:`to_state_dict`, shaped like ``target``."""
    if isinstance(target, dict):
        if set(map(str, target)) != set(state):
            raise ValueError("state keys {} do not match {}".format(
                sorted(state), sorted(map(str, target))))
        return {k: from_state_dict(v, state[str(k)])
                for k, v in target.items()}
    if _is_namedtuple(target):
        if set(target._fields) != set(state):
            raise ValueError("state fields {} do not match {}".format(
                sorted(state), target._fields))
        return type(target)(**{f: from_state_dict(getattr(target, f),
                                                  state[f])
                               for f in target._fields})
    if isinstance(target, (list, tuple)):
        if len(state) != len(target):
            raise ValueError("state has {} entries, target {}".format(
                len(state), len(target)))
        items = [from_state_dict(v, state[str(i)])
                 for i, v in enumerate(target)]
        return type(target)(items)
    return state


def _ndarray_to_bytes(arr):
    arr = np.asarray(arr)
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ndarray_from_bytes(data):
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        import ml_dtypes
        dtype = ml_dtypes.bfloat16
    else:
        dtype = np.dtype(dtype_name.decode())
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


def _ext_pack(x):
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(x))
    if isinstance(x, complex):
        return msgpack.ExtType(_EXT_COMPLEX,
                               msgpack.packb((x.real, x.imag)))
    if hasattr(x, "__array__") and hasattr(x, "dtype"):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    raise TypeError("cannot serialise {!r}".format(type(x)))


def _ext_unpack(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    return msgpack.ExtType(code, data)


def msgpack_serialize(state):
    """Serialise a state dict (nested dicts of arrays and scalars)."""
    return msgpack.packb(state, default=_ext_pack, strict_types=True)


def msgpack_restore(blob):
    """Read bytes written by :func:`msgpack_serialize`."""
    return msgpack.unpackb(blob, ext_hook=_ext_unpack, raw=False)


def to_bytes(target):
    return msgpack_serialize(to_state_dict(target))


def flatten_dict(tree, sep="/", prefix=""):
    """``{"a": {"b": x}}`` -> ``{"a/b": x}``."""
    out = {}
    for key, value in tree.items():
        path = prefix + sep + str(key) if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten_dict(value, sep, path))
        else:
            out[path] = value
    return out


def unflatten_dict(flat, sep="/"):
    tree = {}
    for path, value in flat.items():
        node = tree
        keys = path.split(sep)
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return tree
