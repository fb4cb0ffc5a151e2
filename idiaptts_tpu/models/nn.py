"""A small module system in plain JAX.

Models are written in the declarative style of ``flax.linen``: a module
is a dataclass of hyper-parameters whose ``__call__`` creates parameters
with ``self.param`` and calls submodules built inline.  ``init`` and
``apply`` turn such a module into pure functions of a variables dict
``{"params": ..., "batch_stats": ..., "intermediates": ...}``.

The naming and random-number rules are those of ``flax.linen`` 0.12, so
parameter trees, checkpoints and initial values are the same as the
ones the package produced when it was built on flax:

- a submodule built inside ``__call__`` is named ``name=`` or
  ``<ClassName>_<n>`` (counted per class within the parent call); a
  module held in a dataclass field is named after the field
  (``<field>_<i>`` inside a tuple);
- each scope folds its name into the parent's keys, and
  ``make_rng(stream)`` folds in a per-scope counter (SHA-1 of the static
  path, ``fold_in`` of its first four bytes).

Only what the package's models use is implemented.
"""

import dataclasses
import functools
import hashlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

initializers = jax.nn.initializers

relu = jax.nn.relu
sigmoid = jax.nn.sigmoid
selu = jax.nn.selu
leaky_relu = jax.nn.leaky_relu
soft_sign = jax.nn.soft_sign


@dataclasses.dataclass(frozen=True)
class DenyList:
    """Mutability filter: every collection except ``deny``."""

    deny: tuple


def _fold_in_static(key, data):
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    hash_int = int.from_bytes(m.digest()[:4], byteorder="big")
    return jax.random.fold_in(key, jnp.uint32(hash_int))


def _in_filter(col, flt):
    if isinstance(flt, bool):
        return flt
    if isinstance(flt, str):
        return col == flt
    if isinstance(flt, DenyList):
        return not _in_filter(col, flt.deny)
    return col in flt


class _State:
    """What one ``init``/``apply`` call shares across its scopes."""

    def __init__(self, variables, mutable, initializing):
        self.variables = {col: _copy_tree(tree)
                          for col, tree in (variables or {}).items()}
        self.mutable = mutable
        self.initializing = initializing
        self.counters = {}


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


class Scope:
    """A path in the variables tree plus the random streams at that
    path."""

    def __init__(self, state, path, rngs):
        self.state = state
        self.path = path
        self.rngs = rngs                      # stream -> (key, suffix)

    def push(self, name):
        return Scope(self.state, self.path + (name,),
                     {k: (key, suffix + (name,))
                      for k, (key, suffix) in self.rngs.items()})

    def make_rng(self, stream):
        if stream not in self.rngs:
            if "params" not in self.rngs:
                raise ValueError("{} needs a PRNG key for {!r}".format(
                    "/".join(self.path) or "<root>", stream))
            stream = "params"
        counters = self.state.counters.setdefault(self.path, {})
        counters[stream] = counters.get(stream, 0) + 1
        key, suffix = self.rngs[stream]
        return _fold_in_static(key, suffix + (counters[stream],))

    def _node(self, col, create):
        node = self.state.variables.get(col)
        if node is None:
            if not create:
                return None
            node = self.state.variables[col] = {}
        for name in self.path:
            child = node.get(name)
            if child is None:
                if not create:
                    return None
                child = node[name] = {}
            node = child
        return node

    def get(self, col, name):
        node = self._node(col, False)
        return None if node is None else node.get(name)

    def put(self, col, name, value):
        if not self.is_mutable(col):
            raise ValueError("collection {!r} is not mutable here "
                             "({})".format(col, "/".join(self.path)))
        self._node(col, True)[name] = value

    def is_mutable(self, col):
        return _in_filter(col, self.state.mutable)


class _Variable:
    def __init__(self, scope, col, name):
        self._scope, self._col, self._name = scope, col, name

    @property
    def value(self):
        return self._scope.get(self._col, self._name)

    @value.setter
    def value(self, v):
        self._scope.put(self._col, self._name, v)


class _Frame:
    """One running module call: its scope and the names handed out to
    the submodules it builds."""

    def __init__(self, module, scope):
        self.module = module
        self.scope = scope
        self.cursor = {}

    def autoname(self, prefix):
        n = self.cursor.get(prefix, 0)
        self.cursor[prefix] = n + 1
        return "{}_{}".format(prefix, n)

    def field_name(self, child):
        """Name of ``child`` if it is held in one of this module's
        dataclass fields (directly or in a tuple/list)."""
        if not dataclasses.is_dataclass(self.module):
            return None
        for f in dataclasses.fields(self.module):
            value = getattr(self.module, f.name, None)
            if value is child:
                return f.name
            if isinstance(value, (tuple, list)):
                for i, item in enumerate(value):
                    if item is child:
                        return "{}_{}".format(f.name, i)
        return None


_CONTEXT = threading.local()


def _frames():
    if not hasattr(_CONTEXT, "frames"):
        _CONTEXT.frames = []
    return _CONTEXT.frames


def _bind_call(fn):
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        frames = _frames()
        if not frames:
            raise RuntimeError(
                "{} must be run through init() or apply()".format(
                    type(self).__name__))
        return self._run(self._child_scope(frames[-1]), fn, args, kwargs)
    wrapper._unbound = fn
    return wrapper


@dataclasses.dataclass(eq=False)
class Module:
    """Base class: subclasses are dataclasses of hyper-parameters."""

    name: str = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "__call__" in cls.__dict__:
            cls.__call__ = _bind_call(cls.__dict__["__call__"])
        dataclasses.dataclass(cls, eq=False)

    def __post_init__(self):
        frames = _frames()
        parent = frames[-1] if frames else None
        object.__setattr__(self, "_parent_frame", parent)
        if parent is not None and self.name is None:
            self.name = parent.autoname(type(self).__name__)

    # -- binding ------------------------------------------------------------
    def _child_scope(self, parent):
        override = getattr(self, "_scope_override", None)
        if override is not None:
            return override
        own = getattr(self, "_parent_frame", None)
        if own is not None:
            return own.scope.push(self.name)
        name = parent.field_name(self) or self.name
        if name is None:
            name = parent.autoname(type(self).__name__)
            self.name = name
        return parent.scope.push(name)

    def _run(self, scope, fn, args, kwargs):
        frames = _frames()
        frames.append(_Frame(self, scope))
        try:
            return fn(self, *args, **kwargs)
        finally:
            frames.pop()

    def _scope(self):
        for frame in reversed(_frames()):
            if frame.module is self:
                return frame.scope
        raise RuntimeError("{} is not running".format(type(self).__name__))

    # -- inside a call --------------------------------------------------------
    def param(self, name, init_fn, *init_args):
        scope = self._scope()
        value = scope.get("params", name)
        if value is None:
            if not scope.is_mutable("params"):
                raise ValueError("missing parameter {!r} at {}".format(
                    name, "/".join(scope.path) or "<root>"))
            value = init_fn(scope.make_rng("params"), *init_args)
            scope.put("params", name, value)
        return value

    def variable(self, col, name, init_fn, *init_args):
        scope = self._scope()
        if scope.get(col, name) is None:
            scope.put(col, name, init_fn(*init_args))
        return _Variable(scope, col, name)

    def make_rng(self, stream="params"):
        return self._scope().make_rng(stream)

    def has_rng(self, stream):
        return stream in self._scope().rngs

    def is_initializing(self):
        return self._scope().state.initializing

    def sow(self, col, name, value):
        scope = self._scope()
        if not scope.is_mutable(col):
            return False
        scope.put(col, name, (scope.get(col, name) or ()) + (value,))
        return True

    # -- entry points ---------------------------------------------------------
    def _entry(self, variables, rngs, mutable, initializing, method, args,
               kwargs):
        if rngs is None:
            rngs = {}
        elif not isinstance(rngs, dict):
            rngs = {"params": rngs}
        state = _State(variables, mutable, initializing)
        root = Scope(state, (), {k: (v, ()) for k, v in rngs.items()})
        if method is None:
            fn = type(self).__call__._unbound
        elif isinstance(method, str):
            fn = getattr(type(self), method)
        else:
            fn = method
        fn = getattr(fn, "_unbound", fn)
        frames = _frames()
        frames.append(_Frame(self, root))
        try:
            out = fn(self, *args, **kwargs)
        finally:
            frames.pop()
        return out, state

    def init(self, rngs, *args, method=None,
             mutable=DenyList(("intermediates",)), **kwargs):
        _, state = self._entry({}, rngs, mutable, True, method, args,
                               kwargs)
        return {col: tree for col, tree in state.variables.items()
                if _in_filter(col, mutable)}

    def apply(self, variables, *args, rngs=None, method=None,
              mutable=False, **kwargs):
        out, state = self._entry(variables, rngs, mutable, False, method,
                                 args, kwargs)
        if mutable is False:
            return out
        return out, {col: tree for col, tree in state.variables.items()
                     if _in_filter(col, mutable)}


# -- layers --------------------------------------------------------------------

def promote_dtype(*args, dtype=None, inexact=True):
    if dtype is None:
        dtype = jnp.result_type(*[jnp.asarray(x) for x in args
                                  if x is not None])
        if inexact and not jnp.issubdtype(dtype, jnp.inexact):
            dtype = jnp.promote_types(jnp.float32, dtype)
    return [jnp.asarray(x, dtype) if x is not None else None for x in args]


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: object = None
    kernel_init: object = initializers.lecun_normal()
    bias_init: object = initializers.zeros

    def _create(self, in_features):
        kernel = self.param("kernel", self.kernel_init,
                            (in_features, self.features), jnp.float32)
        bias = self.param("bias", self.bias_init, (self.features,),
                          jnp.float32) if self.use_bias else None
        return kernel, bias

    def __call__(self, inputs):
        kernel, bias = self._create(jnp.shape(inputs)[-1])
        inputs, kernel, bias = promote_dtype(inputs, kernel, bias,
                                             dtype=self.dtype)
        y = lax.dot_general(inputs, kernel,
                            (((inputs.ndim - 1,), (0,)), ((), ())))
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


def _canonical_padding(padding, rank):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * rank
    out = []
    for p in padding:
        out.append((p, p) if isinstance(p, int) else tuple(p))
    return out


class Conv(Module):
    """Channels-last convolution, ``(batch, spatial..., features)``."""

    features: int
    kernel_size: object
    strides: object = 1
    padding: object = "SAME"
    kernel_dilation: object = 1
    feature_group_count: int = 1
    use_bias: bool = True
    dtype: object = None
    kernel_init: object = initializers.lecun_normal()
    bias_init: object = initializers.zeros

    def __call__(self, inputs):
        kernel_size = (self.kernel_size,) if isinstance(
            self.kernel_size, int) else tuple(self.kernel_size)
        rank = len(kernel_size)

        def broadcast(x):
            x = 1 if x is None else x
            return (x,) * rank if isinstance(x, int) else tuple(x)

        num_batch = inputs.ndim - (rank + 1)
        batch_shape = inputs.shape[:num_batch]
        if num_batch != 1:
            inputs = jnp.reshape(inputs, (-1,) + inputs.shape[num_batch:])
        padding = _canonical_padding(self.padding, rank)
        nd = inputs.ndim
        lhs_spec = (0, nd - 1) + tuple(range(1, nd - 1))
        dimension_numbers = lax.ConvDimensionNumbers(
            lhs_spec, (nd - 1, nd - 2) + tuple(range(0, nd - 2)), lhs_spec)
        in_features = inputs.shape[-1]
        kernel = self.param(
            "kernel", self.kernel_init,
            kernel_size + (in_features // self.feature_group_count,
                           self.features), jnp.float32)
        bias = self.param("bias", self.bias_init, (self.features,),
                          jnp.float32) if self.use_bias else None
        inputs, kernel, bias = promote_dtype(inputs, kernel, bias,
                                             dtype=self.dtype)
        y = lax.conv_general_dilated(
            inputs, kernel, window_strides=broadcast(self.strides),
            padding=padding, lhs_dilation=broadcast(1),
            rhs_dilation=broadcast(self.kernel_dilation),
            dimension_numbers=dimension_numbers,
            feature_group_count=self.feature_group_count)
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        if num_batch != 1:
            y = jnp.reshape(y, batch_shape + y.shape[1:])
        return y


class Embed(Module):
    num_embeddings: int
    features: int
    dtype: object = None
    embedding_init: object = initializers.variance_scaling(
        1.0, "fan_in", "normal", out_axis=0)

    def __call__(self, inputs):
        if not jnp.issubdtype(inputs.dtype, jnp.integer):
            raise ValueError("Input type must be an integer.")
        embedding = self.param("embedding", self.embedding_init,
                               (self.num_embeddings, self.features),
                               jnp.float32)
        (embedding,) = promote_dtype(embedding, dtype=self.dtype,
                                     inexact=False)
        if self.num_embeddings == 1:
            return jnp.broadcast_to(embedding,
                                    inputs.shape + (self.features,))
        return jnp.take(embedding, inputs, axis=0)


class Dropout(Module):
    rate: float
    deterministic: bool = None
    rng_collection: str = "dropout"

    def __call__(self, inputs, deterministic=None):
        deterministic = self.deterministic if deterministic is None \
            else deterministic
        if self.rate == 0.0 or deterministic:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep_prob = 1.0 - self.rate
        rng = self.make_rng(self.rng_collection)
        mask = jax.random.bernoulli(rng, p=keep_prob, shape=inputs.shape)
        return lax.select(mask, inputs / keep_prob, jnp.zeros_like(inputs))


class BatchNorm(Module):
    """Batch normalisation over every axis but ``axis``; running
    statistics live in the ``batch_stats`` collection."""

    use_running_average: bool = None
    axis: int = -1
    momentum: float = 0.99
    epsilon: float = 1e-5

    def __call__(self, x, use_running_average=None):
        use_ra = self.use_running_average if use_running_average is None \
            else use_running_average
        axis = self.axis % x.ndim
        reduction = tuple(i for i in range(x.ndim) if i != axis)
        feature_shape = (x.shape[axis],)
        ra_mean = self.variable("batch_stats", "mean",
                                lambda s: jnp.zeros(s, jnp.float32),
                                feature_shape)
        ra_var = self.variable("batch_stats", "var",
                               lambda s: jnp.ones(s, jnp.float32),
                               feature_shape)
        if use_ra:
            mean, var = ra_mean.value, ra_var.value
        else:
            xf = jnp.asarray(x, jnp.promote_types(jnp.float32, x.dtype))
            mean = jnp.mean(xf, reduction)
            mean2 = jnp.mean(lax.square(xf), reduction)
            var = jnp.maximum(0.0, mean2 - lax.square(mean))
            if not self.is_initializing():
                ra_mean.value = self.momentum * ra_mean.value \
                    + (1 - self.momentum) * mean
                ra_var.value = self.momentum * ra_var.value \
                    + (1 - self.momentum) * var
        scale = self.param("scale", initializers.ones, feature_shape,
                           jnp.float32)
        bias = self.param("bias", initializers.zeros, feature_shape,
                          jnp.float32)
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        y = x - mean.reshape(shape)
        mul = lax.rsqrt(var + self.epsilon) * scale
        y = y * mul.reshape(shape) + bias.reshape(shape)
        return jnp.asarray(y, jnp.result_type(x, scale))


# -- recurrent cells -----------------------------------------------------------

def _zero_carry(features, input_shape, n):
    shape = tuple(input_shape[:-1]) + (features,)
    carry = tuple(jnp.zeros(shape, jnp.float32) for _ in range(n))
    return carry if n > 1 else carry[0]


class OptimizedLSTMCell(Module):
    """LSTM cell with the ``ii``/``if``/.../``ho`` parameter layout; the
    four gates run as one matmul per operand."""

    features: int
    dtype: object = None

    def __call__(self, carry, inputs):
        c, h = carry
        ki, kh, bh = [], [], []
        for comp in "ifgo":
            kernel, _ = _DenseParams(self.features, use_bias=False,
                                     name="i" + comp)(inputs.shape[-1])
            ki.append(kernel)
            kernel, bias = _DenseParams(
                self.features, kernel_init=initializers.orthogonal(),
                name="h" + comp)(h.shape[-1])
            kh.append(kernel)
            bh.append(bias)
        inputs_, k_i = promote_dtype(inputs, jnp.concatenate(ki, axis=-1),
                                     dtype=self.dtype)
        h_, k_h, b_h = promote_dtype(h, jnp.concatenate(kh, axis=-1),
                                     jnp.concatenate(bh, axis=-1),
                                     dtype=self.dtype)
        gates = jnp.dot(h_, k_h) + b_h + jnp.dot(inputs_, k_i)
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        new_c = sigmoid(f) * c + sigmoid(i) * jnp.tanh(g)
        new_h = sigmoid(o) * jnp.tanh(new_c)
        return (new_c, new_h), new_h

    def initialize_carry(self, rng, input_shape):
        return _zero_carry(self.features, input_shape, 2)


class _DenseParams(Dense):
    """A Dense layer's (kernel, bias), created or read, not applied."""

    def __call__(self, in_features):
        return self._create(in_features)


class GRUCell(Module):
    features: int
    dtype: object = None

    def __call__(self, carry, inputs):
        h = carry

        def dense_i(name):
            return Dense(self.features, dtype=self.dtype, name=name)

        def dense_h(name, use_bias=False):
            return Dense(self.features, use_bias=use_bias, dtype=self.dtype,
                         kernel_init=initializers.orthogonal(), name=name)

        r = sigmoid(dense_i("ir")(inputs) + dense_h("hr")(h))
        z = sigmoid(dense_i("iz")(inputs) + dense_h("hz")(h))
        n = jnp.tanh(dense_i("in")(inputs) + r * dense_h("hn", True)(h))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h

    def initialize_carry(self, rng, input_shape):
        return _zero_carry(self.features, input_shape, 1)


class SimpleCell(Module):
    features: int
    activation_fn: object = jnp.tanh
    dtype: object = None

    def __call__(self, carry, inputs):
        new = Dense(self.features, dtype=self.dtype, name="i")(inputs) \
            + Dense(self.features, use_bias=False, dtype=self.dtype,
                    kernel_init=initializers.orthogonal(), name="h")(carry)
        new = self.activation_fn(new).astype(carry.dtype)
        return new, new

    def initialize_carry(self, rng, input_shape):
        return _zero_carry(self.features, input_shape, 1)


def flip_sequences(inputs, seq_lengths):
    """Reverse (B, T, ...) sequences within their lengths; the padding
    rotates to the tail."""
    T = inputs.shape[1]
    if seq_lengths is None:
        return jnp.flip(inputs, axis=1)
    idx = (jnp.arange(T - 1, -1, -1)[None, :] + seq_lengths[:, None]) % T
    idx = idx.reshape(idx.shape + (1,) * (inputs.ndim - 2))
    return jnp.take_along_axis(inputs, idx, axis=1)


def _scan_module(module, carry, xs, in_axes, out_axes, unroll=1):
    """``lax.scan`` of ``module(carry, x)`` over ``in_axes`` of ``xs``
    (an int for every leaf, or a tree of ints and ``broadcast``).
    Parameters are created before the loop, from the first step, so that
    none is created inside the traced body."""
    leaves, treedef = jax.tree_util.tree_flatten(xs)
    axes = [in_axes] * len(leaves) if isinstance(in_axes, int) \
        else treedef.flatten_up_to(in_axes)
    scanned = [jnp.moveaxis(x, a, 0) for x, a in zip(leaves, axes)
               if a is not broadcast]

    def rebuild(step_leaves):
        it = iter(step_leaves)
        return treedef.unflatten([x if a is broadcast else next(it)
                                  for x, a in zip(leaves, axes)])

    if _frames()[-1].scope.state.initializing:
        module(carry, rebuild([s[0] for s in scanned]))

    def body(c, step_leaves):
        return module(c, rebuild(step_leaves))

    carry, ys = lax.scan(body, carry, scanned, unroll=unroll)
    ys = jax.tree_util.tree_map(lambda y: jnp.moveaxis(y, 0, out_axes), ys)
    return carry, ys


class RNN(Module):
    """Runs a cell over the time axis of (B, T, D) inputs."""

    cell: Module
    reverse: bool = False
    keep_order: bool = False
    unroll: int = 1

    def __call__(self, inputs, seq_lengths=None):
        carry = self.cell.initialize_carry(None, inputs[:, 0].shape)
        if self.reverse:
            inputs = flip_sequences(inputs, seq_lengths)
        _, out = _scan_module(self.cell, carry, inputs, 1, 1, self.unroll)
        if self.reverse and self.keep_order:
            out = flip_sequences(out, seq_lengths)
        return out


broadcast = object()          # ``in_axes`` entry: pass the input whole


def scan(target, variable_broadcast="params", split_rngs=None, in_axes=0,
         out_axes=0):
    """Lift ``target`` (a module class called as ``(carry, x)``) to a
    module that loops it over ``in_axes`` with shared parameters.  The
    lifted module keeps the name it is given; its parameters sit under
    that name as if ``target`` itself had been called."""
    del variable_broadcast, split_rngs      # parameters are always shared

    def build(*args, name=None, **kwargs):
        return _Scanned(target, args, kwargs, in_axes, out_axes, name=name)
    return build


class _Scanned(Module):
    target: type
    args: tuple
    kwargs: dict
    in_axes: object
    out_axes: object

    def __call__(self, carry, xs):
        inner = self.target(*self.args, **self.kwargs)
        object.__setattr__(inner, "_scope_override", self._scope())
        in_axes = self.in_axes[0] if isinstance(self.in_axes, tuple) \
            and len(self.in_axes) == 1 else self.in_axes
        return _scan_module(inner, carry, xs, in_axes, self.out_axes)


def remat(fn):
    """Recompute ``fn(module, *args)`` in the backward pass instead of
    storing its activations.  Runs plainly while parameters are being
    created."""
    def wrapped(module, *args):
        if module.is_initializing():
            return fn(module, *args)
        return jax.checkpoint(lambda *a: fn(module, *a))(*args)
    return wrapped
