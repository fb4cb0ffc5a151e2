"""Device mesh utilities: data-parallel training over a device mesh.

The JAX replacement for the reference's single-node
``torch.nn.DataParallel`` (ModularModelHandlerPyTorch.py:731-735; see
SURVEY.md §2.8): a 1-D ``jax.sharding.Mesh`` over the ``data`` axis,
batches sharded on their leading dimension, parameters replicated.
``jax.jit`` with explicit in/out shardings makes XLA insert the gradient
all-reduce; no scatter/gather, no remainder-dropping collate.

Multi-host (DCN) extension: call ``jax.distributed.initialize()`` before
building the mesh and the same code spans slices.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_data_mesh(num_devices=None, axis_name="data"):
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (axis_name,))


def shard_batch(batch, mesh, axis_name="data"):
    """Put batch arrays on the mesh, sharded along the leading axis.
    Non-divisible or scalar entries are replicated."""
    num = mesh.devices.size
    data_sharding = NamedSharding(mesh, P(axis_name))
    replicated = NamedSharding(mesh, P())

    def put(x):
        x = np.asarray(x)
        if x.ndim >= 1 and x.shape[0] % num == 0:
            return jax.device_put(x, data_sharding)
        return jax.device_put(x, replicated)

    return jax.tree_util.tree_map(put, batch)


def replicate(tree, mesh):
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree)


def make_sharded_train_step(loss_fn, optimiser, mesh, axis_name="data"):
    """jit a data-parallel train step with explicit shardings.

    loss_fn(params, batch) -> scalar loss.  Params/opt state replicated,
    batch sharded over ``axis_name``; requesting replicated outputs
    makes XLA all-reduce the gradients.
    """
    repl = NamedSharding(mesh, P())

    @partial(jax.jit,
             out_shardings=(repl, repl, repl))
    def train_step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = optimiser.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def make_2d_mesh(num_devices=None, model_parallel=2,
                 axis_names=("data", "model")):
    """(data, model) mesh: batch over ``data``, tensor-parallel weight
    shards over ``model`` (the last mesh axis)."""
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    num = len(devices)
    assert num % model_parallel == 0, (num, model_parallel)
    grid = np.array(devices).reshape(num // model_parallel,
                                     model_parallel)
    return Mesh(grid, axis_names)


def make_param_shardings(params, mesh, axis_name="model",
                         min_shard_size=2):
    """Tensor-parallel sharding rules: shard each weight's trailing
    (output/hidden) dimension over ``axis_name`` when divisible,
    replicate otherwise.  GSPMD propagates the activations' shardings
    and inserts the matching collectives — no hand-written
    all-gathers."""
    size = dict(zip(mesh.axis_names, mesh.devices.shape))[axis_name]

    def rule(x):
        x = np.asarray(x) if not hasattr(x, "shape") else x
        if (x.ndim >= 2 and x.shape[-1] % size == 0
                and x.shape[-1] // size >= min_shard_size):
            return NamedSharding(
                mesh, P(*([None] * (x.ndim - 1) + [axis_name])))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map(rule, params)


def make_tp_train_step(loss_fn, optimiser):
    """jit a 2-D (data x model) parallel train step.

    Shardings ride on the inputs: device_put the params with
    :func:`make_param_shardings` (tensor-parallel over ``model``), build
    the optimiser state from those sharded params (``optax.init`` via
    ``zeros_like`` inherits each param's sharding), shard the batch over
    ``data`` with :func:`shard_batch`.  Gradients keep the params'
    model-axis sharding, so the optimiser update is shard-local and XLA
    all-reduces over the data axis only.
    """
    @jax.jit
    def train_step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = optimiser.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def initialise_multihost(coordinator_address=None, num_processes=None,
                         process_id=None):
    """Multi-host (DCN) initialisation: call before building the mesh
    and the same data-parallel code spans slices
    (jax.distributed.initialize wrapper; SURVEY.md §2.8)."""
    import jax
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes,
                      process_id=process_id)
    jax.distributed.initialize(**kwargs)
    return jax.devices()
