"""MLPG banded substitution as one Pallas kernel on the Triton route.

The factor-once fast path (:func:`idiaptts_tpu.ops.mlpg.mlpg_solve`)
solves ``L L^T x = b`` with the bandwidth-2 Cholesky factor of the
precision matrix.  The plain version is two ``lax.scan``s of T dependent
steps each; on a GPU every step of XLA's while loop is a kernel launch
or more for a few vector operations.  This kernel does the same 2T steps
inside one launch.

Layout: the system is (T, L) with L = batch x feature; the grid runs
over blocks of ``block`` lanes (a power of two) and each program walks
the 2T substitution steps in a ``fori_loop`` with the two previous rows
in registers.  The coefficient rows do not depend on the carry, so the
loop is unrolled a few rows at a time to issue their loads ahead.  The
intermediate solution y is kept in the output buffer: the backward pass
reads row t of y before it overwrites it with x.

The arithmetic is that of ``mlpg._solve_banded`` (divide by the
diagonal, same operation order).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_LANES = 32
NUM_WARPS = 1
UNROLL = 8


def _solve_kernel(b_ref, l0_ref, l1s_ref, l2s_ref, l1_ref, l2_ref,
                  out_ref):
    T = b_ref.shape[0]
    zero = jnp.zeros(b_ref.shape[1:], jnp.float32)

    def forward_row(t, y_m1, y_m2):
        y = (b_ref[t, :] - l1s_ref[t, :] * y_m1
             - l2s_ref[t, :] * y_m2) / l0_ref[t, :]
        out_ref[t, :] = y
        return y

    def backward_row(t, x_p1, x_p2):
        x = (out_ref[t, :] - l1_ref[t, :] * x_p1
             - l2_ref[t, :] * x_p2) / l0_ref[t, :]
        out_ref[t, :] = x
        return x

    def run(row, order):
        # UNROLL rows per loop iteration (written out: the Triton route
        # lowers fori_loop only with unroll=1), then the remainder.
        def block(i, carry):
            c1, c2 = carry
            for r in range(UNROLL):
                c1, c2 = row(order(i * UNROLL + r), c1, c2), c1
            return c1, c2

        carry = jax.lax.fori_loop(0, T // UNROLL, block, (zero, zero))
        for t in range(T // UNROLL * UNROLL, T):
            carry = row(order(t), *carry), carry[0]

    run(forward_row, lambda t: t)
    run(backward_row, lambda t: T - 1 - t)


def use_solve_kernel():
    """The kernel runs on a single-GPU trace; every other backend (also
    a CPU device chosen with ``jax.default_device``), and a
    multi-device program, takes the plain scans."""
    device = jax.config.jax_default_device
    if device is None:
        platform = jax.default_backend()
    else:
        platform = device if isinstance(device, str) else device.platform
    return platform == "gpu" and jax.device_count() == 1


@partial(jax.jit, static_argnames=("interpret",))
def solve_banded_pallas(b, l0, l1, l2, interpret=False):
    """Solve ``L L^T x = b``; all operands (T, L) float32, factors tiled
    to the L lanes.  Returns (T, L).

    The lanes are padded to a multiple of ``BLOCK_LANES`` with an
    identity system (l0 = 1, off-diagonals 0, b = 0), which solves to
    zeros."""
    T, L = b.shape
    block = BLOCK_LANES
    pad = (-L) % block
    lanes = ((0, 0), (0, pad))
    b = jnp.pad(b.astype(jnp.float32), lanes)
    l0 = jnp.pad(l0, lanes, constant_values=1.0)
    l1 = jnp.pad(l1, lanes)
    l2 = jnp.pad(l2, lanes)
    # The forward step t reads l1[t-1] and l2[t-2]: shift them down so
    # it reads row t only (zeros enter at the top: the t < 2 boundary).
    l1s = jnp.pad(l1, ((1, 0), (0, 0)))[:T]
    l2s = jnp.pad(l2, ((2, 0), (0, 0)))[:T]
    spec = pl.BlockSpec((T, block), lambda j: (0, j))
    out = pl.pallas_call(
        _solve_kernel,
        out_shape=jax.ShapeDtypeStruct(b.shape, jnp.float32),
        grid=(b.shape[1] // block,),
        in_specs=[spec] * 6,
        out_specs=spec,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="mlpg_solve_banded",
    )(b, l0, l1s, l2s, l1, l2)
    return out[:, :L]
