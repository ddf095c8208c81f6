"""Sequence-parallel LM training (``parallel/seq_parallel.py``) of the port on
worlds of threads, against the JAX ``make_sp_train_step`` on a 2 × 2
``(data, seq)`` mesh from the same weights and tokens.

The tiny LM (vocab 64, d_model 32, 8 heads, 2 layers, d_ff 64, max_len
128), float32, SGD lr 0.05, batch 4 × 64 (each rank 2 × 32). Three steps:
losses rtol 1e-5 and parameters rtol 2e-4, atol 1e-6 (the JAX Ulysses
test's bounds between its two sp steps: the chunks' sums are the same
numbers in another order). The loss is the global masked mean: only the
final *global* position is masked and both sums span the mesh (a per-rank
mean differs, shown); eval equals the train step's pre-update loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_ml_pytorch_tpu.models.transformer import TransformerLM as JLM
from distributed_ml_pytorch_tpu.parallel import seq_parallel as jsp
from distributed_ml_pytorch_tpu.runtime.mesh import make_mesh as jmake_mesh
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.parallel import seq_parallel as sp
from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
from distributed_ml_pytorch_tpu_torch.training.trainer import SGD
from distributed_ml_pytorch_tpu_torch.utils import interop

CFG = dict(vocab_size=64, d_model=32, n_heads=8, n_layers=2, d_ff=64, max_len=128)
LR = 0.05
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
SHAPE = {"data": 2, "seq": 2}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def batch():
    tokens = np.random.default_rng(1).integers(0, 64, size=(4, 64)).astype(np.int32)
    return tokens, jsp.next_token_targets(tokens)


@pytest.fixture(scope="module")
def jax_run(batch):
    """The JAX sp step, 3 steps: initial params, losses, final params."""
    lm = JLM(**CFG)
    tx = optax.sgd(LR)
    mesh = jmake_mesh(SHAPE, devices=jax.devices()[:4])
    state = jsp.create_lm_train_state(lm, jax.random.key(0), tx)
    init = jax.tree.map(np.asarray, jax.device_get(state.params))
    step = jsp.make_sp_train_step(lm, tx, mesh)
    tok, tgt = jsp.shard_lm_batch(mesh, *batch)
    losses = []
    for _ in range(3):
        state, loss = step(state, tok, tgt)
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, jax.device_get(state.params))


def _model(params):
    model = TransformerLM(**CFG, device="cpu")
    model.load_state_dict(interop.params_from_jax(params, model))
    return model


def _sp_run(params, tokens, targets, steps=3, shape=SHAPE, make=sp.make_sp_train_step):
    def rank(world):
        mesh = make_mesh(shape, world=world)
        model = _model(params)
        tx = SGD(LR)
        state = sp.create_lm_train_state(model, tx)
        step = make(model, tx, mesh)
        a, b = sp.shard_lm_batch(mesh, tokens, targets)
        losses = [float(step(state, a, b)[1]) for _ in range(steps)]
        return losses, model.state_dict()

    return run_threaded(shape["data"] * shape["seq"], rank)


def test_sp_step_matches_jax_on_data_x_seq(jax_run, batch):
    init, jlosses, jfinal = jax_run
    out = _sp_run(init, *batch)
    want = interop.params_from_jax(jfinal, _model(init))
    for losses, params in out:
        np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)
        for name, w in want.items():
            np.testing.assert_allclose(params[name].numpy(), w.numpy(), err_msg=name,
                                       **PARAM_TOL)


def test_sp_loss_is_the_global_masked_mean(jax_run, batch):
    """The first step's loss is the dense model's masked mean over the whole
    batch with only the final global position masked; the mean of per-rank
    masked means (each rank masking its own last position) is another
    number."""
    init, jlosses, _ = jax_run
    tokens, targets = batch
    logits = JLM(**CFG).apply({"params": init}, jnp.asarray(tokens))
    ce = np.asarray(optax.softmax_cross_entropy_with_integer_labels(logits, targets))
    np.testing.assert_allclose(jlosses[0], ce[:, :-1].mean(), rtol=1e-5)
    got = _sp_run(init, tokens, targets, steps=1)[0][0][0]
    np.testing.assert_allclose(got, ce[:, :-1].mean(), rtol=1e-5)
    per_rank = np.mean([ce[r * 2:(r + 1) * 2, c * 32:(c + 1) * 32 - 1].mean()
                        for r in range(2) for c in range(2)])
    assert abs(per_rank - got) > 1e-4


def test_sp_eval_matches_jax_and_the_train_loss(jax_run, batch):
    init, jlosses, _ = jax_run
    mesh = jmake_mesh(SHAPE, devices=jax.devices()[:4])
    tok, tgt = jsp.shard_lm_batch(mesh, *batch)
    jeval = float(jsp.make_sp_eval_fn(JLM(**CFG), mesh)(
        jax.tree.map(jnp.asarray, init), tok, tgt))

    def rank(world):
        m = make_mesh(SHAPE, world=world)
        model = _model(init)
        a, b = sp.shard_lm_batch(m, *batch)
        fn = sp.make_sp_eval_fn(model, m)
        state = sp.create_lm_train_state(model, SGD(0.0))
        return float(fn(model, a, b)), sp.sp_eval_loss(model, m, state, a, b)

    for ev, (loss, n) in run_threaded(4, rank):
        np.testing.assert_allclose(ev, jeval, rtol=1e-5)
        np.testing.assert_allclose(ev, jlosses[0], rtol=1e-5)
        assert loss == ev and n == 2 * 32


def test_shard_lm_batch_takes_rows_over_data_and_positions_over_seq(batch):
    tokens, targets = batch

    def rank(world):
        mesh = make_mesh(SHAPE, world=world)
        return mesh.coords, sp.shard_lm_batch(mesh, tokens, targets)

    for coords, (a, b) in run_threaded(4, rank):
        d, s = coords["data"], coords["seq"]
        np.testing.assert_array_equal(a.numpy(), tokens[d * 2:(d + 1) * 2, s * 32:(s + 1) * 32])
        np.testing.assert_array_equal(b.numpy(), targets[d * 2:(d + 1) * 2, s * 32:(s + 1) * 32])


def test_sp_rejects_a_sequence_past_max_len(batch):
    def rank(world):
        mesh = make_mesh({"data": 1, "seq": 2}, world=world)
        model = TransformerLM(**dict(CFG, max_len=32), device="cpu")
        step = sp.make_sp_train_step(model, SGD(LR), mesh)
        a, b = sp.shard_lm_batch(mesh, *batch)
        step(sp.create_lm_train_state(model, SGD(LR)), a, b)

    with pytest.raises(ValueError, match="exceeds the model's max_len"):
        run_threaded(2, rank)
