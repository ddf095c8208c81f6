"""Ulysses sequence parallelism (``parallel/ulysses.py``) and the mesh's tiled
all-to-all on worlds of threads, case for case as the JAX package's
``tests/test_ulysses.py``.

Attention over an 8-rank seq axis against the JAX ``ulysses_attention``
under ``shard_map`` and the dense reference (atol 2e-5, rtol 1e-4, the
JAX test's); the Ulysses step equals the ring step step for step (losses
rtol 1e-5, parameters rtol 2e-4 / atol 1e-6, the JAX test's) and the JAX
Ulysses step (the same bounds); eval is the train loss's definition
(rtol 1e-6); indivisible heads are refused. ``DeviceMesh.all_to_all``
equals ``lax.all_to_all(tiled=True)`` exactly.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_ml_pytorch_tpu.models.transformer import TransformerLM as JLM
from distributed_ml_pytorch_tpu.ops import attention_reference
from distributed_ml_pytorch_tpu.parallel import seq_parallel as jsp
from distributed_ml_pytorch_tpu.parallel import ulysses as jul
from distributed_ml_pytorch_tpu.runtime.mesh import make_mesh as jmake_mesh
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.parallel import seq_parallel as sp
from distributed_ml_pytorch_tpu_torch.parallel import ulysses as ul
from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
from distributed_ml_pytorch_tpu_torch.training.trainer import SGD
from distributed_ml_pytorch_tpu_torch.utils import interop

CFG = dict(vocab_size=64, d_model=32, n_heads=8, n_layers=2, d_ff=64, max_len=128)
SP = {"data": 2, "seq": 4}
OUT_TOL = dict(atol=2e-5, rtol=1e-4)
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_ulysses_attention_matches_full():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 8, 128, 16)).astype(np.float32) for _ in range(3))
    mesh = jmake_mesh({"seq": 8}, devices=jax.devices()[:8])
    spec = P(None, None, "seq", None)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda q, k, v: jul.ulysses_attention(q, k, v, axis="seq", axis_size=8),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec))(q, k, v))

    def rank(world):
        m = make_mesh({"seq": 8}, world=world)
        i = m.axis_index("seq")
        chunk = [torch.from_numpy(a[:, :, i * 16:(i + 1) * 16].copy()) for a in (q, k, v)]
        return ul.ulysses_attention(*chunk, mesh=m, axis="seq")

    got = torch.cat(run_threaded(8, rank), dim=2).numpy()
    np.testing.assert_allclose(got, want, **OUT_TOL)
    ref = np.asarray(attention_reference(q, k, v, causal=True))
    np.testing.assert_allclose(got, ref, **OUT_TOL)


@pytest.fixture(scope="module")
def lm_case():
    tokens = np.random.default_rng(1).integers(0, 64, size=(4, 64)).astype(np.int32)
    targets = jsp.next_token_targets(tokens)
    params = JLM(**CFG).init(jax.random.key(0), jax.numpy.zeros((1, 8), jax.numpy.int32))
    return tokens, targets, jax.tree.map(np.asarray, params["params"])


def _run(make, params, tokens, targets, steps=3):
    def rank(world):
        mesh = make_mesh(SP, world=world)
        model = TransformerLM(**CFG, device="cpu")
        model.load_state_dict(interop.params_from_jax(params, model))
        tx = SGD(0.05)
        state = sp.create_lm_train_state(model, tx)
        step = make(model, tx, mesh)
        a, b = sp.shard_lm_batch(mesh, tokens, targets)
        return [float(step(state, a, b)[1]) for _ in range(steps)], model.state_dict()

    return run_threaded(8, rank)[0]


def test_ulysses_train_matches_ring_step_for_step(lm_case):
    """From identical weights, Ulysses and the ring give the same losses and
    parameters (the same math, other collectives), and so does the JAX
    Ulysses step."""
    tokens, targets, params = lm_case
    ring_losses, ring_params = _run(sp.make_sp_train_step, params, tokens, targets)
    uly_losses, uly_params = _run(ul.make_ulysses_train_step, params, tokens, targets)
    np.testing.assert_allclose(uly_losses, ring_losses, **LOSS_TOL)
    for name, t in ring_params.items():
        np.testing.assert_allclose(uly_params[name].numpy(), t.numpy(), err_msg=name,
                                   **PARAM_TOL)
    mesh = jmake_mesh(SP, devices=jax.devices()[:8])
    tx = optax.sgd(0.05)
    state = jsp.create_lm_train_state(JLM(**CFG), jax.random.key(0), tx)
    state = state.replace(params=jax.tree.map(jax.numpy.asarray, params))
    step = jul.make_ulysses_train_step(JLM(**CFG), tx, mesh)
    tok, tgt = jsp.shard_lm_batch(mesh, tokens, targets)
    jlosses = []
    for _ in range(3):
        state, loss = step(state, tok, tgt)
        jlosses.append(float(loss))
    np.testing.assert_allclose(uly_losses, jlosses, **LOSS_TOL)
    model = TransformerLM(**CFG, device="cpu")
    want = interop.params_from_jax(jax.tree.map(np.asarray, jax.device_get(state.params)),
                                   model)
    for name, w in want.items():
        np.testing.assert_allclose(uly_params[name].numpy(), w.numpy(), err_msg=name,
                                   **PARAM_TOL)


def test_ulysses_eval_matches_train_loss_definition(lm_case):
    tokens, targets, params = lm_case

    def rank(world):
        mesh = make_mesh(SP, world=world)
        model = TransformerLM(**CFG, device="cpu")
        model.load_state_dict(interop.params_from_jax(params, model))
        a, b = sp.shard_lm_batch(mesh, tokens, targets)
        ev = float(ul.make_ulysses_eval_fn(model, mesh)(model, a, b))
        tx = SGD(0.0)  # lr 0: the train step's loss is the pre-update loss
        _, loss = ul.make_ulysses_train_step(model, tx, mesh)(
            sp.create_lm_train_state(model, tx), a, b)
        return ev, float(loss)

    for ev, loss in run_threaded(8, rank):
        np.testing.assert_allclose(ev, loss, rtol=1e-6)


def test_ulysses_rejects_indivisible_heads():
    def rank(world):
        mesh = make_mesh(SP, world=world)
        lm = TransformerLM(vocab_size=64, d_model=30, n_heads=6, n_layers=1, d_ff=64,
                           max_len=128, device="cpu")  # 6 heads, seq axis 4
        ul.make_ulysses_train_step(lm, SGD(0.1), mesh)

    with pytest.raises(ValueError, match="divisible"):
        run_threaded(8, rank)


@pytest.mark.parametrize("split,concat", [(1, 2), (2, 1), (0, 3)])
def test_all_to_all_is_the_tiled_lax_all_to_all(split, concat):
    x = np.arange(4 * 4 * 8 * 4 * 4, dtype=np.float32).reshape(4, 4, 8, 4, 4)
    mesh = jmake_mesh({"seq": 4}, devices=jax.devices()[:4])
    spec = P("seq")  # each rank's input is x[rank]
    want = np.asarray(jax.jit(jax.shard_map(
        lambda t: jax.lax.all_to_all(t[0], "seq", split, concat, tiled=True)[None],
        mesh=mesh, in_specs=spec, out_specs=spec))(x))

    def rank(world):
        m = make_mesh({"seq": 4}, world=world)
        return m.all_to_all(torch.from_numpy(x[m.rank].copy()), "seq", split, concat)

    for r, got in enumerate(run_threaded(4, rank)):
        np.testing.assert_array_equal(got.numpy(), want[r])
