"""dp × ep expert parallelism (``parallel/expert_parallel.py``) of the port on
worlds of threads, case for case as the ep cases of the JAX package's
``tests/test_expert_parallel.py``.

The tiny MoE LM (vocab 64, d_model 32, 4 heads, 2 layers, d_ff 64, 4
experts top-1, capacity 2.0), float32, SGD lr 0.1, batch 4 × 16, on a
(data=2, expert=4) world of 8 threads, each rank holding one expert.
Against the JAX ``make_ep_train_step`` on the unsharded state from the same
weights, three steps. The JAX test asserts "matches unsharded exactly" at
rtol 2e-5 for the loss and the aux loss and rtol 3e-5 / atol 1e-6 for the
parameters; the port is held to the same bounds: top-1 routing leaves one
nonzero combine entry a token, so the sum over ``expert`` adds zeros, and
the load-balance loss is taken over the global batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_ml_pytorch_tpu.models.moe import MoETransformerLM as JMoE
from distributed_ml_pytorch_tpu.parallel import expert_parallel as jep
from distributed_ml_pytorch_tpu.parallel.seq_parallel import next_token_targets
from distributed_ml_pytorch_tpu.runtime.mesh import make_mesh as jmake_mesh
from distributed_ml_pytorch_tpu.training.trainer import TrainState
from distributed_ml_pytorch_tpu_torch.models import MoETransformerLM
from distributed_ml_pytorch_tpu_torch.parallel import expert_parallel as ep
from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
from distributed_ml_pytorch_tpu_torch.training.trainer import SGD
from distributed_ml_pytorch_tpu_torch.utils import interop

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, n_experts=4,
           capacity_factor=2.0, max_len=128)
LOSS_TOL = dict(rtol=2e-5)
PARAM_TOL = dict(rtol=3e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_batch(batch=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 64, size=(batch, seq)).astype(np.int32)
    return tokens, next_token_targets(tokens)


def _model(params=None):
    model = MoETransformerLM(**CFG, device="cpu")
    if params is not None:
        model.load_state_dict(interop.params_from_jax(params, model))
    return model


def test_ep_param_specs_shard_only_expert_stacks():
    specs = ep.ep_param_specs(dict(_model().named_parameters()))
    assert specs["block_0.moe.w_up"] == "expert"
    assert specs["block_0.moe.b_down"] == "expert"
    assert specs["block_0.moe.router.weight"] is None
    assert specs["block_0.attn.q.weight"] is None


def test_ep_training_matches_unsharded_exactly():
    model = JMoE(**CFG)
    tx = optax.sgd(0.1)
    tokens, targets = make_batch()
    params = model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    init = jax.tree.map(np.asarray, params)
    ref_state = TrainState.create(params, tx)
    ref_step = jep.make_ep_train_step(model, tx, jmake_mesh({"data": 2, "expert": 4},
                                                            devices=jax.devices()[:8]))
    want = []
    for _ in range(3):
        ref_state, (loss, aux) = ref_step(ref_state, jnp.asarray(tokens), jnp.asarray(targets))
        want.append((float(loss), float(aux)))

    def rank(world):
        mesh = make_mesh({"data": 2, "expert": 4}, world=world)
        m = _model(init)
        state = ep.create_ep_train_state(m, SGD(0.1), mesh)
        step = ep.make_ep_train_step(m, SGD(0.1), mesh)
        a, b = ep.shard_ep_batch(mesh, tokens, targets)
        got = [tuple(float(x) for x in step(state, a, b)[1]) for _ in range(3)]
        return got, mesh.coords, {n: p.detach().clone() for n, p in m.named_parameters()}

    ref = interop.params_from_jax(jax.tree.map(np.asarray, jax.device_get(ref_state.params)),
                                  _model())
    for got, coords, local in run_threaded(8, rank):
        np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], **LOSS_TOL)
        np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], **LOSS_TOL)
        e = coords["expert"]
        for name, t in local.items():
            w = ref[name]
            if ep.ep_param_specs({name: None})[name] is not None:
                w = w[e:e + 1]
            np.testing.assert_allclose(t.numpy(), w.numpy(), err_msg=name, **PARAM_TOL)


def test_ep_state_is_actually_sharded():
    def rank(world):
        mesh = make_mesh({"data": 2, "expert": 4}, world=world)
        m = _model()
        state = ep.create_ep_train_state(m, SGD(0.1, momentum=0.9), mesh)
        shapes = {n: tuple(p.shape) for n, p in m.named_parameters()}
        return shapes, [tuple(t.shape) for t in state.opt_state.slots["trace"]]

    shapes, traces = run_threaded(8, rank)[0]
    assert shapes["block_0.moe.w_up"] == (1, 32, 64)
    assert shapes["block_0.moe.b_down"] == (1, 32)
    assert shapes["block_0.moe.router.weight"] == (4, 32)
    assert traces == list(shapes.values())


def test_ep_rejects_indivisible_experts():
    def rank(world):
        mesh = make_mesh({"data": 2, "expert": 4}, world=world)
        bad = MoETransformerLM(vocab_size=64, d_model=32, n_heads=4, n_layers=1, d_ff=64,
                               n_experts=3, device="cpu")
        ep.make_ep_train_step(bad, SGD(0.1), mesh)

    with pytest.raises(ValueError, match="not divisible"):
        run_threaded(8, rank)


def test_global_load_balance_is_the_whole_batch_loss():
    """Over rows sharded on ``data``, the balance loss equals the one of the
    whole batch (a product of two means: the mean of the rows' losses
    differs)."""
    from distributed_ml_pytorch_tpu_torch.models.moe import load_balance_loss

    rng = np.random.default_rng(4)
    probs = torch.softmax(torch.from_numpy(rng.normal(size=(4, 8, 4)).astype(np.float32)), -1)
    want = float(load_balance_loss(probs))

    def rank(world):
        mesh = make_mesh({"data": 2}, world=world)
        rows = probs[mesh.rank * 2:(mesh.rank + 1) * 2]
        return float(ep.global_load_balance(rows, mesh, "data")), float(load_balance_loss(rows))

    out = run_threaded(2, rank)
    for got, _ in out:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert abs(np.mean([local for _, local in out]) - want) > 1e-4
