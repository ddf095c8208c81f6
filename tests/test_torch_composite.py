"""Composite 3-D sharding, data × FSDP × tensor (``parallel/composite.py``),
of the port on a 2 × 2 × 2 world of threads, case for case as the JAX
package's ``tests/test_composite.py``.

The tiny LM (vocab 64, d_model 32, 4 heads, 2 layers, d_ff 64, max_len
64), float32, SGD lr 0.05 with momentum 0.9, batch 8 × 32. Against the
JAX single-device step from the same weights, three steps: losses rtol
2e-5 and parameters rtol 5e-4 / atol 2e-6 (the JAX test's bounds between
its composite and single runs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_ml_pytorch_tpu.models.transformer import TransformerLM as JLM
from distributed_ml_pytorch_tpu.parallel.seq_parallel import next_token_targets
from distributed_ml_pytorch_tpu.training.trainer import TrainState
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.parallel import composite as cp
from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
from distributed_ml_pytorch_tpu_torch.training.trainer import SGD
from distributed_ml_pytorch_tpu_torch.utils import interop

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=64)
MESH = {"data": 2, "fsdp": 2, "model": 2}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_composite_specs_merge_tp_and_fsdp():
    tree = {
        "attn_q": (32, 32),   # no tp rule by this name: fsdp takes the trailing dim
        "ln_scale": (32,),    # fsdp takes dim 0
        "tiny": (3,),         # nothing divisible: untouched
        "block_0.attn.q.weight": (32, 32),  # tp dim 0, fsdp the other
        "lm_head.weight": (64, 32),          # tp the vocabulary rows, fsdp d_model
    }
    specs = cp.composite_specs(tree, fsdp_size=2)
    assert specs["ln_scale"] == ("fsdp",)
    assert specs["tiny"] == (None,)
    assert specs["attn_q"] == (None, "fsdp")
    assert specs["block_0.attn.q.weight"] == ("model", "fsdp")
    assert specs["lm_head.weight"] == ("model", "fsdp")


def test_composite_step_matches_single_device():
    lm = JLM(**CFG)
    tx = optax.sgd(0.05, momentum=0.9)
    params = lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    init = jax.tree.map(np.asarray, params)
    state_s = TrainState.create(params, tx)
    tokens = np.random.default_rng(0).integers(0, 64, size=(8, 32)).astype(np.int32)
    targets = next_token_targets(tokens)

    @jax.jit
    def single_step(state, tokens, targets):
        def loss_fn(params):
            logits = lm.apply({"params": params}, tokens)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
            mask = jnp.ones_like(ce).at[:, -1].set(0.0)
            return jnp.sum(ce * mask) / jnp.sum(mask)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return state.replace(params=optax.apply_updates(state.params, updates),
                             opt_state=opt_state, step=state.step + 1), loss

    want = []
    for _ in range(3):
        state_s, loss = single_step(state_s, tokens, targets)
        want.append(float(loss))

    def rank(world):
        mesh = make_mesh(MESH, world=world)
        model = TransformerLM(**CFG, device="cpu")
        model.load_state_dict(interop.params_from_jax(init, model))
        opt = SGD(0.05, momentum=0.9)
        state, specs = cp.create_composite_train_state(model, opt, mesh)
        step = cp.make_composite_train_step(model, opt, mesh, specs)
        a, b = cp.shard_composite_batch(mesh, tokens, targets)
        losses = [float(step(state, a, b)[1]) for _ in range(3)]
        state.sharding.gather()
        return losses, mesh.coords, specs, {n: p.detach().clone()
                                            for n, p in model.named_parameters()}

    ref = interop.params_from_jax(jax.tree.map(np.asarray, jax.device_get(state_s.params)),
                                  TransformerLM(**CFG, device="cpu"))
    for losses, coords, specs, local in run_threaded(8, rank):
        np.testing.assert_allclose(losses, want, rtol=2e-5)
        for name, t in local.items():
            w = ref[name]
            if "model" in specs[name]:  # the gathered tp shard of this model rank
                w = w.chunk(2, dim=specs[name].index("model"))[coords["model"]]
            np.testing.assert_allclose(t.numpy(), w.numpy(), rtol=5e-4, atol=2e-6,
                                       err_msg=name)


def test_composite_params_are_distributed():
    """Every tp-ruled 2-D weight (attention projections, MLP denses,
    lm_head) is sharded over both fsdp and model (a quarter on each rank);
    every other leaf of at least 32 rows at least over fsdp."""

    def rank(world):
        mesh = make_mesh(MESH, world=world)
        model = TransformerLM(**CFG, device="cpu")
        full = {n: tuple(p.shape) for n, p in model.named_parameters()}
        state, specs = cp.create_composite_train_state(model, SGD(0.1), mesh)
        names = [n for n, _ in model.named_parameters()]
        return full, specs, dict(zip(names, (tuple(s.shape) for s in state.sharding.shards)))

    full, specs, shards = run_threaded(8, rank)[0]
    both = 0
    for name, shape in full.items():
        if len(shape) != 2 or shape[0] < 32:
            continue
        assert "fsdp" in specs[name], name
        if any(t in name for t in ("attn", "Dense_", "lm_head")):
            assert "model" in specs[name], name
            assert np.prod(shards[name]) * 4 == np.prod(shape), name
            both += 1
    assert both >= 4
