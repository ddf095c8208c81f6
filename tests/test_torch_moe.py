"""The port's Switch-MoE LM (``models/moe.py``) against the JAX package's, on
the CPU: routing, the load-balance loss, the LM's forward and SGD step, its
decode and greedy ``generate()``. Weights cross with ``utils/interop.py``;
inputs come from numpy.

Tolerances:
- routing (dispatch and combine) bit for bit, ties included, in float32 and
  bfloat16: both sides compute the same one-hot counts and products;
- the load-balance loss within 1e-6 relative in float32 (means summed in
  other orders), one bfloat16 step (2^-7 relative) in bfloat16;
- float32 logits within 1e-5 absolute and relative (measured 1.9e-6);
- bfloat16 logits: at least 90 % of the token positions within 2^-4 of the
  largest logit (each layer rounds its attention and LayerNorm outputs to
  bfloat16 after summing in its own order; measured 1 %). Routing is a
  discrete choice over bfloat16 probabilities: where two experts' rounded
  probabilities tie within a rounding, the two packages can send a token
  to different experts, and that position differs by far more (measured:
  one position in 32 to 64 for some weight draws, up to 21 % of the
  largest logit there);
- one SGD step in float32: the loss within 1e-5 relative, the updated
  parameters within 1e-5 absolute and relative;
- decode logits against the full forward within 2e-4 relative and 2e-5
  absolute (the JAX test's), at a drop-free capacity;
- greedy tokens equal to JAX's, where every generated position's top-2
  margin is at least 1e-3 (asserted, a hundred times the logits' tolerance).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.models import moe as jmoe
from distributed_ml_pytorch_tpu.parallel.fsdp import lm_loss_builder as jloss_builder
from distributed_ml_pytorch_tpu.parallel.seq_parallel import next_token_targets
from distributed_ml_pytorch_tpu_torch.models import moe as tmoe
from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import create_lm_train_state
from distributed_ml_pytorch_tpu_torch.training.trainer import SGD
from distributed_ml_pytorch_tpu_torch.utils import interop

jgen = importlib.import_module("distributed_ml_pytorch_tpu.models.generate")
tgen = importlib.import_module("distributed_ml_pytorch_tpu_torch.models.generate")

CFG = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128, n_experts=4,
           max_len=64)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2.0 ** -4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tied_probs(b=2, s=12, e=4, seed=0):
    """Probabilities with ties: small integer weights normalised per token
    (rows of equal weights included)."""
    w = np.random.default_rng(seed).integers(0, 3, size=(b, s, e)).astype(np.float32)
    w[0, 0] = 1.0  # a token whose experts all tie
    return w / w.sum(-1, keepdims=True).clip(1)


def _both(p, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(p).astype(jdt), torch.from_numpy(p).to(tdt)


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [1, 2, 5])
def test_routing_bit_equal_with_ties(dtype, capacity):
    jp, tp = _both(_tied_probs(), dtype)
    for a, b in zip(jmoe.switch_route(jp, capacity), tmoe.switch_route(tp, capacity)):
        np.testing.assert_array_equal(_np(a), _np(b))
    for k in (1, 2, 3):
        for normalize in (True, False):
            for a, b in zip(jmoe.topk_route(jp, capacity, k, normalize),
                            tmoe.topk_route(tp, capacity, k, normalize)):
                np.testing.assert_array_equal(_np(a), _np(b))
    # the all-tied token goes to expert 0 (the lower index), as jnp.argmax
    d, _ = tmoe.switch_route(tp, capacity)
    assert float(d[0, 0, 0, 0]) == 1.0


def test_rank_major_capacity_priority():
    """Capacity 1: every first choice outranks any second choice (JAX
    ``test_rank_major_capacity_priority``)."""
    probs = torch.tensor([[[0.6, 0.3, 0.1], [0.5, 0.4, 0.1], [0.55, 0.35, 0.1]]])
    d, _ = tmoe.topk_route(probs, capacity=1, k=2)
    assert d[0, 0, 0, 0] == 1.0
    assert d[0, 1, 0, 0] == 0.0 and d[0, 2, 0, 0] == 0.0
    assert float(d[0, :, 1, 0].sum()) == 1.0
    with pytest.raises(ValueError):
        tmoe.topk_route(probs, capacity=1, k=4)


def test_queue_positions_stay_exact_past_256_in_bfloat16():
    """Every token prefers expert 0: a bf16 cumsum would collide slots past
    256; the int32 counts give each of the first 300 tokens its own slot."""
    probs = torch.zeros((1, 400, 2), dtype=torch.bfloat16)
    probs[..., 0] = 1.0
    d, _ = tmoe.switch_route(probs, capacity=300)
    assert torch.equal(d[0, :300, 0].float(), torch.eye(300))
    assert float(d[0, 300:].sum()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_balance_loss_matches_jax(dtype):
    p = np.random.default_rng(1).dirichlet(np.ones(4), size=(2, 16)).astype(np.float32)
    jp, tp = _both(p, dtype)
    want, got = float(jmoe.load_balance_loss(jp)), float(tmoe.load_balance_loss(tp))
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -7
    assert got == pytest.approx(want, rel=rtol)


def _pair(top_k=1, dtype="float32", capacity_factor=2.0, seed=0, **cfg):
    cfg = {**CFG, **cfg}
    jdt, tdt = DTYPES[dtype]
    jm = jmoe.MoETransformerLM(**cfg, router_top_k=top_k, dtype=jdt,
                               capacity_factor=capacity_factor)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    model = tmoe.MoETransformerLM(**cfg, router_top_k=top_k, dtype=tdt,
                                  capacity_factor=capacity_factor, device="cpu")
    model.load_state_dict(interop.params_from_jax(jax.tree.map(np.asarray, params), model))
    return jm, params, model


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], size=shape).astype(np.int32)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_matches_jax(top_k, dtype):
    jm, params, model = _pair(top_k, dtype)
    tok = _tokens((2, 32), 2)
    ref = _np(jax.jit(jm.apply)({"params": params}, tok))
    with torch.no_grad():
        out = _np(model(torch.from_numpy(tok).long()))
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, **F32_TOL)
    else:
        rows = np.abs(out - ref).max(-1) <= BF16_REL * np.abs(ref).max()
        assert rows.mean() >= 0.9, rows.mean()
    # each block keeps its load-balance loss, as JAX sows it
    assert all(lb is not None and lb.dim() == 0 for lb in model.load_balance_losses())
    # the carried tree comes back as it went
    back = interop.params_to_jax(model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, params))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("top_k", [1, 2])
def test_sgd_step_matches_jax(top_k):
    jm, params, model = _pair(top_k)
    tok = _tokens((2, 32), 3)
    tgt = next_token_targets(tok)
    lr = 0.1
    loss_fn = jloss_builder(jm)(None, jnp.asarray(tok), jnp.asarray(tgt))
    jloss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = jax.tree.map(lambda p, g: np.asarray(p - lr * g), params, grads)
    tx = SGD(lr)
    step = make_fsdp_lm_train_step(model, tx)
    _state, loss = step(create_lm_train_state(model, tx), torch.from_numpy(tok).long(),
                        torch.from_numpy(tgt).long())
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    got = interop.params_to_jax(model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, **F32_TOL)


def test_incremental_decode_matches_full_forward():
    """At capacity factor 4 (capacity = seq) the full forward drops no token,
    so the cached single-token decode reproduces it (JAX
    ``test_moe_incremental_decode_matches_full_forward``)."""
    jm, params, model = _pair(capacity_factor=4.0)
    tok = _tokens((2, 10), 0)
    full = model(torch.from_numpy(tok).long()).detach().numpy()
    np.testing.assert_allclose(full, np.asarray(jm.apply({"params": params}, tok)), **F32_TOL)
    dec = tgen._decode_model(model, 10)
    assert isinstance(dec, tmoe.MoETransformerLM) and dec.decode
    cache = tgen.init_cache(model, 2, 10)
    got = []
    with torch.no_grad():
        for t in range(10):
            logits, cache = dec(torch.from_numpy(tok[:, t:t + 1]).long(),
                                torch.full((2, 1), t), cache=cache)
            got.append(logits[:, 0].numpy())
    np.testing.assert_allclose(np.stack(got, 1), full, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("new", [8, 24])  # the plain path, then two blocks (K8 on the card)
def test_greedy_generate_equals_jax(new):
    jm, params, model = _pair(capacity_factor=4.0, seed=1, max_len=128)
    prompt = _tokens((2, 6), 4)
    want = np.asarray(jgen.generate(jm, params, jnp.asarray(prompt), new))
    got = tgen.generate(model, torch.from_numpy(prompt), new).numpy()
    assert tgen.uses_block_decode(model, 6, new)[0] == (new >= 17)
    # the drop-free full forward over JAX's tokens: every generated
    # position's greedy choice is clear of its runner-up
    with torch.no_grad():
        logits = model(torch.from_numpy(want[:, :-1].copy()).long())[:, 5:].numpy()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() >= 1e-3
    np.testing.assert_array_equal(got, want)
