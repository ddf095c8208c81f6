"""The port's restructured lm_head step and head update (K7's plain version)
against the JAX package's ``ops/fused_head.py``.

The JAX side runs ``head_update_sgd`` both ways: the XLA formulation
(``use_kernel=False``) and the Pallas kernel in interpret mode
(``use_kernel=True`` under ``force_pallas_interpret``). The port's
``lm_head.weight`` is ``(V, D)`` and the JAX ``W`` is ``(D, V)``: the tests
transpose at the seam.

Tolerances, each stated as ``|got − want| <= 2^-23·|W| + rtol·lr·(|dl|ᵀ·|h|)``:
the ``2^-23·|W|`` term is each side's one float32 rounding of ``W − lr·dW``;
``|dl|ᵀ·|h|`` is the product's absolute value, the scale of any reordering
or rounding of its terms. Each case runs twice: from the real ``W`` (the
update in place), and from ``W = 0`` with the same logits, where the result
is ``−lr·dW`` itself and the bound has no ``W`` term — the sharp check, since
from the real ``W`` the update is a few hundred ulps of ``W`` and most of
its last bits round away.

- float32: ``rtol = 2^-12``. Both sides sum n = 2048 exact products in
  float32 in different orders, at most ``(n − 1)·u = 2^-13`` of the absolute
  product (u = 2^-24), and their exponentials (XLA's, the interpret kernel's
  ``exp2`` in log2 space, torch's) differ by a few ulps.
- bfloat16: ``rtol = 2^-7``. Each side rounds each ``dl`` term to bfloat16;
  where the float32 values differ in their last bits the two roundings can
  land one bfloat16 step apart, at most ``2u = 2^-7`` (u = 2^-8) of the term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_ml_pytorch_tpu.models import TransformerLM as JLM
from distributed_ml_pytorch_tpu.ops import fused_head as jfh
from distributed_ml_pytorch_tpu.ops.fused_update import force_pallas_interpret
from distributed_ml_pytorch_tpu.parallel.seq_parallel import create_lm_train_state as jstate
from distributed_ml_pytorch_tpu.parallel.seq_parallel import next_token_targets
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.ops import fused_head as tfh
from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import create_lm_train_state
from distributed_ml_pytorch_tpu_torch.training.trainer import SGD
from distributed_ml_pytorch_tpu_torch.utils import interop

LR = 0.05
RTOL = {"float32": 2.0 ** -12, "bfloat16": 2.0 ** -7}
CFG = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=64,
           pos_encoding="rope")
B, S = 2, 32


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _head_inputs(dtype_name, seed=1):
    """tests/test_fused_head.py:74-93's inputs: n 2048, d 32, v 640 (a
    ragged final 512-column block), zeros in gscale at every 7th row; in
    bfloat16, h2 and the logits in bfloat16."""
    rng = np.random.default_rng(seed)
    n, d, v = 2048, 32, 640
    jdt = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    W = jnp.asarray(rng.normal(size=(d, v)) * 0.02, jnp.float32)
    h2 = jnp.asarray(rng.normal(size=(n, d)), jdt)
    logits = h2 @ W.astype(jdt)
    lse = jax.nn.logsumexp(logits.astype(jnp.float32), axis=-1)
    labels = jnp.asarray(rng.integers(0, v, (n,)), jnp.int32)
    gscale = jnp.asarray(rng.uniform(0, 1e-3, (n,)), jnp.float32).at[::7].set(0.0)
    return W, h2, logits, lse, labels, gscale


def _to_torch(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a))


def _port_args(W, h2, logits, lse, labels, gscale):
    dt = torch.bfloat16 if h2.dtype == jnp.bfloat16 else torch.float32
    return (_to_torch(W).t().contiguous(), _to_torch(h2).to(dt), _to_torch(logits).to(dt),
            _to_torch(lse), _to_torch(labels).long(), _to_torch(gscale))


def _assert_update_close(got, want, W, h2, dl, rtol):
    """``got``/``want``/``W`` (V, D) float32; bound in the module docstring."""
    scale = LR * (dl.float().abs().t() @ h2.float().abs())
    bound = 2.0 ** -23 * W.abs() + rtol * scale
    err = (got - want).abs()
    assert bool((err <= bound).all()), (float(err.max()), float((err / bound).max()))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_kernel", [False, True], ids=["jax_xla", "jax_interpret_kernel"])
@pytest.mark.parametrize("from_zero", [False, True], ids=["W", "zero_W"])
def test_head_update_sgd_matches_jax(dtype_name, jax_kernel, from_zero):
    args = _head_inputs(dtype_name)
    if from_zero:  # the logits stay those of the real W
        args = (jnp.zeros_like(args[0]),) + args[1:]
    with force_pallas_interpret():
        ref = jfh.head_update_sgd(*args, LR, use_kernel=jax_kernel)
    W, h2, logits, lse, labels, gscale = _port_args(*args)
    W0 = W.clone()
    got = tfh.head_update_sgd(W, h2, logits, lse, labels, gscale, LR)
    assert got is W  # in place
    want = _to_torch(ref).t()
    dl = tfh.head_dlogits(h2, logits, lse, labels, gscale)
    assert dl.dtype == h2.dtype and dl.shape == logits.shape
    _assert_update_close(got, want, W0, h2, dl, RTOL[dtype_name])
    # the plain version is the same arithmetic, as a new tensor
    plain = tfh.head_update_plain(W0, h2, logits, lse, labels, gscale, LR)
    assert torch.equal(plain, got)


def test_head_dlogits_matches_jax_formulation_bit_for_bit():
    # float32: the same exp, subtraction and product per element; the JAX
    # side's op-by-op (no jit) arithmetic rounds where the port does
    W, h2, logits, lse, labels, gscale = _head_inputs("float32")
    p = jnp.exp(logits - lse[:, None])
    onehot = labels[:, None] == jnp.arange(W.shape[1])[None, :]
    want = np.asarray((p - onehot) * gscale[:, None])
    got = tfh.head_dlogits(*_port_args(W, h2, logits, lse, labels, gscale)[1:])
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -22, atol=0)


def test_use_kernel_on_cpu_runs_the_plain_version_and_counts_nothing():
    args = _port_args(*_head_inputs("bfloat16", seed=3))
    before = tfh.launches
    a = tfh.head_update_sgd(args[0].clone(), *args[1:], LR, use_kernel=True)
    b = tfh.head_update_sgd(args[0].clone(), *args[1:], LR, use_kernel=False)
    assert torch.equal(a, b) and tfh.launches == before


@pytest.mark.parametrize("route,tile,most", [
    pytest.param("f32", 64, 65535, id="dtype0-64"),
    pytest.param("bf16", 128, 65535, id="dtype1-128"),
    pytest.param("bf16_tma", 64, 2 ** 31 - 1, id="bf16_tma-64")])
def test_vocab_check_follows_the_kernels_grid(route, tile, most):
    # K7 launches one block per `tile` vocabulary rows: 64 for the float32
    # kernel and 128 for the bfloat16 one with element loads, at most 65535
    # along the grid's y axis; 64 for the TMA route, along its x axis
    tfh._check_vocab(tile * most, route)
    with pytest.raises(ValueError, match="grid"):
        tfh._check_vocab(tile * most + 1, route)


def _route_inputs(dtype, n, d, v, aligned):
    """h2 (n, d) and logits (n, v) as views into flat buffers, one element
    past a 16-byte boundary unless ``aligned``."""
    off = 0 if aligned else 1
    h2 = torch.zeros(n * d + 8, dtype=dtype)[off:off + n * d].view(n, d)
    logits = torch.zeros(n * v + 8, dtype=dtype)[off:off + n * v].view(n, v)
    return h2, logits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [680, 677])
@pytest.mark.parametrize("d", [64, 60])
@pytest.mark.parametrize("aligned", [True, False])
def test_head_update_route_rule(dtype, v, d, aligned):
    # TMA reads rows that are whole 16-byte units from a 16-byte aligned base:
    # bfloat16 with V % 8 == 0 and D % 8 == 0 and both matrices aligned takes
    # the TMA route, every other bfloat16 input the element loads; float32
    # has one route
    h2, logits = _route_inputs(dtype, 3, d, v, aligned)
    assert (h2.data_ptr() % 16 == 0) == aligned and (logits.data_ptr() % 16 == 0) == aligned
    want = ("f32" if dtype == torch.float32 else
            "bf16_tma" if v % 8 == 0 and d % 8 == 0 and aligned else "bf16")
    assert tfh.head_update_route(h2, logits) == want
    assert want in tfh.route_launches


def _pair(seed=0):
    jlm = JLM(**CFG)
    tx = optax.sgd(LR)
    state = jstate(jlm, jax.random.key(seed), tx)
    model = TransformerLM(**CFG, device="cpu")
    model.load_state_dict(interop.params_from_jax(jax.tree.map(np.asarray, state.params),
                                                  model))
    return jlm, state, model


def _tokens(seed):
    tok = np.random.default_rng(seed).integers(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    return tok, next_token_targets(tok)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fused_head_step_matches_jax_fused_step(use_kernel):
    # float32 tiny LM, two steps on weights carried across: the loss to 1e-5
    # and every parameter to 1e-5 absolute, as the port's AD step is held
    # against the JAX FSDP step (tests/test_torch_transformer.py)
    jlm, state, model = _pair()
    jstep = jfh.make_fused_head_sgd_step(jlm, LR)
    step = tfh.make_fused_head_sgd_step(model, LR, use_kernel=use_kernel)
    tstate = create_lm_train_state(model, SGD(LR))
    for seed in (3, 4):
        tok, tgt = _tokens(seed)
        state, jloss = jstep(state, jnp.asarray(tok), jnp.asarray(tgt))
        tstate, loss = step(tstate, torch.from_numpy(tok).long(), torch.from_numpy(tgt).long())
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert tstate.step == 2 and int(state.step) == 2
    want = interop.params_from_jax(jax.tree.map(np.asarray, state.params), model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)


def test_fused_head_step_matches_the_ports_ad_step():
    # the JAX test's tolerances (tests/test_fused_head.py:63-70): loss rtol
    # 1e-6, parameters rtol 1e-5 / atol 1e-7, at float32
    tok, tgt = _tokens(5)
    tt, tg = torch.from_numpy(tok).long(), torch.from_numpy(tgt).long()
    runs = []
    for build in (lambda m: tfh.make_fused_head_sgd_step(m, LR),
                  lambda m: make_fsdp_lm_train_step(m, SGD(LR))):
        model = TransformerLM(**CFG, seed=6, device="cpu")
        state, loss = build(model)(create_lm_train_state(model, SGD(LR)), tt, tg)
        runs.append((float(loss), {n: p.detach().clone() for n, p in model.named_parameters()}))
    (loss_f, pf), (loss_ad, pad) = runs
    np.testing.assert_allclose(loss_f, loss_ad, rtol=1e-6)
    for name, p in pf.items():
        np.testing.assert_allclose(p.numpy(), pad[name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    assert not torch.equal(pf["lm_head.weight"], TransformerLM(**CFG, seed=6, device="cpu")
                           .lm_head.weight)


def test_bf16_fused_head_step_against_the_ad_step():
    # bf16: the AD loss is a bfloat16 CE summed in bfloat16, the fused one
    # an f32-lse CE summed in float32 (sum(mask) = 62 is exact in both at
    # this size), so the losses agree to bfloat16 rounding of the CE terms and
    # of the loss: 2^-7 relative. The updates agree to 2^-4 relative L2: the
    # AD step's lm_head gradient is rounded to bfloat16 (the fused one is
    # float32) and its dlogits round differently, a few bfloat16 steps in all.
    tok, tgt = _tokens(7)
    tt, tg = torch.from_numpy(tok).long(), torch.from_numpy(tgt).long()
    base = TransformerLM(**CFG, seed=8, dtype=torch.bfloat16, device="cpu")
    w0 = {n: p.detach().clone() for n, p in base.named_parameters()}
    runs = []
    for build in (lambda m: tfh.make_fused_head_sgd_step(m, 0.5),
                  lambda m: make_fsdp_lm_train_step(m, SGD(0.5))):
        model = TransformerLM(**CFG, seed=8, dtype=torch.bfloat16, device="cpu")
        state, loss = build(model)(create_lm_train_state(model, SGD(0.5)), tt, tg)
        runs.append((float(loss), {n: p.detach() - w0[n] for n, p in model.named_parameters()}))
    (loss_f, uf), (loss_ad, uad) = runs
    np.testing.assert_allclose(loss_f, loss_ad, rtol=2.0 ** -7)
    num = sum(float(((uf[n] - uad[n]) ** 2).sum()) for n in uf) ** 0.5
    den = sum(float((uad[n] ** 2).sum()) for n in uad) ** 0.5
    assert num / den <= 2.0 ** -4, num / den


def test_fused_head_step_needs_a_detachable_head():
    model = TransformerLM(**CFG, head=False, device="cpu")
    with pytest.raises(ValueError, match="lm_head"):
        tfh.make_fused_head_sgd_step(model, LR)
