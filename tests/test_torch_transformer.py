"""The port's TransformerLM, LM losses and single-device LM training against
the JAX package's, on the CPU, from weights carried across with
``utils/interop.params_from_jax``.

The model is tiny (vocab 64, d_model 64, 2 heads of 32, 2 layers, d_ff 128,
seq 256, batch 2). Where the JAX model gets the Pallas flash kernel in
interpret mode as its ``attn_fn``, the port runs its default attention (the
flash plain versions on a CPU tensor).

Tolerances, float32: logits 1e-4 absolute and relative; losses 1e-5
relative; gradients 1e-4 absolute; parameters after three SGD steps 1e-5
absolute. Both sides compute the same functions with sums in other orders
(XLA's CPU dots against oneDNN's, an online softmax against a one-pass one).

bfloat16 (``dtype=bfloat16``, float32 master weights) is held in two ways.
The rounding points of block 0 (Embed's cast-then-gather, LayerNorm in f32
then cast, Dense casting weight and input, RoPE's f32 round trip, the
residual add) must give the JAX model's bits in at least 99.9 % of the
elements, the rest within two bfloat16 steps of the tensor's largest
value; there XLA is compiled with
``xla_allow_excess_precision`` off, so it rounds wherever the program says
(by default it may keep a fused sum, such as the residual feeding
LayerNorm, in f32) and both sides run the scan attention, which rounds once.
A float32-everywhere port matches under 99 % there, and the test checks that
too. The loss and the gradients, with the Pallas flash kernel in the JAX
model, are held at: loss within one bfloat16 step (2^-7 relative), logits
within 1e-2 relative L2, gradients within 8e-3 relative L2 over all
parameters and 1.5e-2 for each; the float32 port's gradients miss the 8e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_ml_pytorch_tpu.models import TransformerLM as JLM
from distributed_ml_pytorch_tpu.ops.attention import flash_attention as jflash
from distributed_ml_pytorch_tpu.ops.attention import scan_attn_fn as jscan
from distributed_ml_pytorch_tpu.parallel import fsdp as jfsdp
from distributed_ml_pytorch_tpu.parallel.seq_parallel import next_token_targets as jtargets
from distributed_ml_pytorch_tpu.runtime.mesh import make_mesh
from distributed_ml_pytorch_tpu.training.trainer import TrainState as JTrainState
from distributed_ml_pytorch_tpu.training.trainer import chunked_lm_loss as jchunked
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.ops.attention import scan_attn_fn
from distributed_ml_pytorch_tpu_torch.parallel.fsdp import lm_loss_builder, make_fsdp_lm_train_step
from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import (
    create_lm_train_state,
    next_token_targets,
)
from distributed_ml_pytorch_tpu_torch.training import train_lm
from distributed_ml_pytorch_tpu_torch.training.trainer import SGD, chunked_lm_loss
from distributed_ml_pytorch_tpu_torch.utils import interop

CFG = dict(vocab_size=64, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=256)
B, S = 2, 256
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

JFLASH = functools.partial(jflash, causal=True, interpret=True, block_q=128, block_k=128)
BF16_STEP = 2.0 ** -7  # one bfloat16 step, at most, relative to the value
#: block 0's modules whose bfloat16 outputs are held bit for bit
BLOCK0_ROUNDING_POINTS = ["tok_embed", "block_0/LayerNorm_0", "block_0/attn/q",
                          "block_0/attn/k", "block_0/attn/v", "block_0/attn/o",
                          "block_0/LayerNorm_1", "block_0/Dense_0"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, CFG["vocab_size"], size=(B, S)).astype(np.int32)
    return tok, next_token_targets(tok)


def _pair(attn_fn=None, seed=0, **kw):
    # init at seq 8 with the default attention (no flash blocking there)
    jparams = JLM(**CFG, **kw).init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    jlm = JLM(**CFG, attn_fn=attn_fn, **kw)
    tree = jax.tree.map(np.asarray, jparams)
    model = TransformerLM(**CFG, device="cpu", **kw)
    model.load_state_dict(interop.params_from_jax(tree, model))
    return jlm, jparams, model


def _dense_loss_jax(jlm, params, tok, tgt):
    state = JTrainState.create(params, optax.sgd(0.0))
    return jfsdp.lm_loss_builder(jlm)(state, jnp.asarray(tok), jnp.asarray(tgt))(params)


def _flat_grads(model):
    return {n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("kw", [dict(pos_encoding="learned"), dict(pos_encoding="rope"),
                                dict(pos_encoding="rope", fused_qkv=True)],
                         ids=["learned", "rope", "rope-fused_qkv"])
def test_logits_match_jax_with_interpret_flash(kw):
    jlm, jparams, model = _pair(attn_fn=JFLASH, **kw)
    tok, _ = _tokens()
    ref = np.asarray(jax.jit(lambda p: jlm.apply({"params": p}, jnp.asarray(tok)))(jparams))
    got = model(torch.from_numpy(tok).long())
    assert got.shape == (B, S, CFG["vocab_size"])
    np.testing.assert_allclose(got.detach().numpy(), ref, **LOGIT_TOL)


def test_loss_gradients_match_jax_with_interpret_flash():
    # the JAX side runs the flash forward (K4) and fused backward (K5) kernels
    jlm, jparams, model = _pair(attn_fn=JFLASH, pos_encoding="rope")
    tok, tgt = _tokens(1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _dense_loss_jax(jlm, p, tok, tgt)))(jparams)
    loss = lm_loss_builder(model)(torch.from_numpy(tok).long(), torch.from_numpy(tgt).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = interop.params_from_jax(jax.tree.map(np.asarray, jgrads), model)
    got = _flat_grads(model)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g.numpy(), err_msg=name, **GRAD_TOL)


def _bf16_pair(jattn, attn_fn=None, dtype=torch.bfloat16):
    """The JAX model in bfloat16 with ``jattn``, its float32 weights, and the
    port's model in ``dtype`` with ``attn_fn`` on the same weights."""
    kw = dict(pos_encoding="rope")
    jparams = JLM(**CFG, dtype=jnp.bfloat16, **kw).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(**CFG, dtype=dtype, attn_fn=attn_fn, device="cpu", **kw)
    model.load_state_dict(interop.params_from_jax(jax.tree.map(np.asarray, jparams), model))
    return JLM(**CFG, dtype=jnp.bfloat16, attn_fn=jattn, **kw), jparams, model


def _port_outputs(model, tok, names):
    """Each named submodule's output, rounded to bfloat16, as float32 numpy."""
    got, hooks = {}, []
    for name in names:
        mod = model.get_submodule(name.replace("/", "."))
        hooks.append(mod.register_forward_hook(
            lambda _m, _i, out, name=name: got.__setitem__(name, out)))
    model(torch.from_numpy(tok).long())
    for h in hooks:
        h.remove()
    return {n: t.detach().to(torch.bfloat16).float().numpy() for n, t in got.items()}


def test_bf16_rounding_points_match_jax_bit_for_bit():
    jlm, jparams, model = _bf16_pair(jscan, scan_attn_fn)
    tok, _ = _tokens(1)
    fn = jax.jit(lambda p: jlm.apply({"params": p}, jnp.asarray(tok),
                                     capture_intermediates=True)[1]["intermediates"])
    inter = fn.lower(jparams).compile(
        compiler_options={"xla_allow_excess_precision": False})(jparams)
    want = {n: np.asarray(functools.reduce(lambda d, k: d[k], n.split("/"), inter)
                          ["__call__"][0].astype(jnp.float32))
            for n in BLOCK0_ROUNDING_POINTS}
    got = _port_outputs(model, tok, BLOCK0_ROUNDING_POINTS)
    for name in BLOCK0_ROUNDING_POINTS:
        g, w = got[name], want[name]
        assert np.mean(g == w) >= 0.999, (name, np.mean(g == w))
        # a flip upstream moves a whole row a little, so the scale is the
        # tensor's, not the element's
        diff = float(np.abs(g - w).max())
        assert diff <= 2 * BF16_STEP * float(np.abs(w).max()), (name, diff)
    # a port that computed in float32 throughout, rounded only at the end
    _, _, f32_model = _bf16_pair(jscan, scan_attn_fn, dtype=torch.float32)
    f32 = _port_outputs(f32_model, tok, BLOCK0_ROUNDING_POINTS)
    for name in BLOCK0_ROUNDING_POINTS[1:]:
        assert np.mean(f32[name] == want[name]) < 0.99, name


def test_bf16_loss_and_gradients_match_jax_with_interpret_flash():
    jlm, jparams, model = _bf16_pair(JFLASH)
    tok, tgt = _tokens(1)
    jlogits, (jloss, jgrads) = jax.jit(lambda p: (
        jlm.apply({"params": p}, jnp.asarray(tok)).astype(jnp.float32),
        jax.value_and_grad(lambda q: _dense_loss_jax(jlm, q, tok, tgt))(p)))(jparams)
    jlogits, jgrads = np.asarray(jlogits), jax.tree.map(np.asarray, jgrads)

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    # the float32 model: a port that would not round where the JAX one does
    models = {torch.bfloat16: model, torch.float32: _bf16_pair(JFLASH, dtype=torch.float32)[2]}
    tt, tg = torch.from_numpy(tok).long(), torch.from_numpy(tgt).long()
    grads_err = {}
    for dtype, model in models.items():
        logits = model(tt)
        loss = lm_loss_builder(model)(tt, tg)
        loss.backward()
        want = interop.params_from_jax(jgrads, model)
        got = _flat_grads(model)
        per = {n: rel_l2(got[n], w.numpy()) for n, w in want.items()}
        total = np.sqrt(sum(((got[n] - w.numpy()) ** 2).sum() for n, w in want.items())
                        / sum((w.numpy() ** 2).sum() for w in want.values()))
        grads_err[dtype] = total
        if dtype == torch.bfloat16:
            assert logits.dtype == torch.bfloat16 and loss.dtype == torch.bfloat16
            np.testing.assert_allclose(loss.item(), float(jloss), rtol=BF16_STEP)
            assert rel_l2(logits.float().detach().numpy(), jlogits) <= 1e-2
            assert total <= 8e-3, total
            assert max(per.values()) <= 1.5e-2, per
    assert grads_err[torch.float32] > 8e-3, grads_err


def test_chunked_loss_equals_dense_and_both_match_jax():
    jlm, jparams, model = _pair()
    tok, tgt = _tokens(2)
    ref_dense, ref_chunked = map(float, jax.jit(lambda p: (
        _dense_loss_jax(jlm, p, tok, tgt),
        jchunked(jlm, p, jnp.asarray(tok), jnp.asarray(tgt), chunk=64)))(jparams))
    tt, tg = torch.from_numpy(tok).long(), torch.from_numpy(tgt).long()
    dense = lm_loss_builder(model)(tt, tg)
    chunked = chunked_lm_loss(model, tt, tg, chunk=64)
    np.testing.assert_allclose(chunked.item(), dense.item(), rtol=1e-6)
    np.testing.assert_allclose(dense.item(), ref_dense, rtol=1e-5)
    np.testing.assert_allclose(chunked.item(), ref_chunked, rtol=1e-5)
    dense.backward()
    g_dense = _flat_grads(model)
    model.zero_grad(set_to_none=True)
    lm_loss_builder(model, loss_chunk=128)(tt, tg).backward()
    for name, g in _flat_grads(model).items():
        np.testing.assert_allclose(g, g_dense[name], rtol=1e-5, atol=1e-7, err_msg=name)
    with pytest.raises(ValueError, match="divide"):
        chunked_lm_loss(model, tt, tg, chunk=100)


def test_remat_gives_the_same_gradients():
    tok, tgt = _tokens(3)
    tt, tg = torch.from_numpy(tok).long(), torch.from_numpy(tgt).long()
    grads = []
    for remat in (False, True):
        model = TransformerLM(**CFG, remat=remat, pos_encoding="rope", seed=4, device="cpu")
        lm_loss_builder(model)(tt, tg).backward()
        grads.append(_flat_grads(model))
    for name, g in grads[0].items():
        np.testing.assert_array_equal(grads[1][name], g, err_msg=name)


@pytest.mark.parametrize("kw", [dict(), dict(fused_qkv=True, pos_encoding="rope")])
def test_interop_round_trip_and_mismatch(kw):
    jlm, jparams, model = _pair(**kw)
    tree = jax.tree.map(np.asarray, jparams)
    back = interop.params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # a layer too many, a layer missing, a wrong shape
    extra = dict(tree, block_9=tree["block_0"])
    with pytest.raises(ValueError, match="extra"):
        interop.params_from_jax(extra, model)
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="missing"):
        interop.params_from_jax(missing, model)
    bad = dict(tree, LayerNorm_0=dict(tree["LayerNorm_0"], scale=np.ones(3, np.float32)))
    with pytest.raises(ValueError, match="LayerNorm_0/scale"):
        interop.params_from_jax(bad, model)


def test_three_sgd_steps_match_jax_single_device_fsdp_step():
    lr = 0.05
    jlm, jparams, model = _pair(pos_encoding="rope", seed=5)
    tok, _ = _tokens(5)
    tgt = jtargets(tok)
    tx = optax.sgd(lr)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jstate, shardings = jfsdp.create_fsdp_train_state(
        lambda key: JTrainState.create(jparams, tx), jax.random.key(0), mesh)
    jstep = jfsdp.make_fsdp_lm_train_step(jlm, tx, mesh, shardings)
    state = create_lm_train_state(model, SGD(lr))
    step = make_fsdp_lm_train_step(model, SGD(lr))
    tt, tg = torch.from_numpy(tok).long(), torch.from_numpy(tgt).long()
    for _ in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(tok), jnp.asarray(tgt))
        state, loss = step(state, tt, tg)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.step == 3
    want = interop.params_from_jax(jax.tree.map(np.asarray, jstate.params), model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)


def test_seeded_init_and_train_state():
    a, b = (TransformerLM(**CFG, seed=7, device="cpu") for _ in range(2))
    c = TransformerLM(**CFG, seed=8, device="cpu")
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), n
        assert n.endswith((".bias", "LayerNorm_0.weight", "LayerNorm_1.weight")) or (
            not torch.equal(pa, pc)), n
    # flax's default distributions: embeddings N(0, 1/d), dense kernels cut at 2 std
    d = CFG["d_model"]
    assert abs(float(a.tok_embed.weight.std()) - d ** -0.5) < 0.1 * d ** -0.5
    w = a.block_0.Dense_0.weight
    assert float(w.abs().max()) <= 2 * (1 / d) ** 0.5 / 0.87962566103423978 + 1e-6
    state = create_lm_train_state(a, SGD(0.1, momentum=0.9))
    assert state.model is a and state.step == 0
    assert len(state.opt_state) == len(list(a.parameters()))


def test_train_lm_main_on_cpu(capsys):
    argv = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "128",
            "--vocab", "64", "--d-model", "64", "--n-heads", "2", "--d-ff", "128",
            "--pos-encoding", "rope", "--loss-chunk", "64"]
    assert train_lm.main(argv) == 0
    out = capsys.readouterr().out
    final = [ln for ln in out.splitlines() if ln.startswith("final loss")]
    assert len(final) == 1 and np.isfinite(float(final[0].split()[2].rstrip(";")))
    assert "step    0  loss" in out


@pytest.mark.parametrize("argv", [["--mode", "fsdp"], ["--steps-per-dispatch", "2"],
                                  ["--ckpt-dir", "ckpt"], ["--d-model", "100"]])
def test_train_lm_rejects_unported_or_bad_flags(argv, capsys):
    with pytest.raises(SystemExit):
        train_lm.parse_args(["--device", "cpu", *argv])
    err = capsys.readouterr().err
    assert "not ported yet" in err or "divisible" in err


def test_decode_is_not_ported():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TransformerLM(**CFG, decode=True, cache_size=16, device="cpu")
