"""Megatron tensor parallelism (``parallel/tensor_parallel.py``) of the port on
worlds of threads, case for case as the JAX package's
``tests/test_tensor_parallel.py``.

The tiny LM (vocab 64, d_model 32, 4 heads, 2 layers, d_ff 64), float32,
SGD lr 0.1, batch 4 × 16 (8 × 16 for the factorizations). Against the JAX
dp×tp step on a 2 × 2 mesh from the same weights, three steps: losses rtol
2e-5 and parameters rtol 3e-5, atol 1e-6 (the JAX test's own bounds
between its sharded and unsharded runs: the row-parallel sums add the
ranks' partial products in another order). The loss does not depend on the
dp × tp factorization (rtol 2e-5, the JAX test's), a replicated fused
``qkv`` trains as the unfused layers do, attention runs on each rank's
``n_heads / tp`` heads (counted), and ``train_lm --mode tp`` runs as two
processes through ``launch.py``.
"""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_ml_pytorch_tpu.models.transformer import TransformerLM as JLM
from distributed_ml_pytorch_tpu.parallel import tensor_parallel as jtp
from distributed_ml_pytorch_tpu.parallel.seq_parallel import next_token_targets
from distributed_ml_pytorch_tpu.runtime.mesh import make_mesh as jmake_mesh
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.ops import attention as at
from distributed_ml_pytorch_tpu_torch.parallel import tensor_parallel as tp
from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
from distributed_ml_pytorch_tpu_torch.training import trainer as ttr
from distributed_ml_pytorch_tpu_torch.utils import interop

tgen = importlib.import_module("distributed_ml_pytorch_tpu_torch.models.generate")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=128)
LR = 0.1
LOSS_TOL = dict(rtol=2e-5)
PARAM_TOL = dict(rtol=3e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_params():
    p = JLM(**CFG).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, p)


def make_batch(batch=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 64, size=(batch, seq)).astype(np.int32)
    return tokens, next_token_targets(tokens)


def _model(params=None, **extra):
    model = TransformerLM(**CFG, **extra, device="cpu")
    if params is not None:
        model.load_state_dict(interop.params_from_jax(params, model))
    return model


def _tp_run(params, shape, tokens, targets, steps=3, **extra):
    """A world of dp × tp threads: ``steps`` TP steps; returns every rank's
    losses and local state dict."""

    def rank(world):
        mesh = make_mesh(shape, world=world)
        model = _model(params, **extra)
        tx = ttr.SGD(LR)
        state = tp.create_tp_train_state(model, tx, mesh)
        step = tp.make_tp_train_step(model, tx, mesh)
        a, b = tp.shard_tp_batch(mesh, tokens, targets)
        losses = [float(step(state, a, b)[1]) for _ in range(steps)]
        return losses, {n: p.detach().clone() for n, p in model.named_parameters()}, state

    return run_threaded(shape["data"] * shape["model"], rank)


def test_tp_param_specs_follow_megatron_rules():
    specs = tp.tp_param_specs(dict(_model().named_parameters()))
    assert specs["block_0.attn.q.weight"] == 0
    assert specs["block_0.attn.o.weight"] == 1
    assert specs["block_0.Dense_0.weight"] == 0
    assert specs["block_0.Dense_0.bias"] == 0
    assert specs["block_0.Dense_1.weight"] == 1
    assert specs["block_0.Dense_1.bias"] is None
    assert specs["lm_head.weight"] == 0
    assert specs["tok_embed.weight"] is None
    assert specs["block_0.LayerNorm_0.weight"] is None


def test_tp_state_is_actually_sharded():
    def rank(world):
        mesh = make_mesh({"data": 2, "model": 2}, world=world)
        model = _model()
        state = tp.create_tp_train_state(model, ttr.SGD(LR, momentum=0.9), mesh)
        params = dict(model.named_parameters())
        traces = dict(zip(params, state.opt_state.slots["trace"]))
        return {n: tuple(p.shape) for n, p in params.items()}, {
            n: tuple(t.shape) for n, t in traces.items()}

    shapes, traces = run_threaded(4, rank)[0]
    assert shapes["block_0.attn.q.weight"] == (16, 32)
    assert shapes["block_0.attn.o.weight"] == (32, 16)
    assert shapes["block_0.Dense_0.bias"] == (32,)
    assert shapes["lm_head.weight"] == (32, 32)
    assert shapes["tok_embed.weight"] == (64, 32)
    # the momentum mirrors the local shards: created sharded
    assert traces == shapes


def test_tp_training_matches_unsharded_exactly(jax_params):
    tokens, targets = make_batch()
    jmodel = JLM(**CFG)
    mesh = jmake_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    jtx = optax.sgd(LR)
    jstate = jtp.create_tp_train_state(jmodel, jax.random.key(0), jtx, mesh)
    jstep = jtp.make_tp_train_step(jmodel, jtx, mesh)
    stok, stgt = jtp.shard_tp_batch(mesh, tokens, targets)
    jlosses = []
    for _ in range(3):
        jstate, loss = jstep(jstate, stok, stgt)
        jlosses.append(float(loss))
    out = _tp_run(jax_params, {"data": 2, "model": 2}, tokens, targets)
    np.testing.assert_allclose(out[0][0], jlosses, **LOSS_TOL)
    ref = interop.params_from_jax(jax.tree.map(np.asarray, jax.device_get(jstate.params)),
                                  _model())
    specs = tp.tp_param_specs(ref)
    for name, full in ref.items():
        d = specs[name]
        for r, (_, local, _) in enumerate(out):
            m = r % 2  # rank 2·d + m holds model shard m
            want = full if d is None else full.chunk(2, dim=d)[m]
            np.testing.assert_allclose(local[name].numpy(), want.numpy(),
                                       err_msg=f"{name} rank {r}", **PARAM_TOL)


def test_tp_rejects_indivisible_dimensions():
    bad = dict(vocab_size=64, d_model=30, n_heads=3, n_layers=1, d_ff=60)

    def rank(world):
        mesh = make_mesh({"data": 1, "model": 2}, world=world)
        tp.make_tp_train_step(TransformerLM(**bad, device="cpu"), ttr.SGD(LR), mesh)

    with pytest.raises(ValueError, match="not divisible"):
        run_threaded(2, rank)


def test_tp_composes_with_data_parallel_batch_split(jax_params):
    """The loss is the same whichever dp × tp factorization the mesh uses."""
    tokens, targets = make_batch(batch=8, seq=16)
    losses = [_tp_run(jax_params, {"data": d, "model": m}, tokens, targets, steps=1)[0][0][0]
              for d, m in ((2, 2), (4, 1), (1, 4))]
    np.testing.assert_allclose(losses, losses[0] * np.ones(len(losses)), **LOSS_TOL)


def test_tp_fused_qkv_is_replicated_and_trains_as_unfused(jax_params):
    tokens, targets = make_batch()
    shape = {"data": 1, "model": 2}
    plain = _tp_run(jax_params, shape, tokens, targets)
    # the same weights in the fused layout (JAX's table leaves qkv replicated)
    fused = _tp_run_fused(tgen._fuse_qkv_params(_model(jax_params).state_dict()), shape,
                          tokens, targets)
    np.testing.assert_allclose(fused[0][0], plain[0][0], rtol=1e-6)
    for r in range(2):
        w = fused[r][1]["block_0.attn.qkv.weight"]
        assert w.shape == (96, 32)  # replicated: every rank holds all heads
        assert torch.equal(w, fused[1 - r][1]["block_0.attn.qkv.weight"])
        q = plain[r][1]["block_0.attn.q.weight"]
        np.testing.assert_allclose(w[r * 16:(r + 1) * 16].numpy(), q.numpy(), rtol=1e-6,
                                   atol=1e-7)


def _tp_run_fused(state_dict, shape, tokens, targets, steps=3):
    def rank(world):
        mesh = make_mesh(shape, world=world)
        model = TransformerLM(**CFG, fused_qkv=True, device="cpu")
        model.load_state_dict(state_dict)
        tx = ttr.SGD(LR)
        state = tp.create_tp_train_state(model, tx, mesh)
        step = tp.make_tp_train_step(model, tx, mesh)
        a, b = tp.shard_tp_batch(mesh, tokens, targets)
        losses = [float(step(state, a, b)[1]) for _ in range(steps)]
        return losses, {n: p.detach().clone() for n, p in model.named_parameters()}, state

    return run_threaded(shape["data"] * shape["model"], rank)


def test_tp_attention_runs_on_local_heads(monkeypatch):
    """Attention is rank-local: one flash forward per layer and step, each on
    ``n_heads / tp`` heads (the plain versions stand in for K4/K5 on the
    CPU; ``tests/test_torch_gpu.py`` counts the kernels' launches)."""
    seen = []
    real = at.flash_fwd_plain

    def record(q, *a, **k):
        seen.append(tuple(q.shape))
        return real(q, *a, **k)

    monkeypatch.setattr(at, "flash_fwd_plain", record)
    tokens, targets = make_batch(batch=2, seq=128)  # a length the flash blocks take
    _tp_run(None, {"data": 1, "model": 2}, tokens, targets, steps=2)
    # 2 ranks x 2 layers x 2 steps; q as (batch x local heads, seq, head_dim)
    assert seen == [(2 * 2, 128, 8)] * (2 * 2 * 2)


def test_train_lm_tp_two_processes(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.launch", "--world-size", "2",
         "--entry", "train_lm", "--", "--mode", "tp", "--dist-backend", "gloo", "--device",
         "cpu", "--steps", "3", "--batch", "4", "--seq", "32", "--vocab", "64",
         "--d-model", "32", "--n-heads", "4", "--d-ff", "64"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "1x2 dp x tp on cpu" in proc.stdout
    assert proc.stdout.count("final loss") == 1
