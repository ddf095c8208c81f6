"""Tensor-parallel decode (``models/generate.generate_tp``) of the port on
worlds of threads, against the port's one-device ``generate()`` and the JAX
package's ``generate_tp`` (its ``tests/test_generate.py`` cases).

The tiny LM (vocab 64, d_model 32, 4 heads, 2 layers, d_ff 64), float32,
weights from the JAX init. Greedy tokens must be equal, not close: on the
plain path (8 new tokens, a 2 × 2 mesh, against JAX's ``generate_tp`` too),
on the blocked path (20 new tokens, K8's plain version on the CPU) and on
the int8 cache, on 1 × 2 and 2 × 2 meshes. Sampling at a temperature draws
``generate()``'s tokens when the data axis is 1. An indivisible head count
is refused, and ``examples/generate_text --tp 2`` prints the one-device
run's tokens.
"""

import contextlib
import importlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.models.transformer import TransformerLM as JLM
from distributed_ml_pytorch_tpu.runtime.mesh import make_mesh as jmake_mesh
from distributed_ml_pytorch_tpu_torch.examples import generate_text
from distributed_ml_pytorch_tpu_torch.models import TransformerLM
from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
from distributed_ml_pytorch_tpu_torch.utils import interop

jgen = importlib.import_module("distributed_ml_pytorch_tpu.models.generate")
tgen = importlib.import_module("distributed_ml_pytorch_tpu_torch.models.generate")
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=64)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def params():
    p = JLM(**CFG).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, p)


def _model(params):
    model = TransformerLM(**CFG, device="cpu")
    model.load_state_dict(interop.params_from_jax(params, model))
    return model


def _tp(params, shape, prompt, new, **kw):
    out = run_threaded(shape["data"] * shape["model"], lambda w: tgen.generate_tp(
        _model(params), prompt, new, make_mesh(shape, world=w), **kw))
    assert all(torch.equal(o, out[0]) for o in out)  # every rank holds the whole batch
    return out[0]


def test_tp_sharded_decode_matches_single_device(params):
    prompt = np.random.default_rng(1).integers(0, 64, size=(2, 6)).astype(np.int32)
    want = tgen.generate(_model(params), torch.from_numpy(prompt), 8)
    jmesh = jmake_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    jwant = jgen.generate_tp(JLM(**CFG), jax.tree.map(jnp.asarray, params),
                             jnp.asarray(prompt), 8, jmesh)
    got = _tp(params, {"data": 2, "model": 2}, prompt, 8)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


@pytest.mark.parametrize("shape", [{"data": 1, "model": 2}, {"data": 2, "model": 2}])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_tp_blocked_decode_matches_single_device(params, shape, kv_quant):
    """20 new tokens: the ring-buffered path (K8 in every step on the card),
    with the bf16/f32 cache and the int8 one."""
    prompt = np.random.default_rng(2).integers(0, 64, size=(2, 6)).astype(np.int32)
    model = _model(params)
    assert tgen.uses_block_decode(model, 6, 20)[0]
    want = tgen.generate(model, torch.from_numpy(prompt), 20, kv_quant=kv_quant)
    got = _tp(params, shape, prompt, 20, kv_quant=kv_quant)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_tp_sampling_matches_single_device(params):
    prompt = np.random.default_rng(3).integers(0, 64, size=(2, 6)).astype(np.int32)
    kw = dict(temperature=0.9, seed=5, top_k=10)
    want = tgen.generate(_model(params), torch.from_numpy(prompt), 20, **kw)
    got = _tp(params, {"data": 1, "model": 2}, prompt, 20, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_tp_decode_rejects_indivisible_heads():
    bad = dict(vocab_size=64, d_model=30, n_heads=3, n_layers=1, d_ff=64, max_len=64)
    with pytest.raises(ValueError, match="divisible"):
        run_threaded(2, lambda w: tgen.generate_tp(
            TransformerLM(**bad, device="cpu"), np.zeros((1, 2), np.int32), 4,
            make_mesh({"data": 1, "model": 2}, world=w)))


def test_generate_text_tp_prints_the_single_device_tokens():
    argv = ["--backend", "cpu", "--new-tokens", "20", "--batch", "2", "--prompt-len", "8",
            "--vocab", "64", "--d-model", "32", "--n-heads", "4", "--d-ff", "64"]
    outs = []
    for extra in ([], ["--tp", "2"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert generate_text.main(argv + extra) == 0
        outs.append([ln for ln in buf.getvalue().splitlines() if ln.startswith("[")])
    assert outs[0] == outs[1] and len(outs[0]) == 4
