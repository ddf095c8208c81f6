"""``training/train_lm``'s K-step dispatch and checkpointing, on the CPU.

Against the JAX ``examples/train_lm.py --mode single`` K-step program, built
from its own pieces (the one-device FSDP step, ``_make_chunked_step``'s
``lax.scan``): the same batches in the same order from the same seeded
numpy generator, from the same weights (the port's seeded init carried
across by ``utils/interop.params_to_jax``). The model is small (vocab 64,
d_model 128, 2 heads of 64, 2 layers, d_ff 256, seq 256, batch 2), float32.
Tolerances are those of ``tests/test_torch_transformer.py``'s
``test_three_sgd_steps_match_jax_single_device_fsdp_step``: losses rtol
1e-5, parameters atol 1e-5 (the same functions with sums in other orders).

The port against itself, bit for bit: K steps a dispatch equal K single
steps, and a run resumed from its step-K checkpoint equals the
uninterrupted one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_ml_pytorch_tpu.models import TransformerLM as JLM
from distributed_ml_pytorch_tpu.parallel import fsdp as jfsdp
from distributed_ml_pytorch_tpu.parallel.seq_parallel import next_token_targets as jtargets
from distributed_ml_pytorch_tpu.runtime.mesh import make_mesh
from distributed_ml_pytorch_tpu.training.trainer import TrainState as JTrainState
from distributed_ml_pytorch_tpu_torch.parallel.fsdp import make_fsdp_lm_train_step
from distributed_ml_pytorch_tpu_torch.parallel.seq_parallel import create_lm_train_state
from distributed_ml_pytorch_tpu_torch.training import train_lm
from distributed_ml_pytorch_tpu_torch.training.trainer import SGD
from distributed_ml_pytorch_tpu_torch.utils import interop
from examples.train_lm import _make_chunked_step

ARGV = ["--device", "cpu", "--vocab", "64", "--d-model", "128", "--n-heads", "2",
        "--n-layers", "2", "--d-ff", "256", "--seq", "256", "--batch", "2",
        "--pos-encoding", "rope", "--lr", "0.05"]
K = 4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _args(*extra):
    return train_lm.parse_args([*ARGV, *extra])


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_batches_are_the_jax_scripts():
    """One batch, then for K > 1 the K batches drawn after it, from one
    ``default_rng(--seed)`` (JAX ``examples/train_lm.py:111-120, :353-364``)."""
    rng = np.random.default_rng(3)
    first = rng.integers(0, 64, size=(2, 256)).astype(np.int32)
    ks = [rng.integers(0, 64, size=(2, 256)).astype(np.int32) for _ in range(K)]
    tok, tgt = train_lm.lm_batches(_args("--seed", "3"))
    np.testing.assert_array_equal(tok, first)
    np.testing.assert_array_equal(tgt, jtargets(first))
    tok, tgt = train_lm.lm_batches(_args("--seed", "3", "--steps", "8",
                                         "--steps-per-dispatch", str(K)))
    assert tok.shape == tgt.shape == (K, 2, 256) and tok.dtype == np.int32
    for i in range(K):
        np.testing.assert_array_equal(tok[i], ks[i])
        np.testing.assert_array_equal(tgt[i], jtargets(ks[i]))


@pytest.mark.parametrize("loss_chunk", [0, 128], ids=["dense", "chunked"])
def test_k_steps_match_the_jax_k_step_program(loss_chunk):
    """Two dispatches of K = 4 through ``train_lm.run`` against the JAX
    ``--mode single`` program's ``lax.scan`` over its one-device FSDP step."""
    args = _args("--steps", str(2 * K), "--steps-per-dispatch", str(K),
                 "--loss-chunk", str(loss_chunk))
    init = train_lm.build_model(args, "cpu")
    jparams = jax.tree.map(jnp.asarray, interop.params_to_jax(init))
    res = train_lm.run(args)

    jlm = JLM(vocab_size=64, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_len=256,
              pos_encoding="rope")
    tx = optax.sgd(args.lr)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jstate, shardings = jfsdp.create_fsdp_train_state(
        lambda key: JTrainState.create(jparams, tx), jax.random.key(0), mesh)
    chunked = _make_chunked_step(jfsdp.make_fsdp_lm_train_step(
        jlm, tx, mesh, shardings, loss_chunk=loss_chunk))
    tok, tgt = train_lm.lm_batches(args)
    jlosses = []
    for _ in range(2):
        jstate, losses = chunked(jstate, jnp.asarray(tok), jnp.asarray(tgt))
        jlosses += np.asarray(losses).tolist()
    np.testing.assert_allclose(res.losses, jlosses, rtol=1e-5)
    assert res.state.step == 2 * K and res.step_fn.graphed.captures == 0
    want = interop.params_from_jax(jax.tree.map(np.asarray, jstate.params), res.state.model)
    for name, p in res.state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
def test_k_steps_equal_single_steps_bit_for_bit(remat):
    """``--steps-per-dispatch 4 --steps 8`` equals eight single AD steps on
    the same batches in the same order: losses and parameters bit for bit."""
    extra = ["--remat", "--loss-chunk", "128"] if remat else []
    args = _args("--steps", str(2 * K), "--steps-per-dispatch", str(K), *extra)
    res = train_lm.run(args)
    model = train_lm.build_model(args, "cpu")
    state = create_lm_train_state(model, SGD(args.lr))
    step = make_fsdp_lm_train_step(model, SGD(args.lr), loss_chunk=args.loss_chunk)
    tok, tgt = (torch.from_numpy(a.astype(np.int64)) for a in train_lm.lm_batches(args))
    losses = [float(step(state, tok[i % K], tgt[i % K])[1]) for i in range(2 * K)]
    assert res.losses == losses and state.step == res.state.step == 2 * K
    got, want = _params(res.state.model), _params(model)
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("k,every,steps,saved", [(1, 3, 7, [3, 6, 7]), (K, 3, 8, [8]),
                                                 (K, K, 8, [K, 8])])
def test_ckpt_every_accepts_its_multiples_and_the_final_save(tmp_path, k, every, steps, saved):
    """A save is offered after every dispatch at ``(i + 1)·K`` and accepted
    on multiples of ``--ckpt-every``; the last step is always saved."""
    train_lm.run(_args("--steps", str(steps), "--steps-per-dispatch", str(k),
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", str(every)))
    assert sorted(int(n) for n in os.listdir(tmp_path)) == saved


@pytest.mark.parametrize("k", [1, K])
def test_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path, k):
    """Eight steps checkpointed every four, against four steps and a resume
    that trains four more from the step-4 checkpoint: the same losses, the
    same final parameters, and the same step-8 checkpoint, bit for bit."""
    full = train_lm.run(_args("--steps", "8", "--steps-per-dispatch", str(k),
                              "--ckpt-dir", str(tmp_path / "full"), "--ckpt-every", "4"))
    cut = ["--steps", "4", "--steps-per-dispatch", str(k), "--ckpt-dir",
           str(tmp_path / "cut"), "--ckpt-every", "4"]
    first = train_lm.run(_args(*cut))
    assert first.start_step == 0 and sorted(os.listdir(tmp_path / "cut")) == ["4"]
    resumed = train_lm.run(_args(*cut, "--resume"))
    assert resumed.start_step == 4 and resumed.state.step == 8
    assert first.losses + resumed.losses == full.losses
    got, want = _params(resumed.state.model), _params(full.state.model)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    a = torch.load(tmp_path / "full" / "8" / "state.pt", weights_only=True)
    b = torch.load(tmp_path / "cut" / "8" / "state.pt", weights_only=True)
    assert a["step"] == b["step"] == 8
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name


def test_resume_without_a_checkpoint_starts_fresh(tmp_path, capsys):
    res = train_lm.run(_args("--steps", "2", "--ckpt-dir", str(tmp_path), "--resume"))
    assert res.start_step == 0 and res.state.step == 2
    assert "resumed" not in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["2"]


def test_main_prints_each_fifth_dispatch_at_its_first_step(capsys):
    """The JAX script's log: ``step {i·K}`` with the dispatch's last loss."""
    assert train_lm.main([*ARGV, "--steps", "40", "--steps-per-dispatch", str(K),
                          "--d-model", "64", "--d-ff", "128", "--seq", "64"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("  step")]
    assert [int(ln.split()[1]) for ln in lines] == [0, 8, 16, 24, 32]
