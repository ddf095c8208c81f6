"""The port's step builders and training loop (``training/trainer.py``).

Against the JAX trainer, from the same weights (``utils/interop``) and the
same seeded batches, on a float32 AlexNet: ``make_scan_train_step`` (K = 3)
against JAX's ``lax.scan``, ``make_accum_train_step`` in both update modes
and ``make_scan_accum_train_step`` (U = 2, microbatch 8). Tolerance: losses
rtol 1e-5; parameters rtol 1e-5, atol 2e-6 — each side sums the
convolutions' products in its own order (1e-5 relative on the gradients,
``tests/test_torch_models.py``), and an update moves a parameter by lr
(0.1) times its gradient, so the parameters agree to about 1e-6 after three
updates.

The port against itself, bit for bit on the CPU: K steps a dispatch equal K
single steps; the chunked loop gives the per-step loop's CSV and parameters,
its chunks ending at eval and checkpoint boundaries; prefetch changes
nothing; a run interrupted after a checkpoint and resumed equals an
uninterrupted one.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.models import AlexNet as JAlexNet
from distributed_ml_pytorch_tpu.training import trainer as jtr
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.training import cli
from distributed_ml_pytorch_tpu_torch.training import trainer as ttr
from distributed_ml_pytorch_tpu_torch.utils import checkpoint as tck
from distributed_ml_pytorch_tpu_torch.utils import interop

LR = 0.1
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=2e-6)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_alexnet():
    """The JAX model and its initial parameters as numpy (the JAX steps
    donate their state, so each test makes its own arrays)."""
    jmodel = JAlexNet()
    jparams = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return jmodel, jax.tree.map(np.asarray, jparams)


def _port_alexnet(params):
    model = get_model("alexnet", device="cpu")
    model.load_state_dict(interop.params_from_jax(params, model))
    return model


def _jax_state(params, tx):
    return jtr.TrainState.create(jax.tree.map(jnp.asarray, params), tx)


def _batches(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(*shape, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=shape).astype(np.int32)
    return x, y


def _assert_params(model, jparams):
    ref = interop.params_from_jax(jax.tree.map(np.asarray, jparams), model)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), err_msg=name, **PARAM_TOL)


def test_scan_train_step_matches_jax_scan(jax_alexnet):
    jmodel, jparams = jax_alexnet
    x, y = _batches((3, 8))
    tx = jtr.build_tx("sgd", LR)
    jstate = _jax_state(jparams, tx)
    jstate, jlosses = jtr.make_scan_train_step(jmodel, tx)(
        jstate, jnp.asarray(x), jnp.asarray(y), jax.random.key(1))
    model = _port_alexnet(jparams)
    ttx = ttr.build_tx("sgd", LR)
    state = ttr.create_train_state(model, ttx)
    state, losses = ttr.make_scan_train_step(model, ttx)(state, x, y)
    assert state.step == int(jstate.step) == 3
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **LOSS_TOL)
    _assert_params(model, jstate.params)


@pytest.mark.parametrize("effective", [None, 4])
def test_accum_train_step_matches_jax(jax_alexnet, effective):
    """B = 16 in two microbatches of 8: the mean over B (None), or the sum of
    the four batch-4 mean gradients (microbatch/e = 2 times the sum of the
    two microbatch means)."""
    jmodel, jparams = jax_alexnet
    x, y = _batches((16,), seed=1)
    tx = jtr.build_tx("sgd", LR, momentum=0.9)
    jstate = _jax_state(jparams, tx)
    step = jtr.make_accum_train_step(jmodel, tx, 8, effective_update_batch=effective)
    jstate, jloss = step(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.key(1))
    model = _port_alexnet(jparams)
    ttx = ttr.build_tx("sgd", LR, momentum=0.9)
    state = ttr.create_train_state(model, ttx)
    tstep = ttr.make_accum_train_step(model, ttx, 8, effective_update_batch=effective)
    state, loss = tstep(state, x, y)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    _assert_params(model, jstate.params)


def test_scan_accum_train_step_matches_jax(jax_alexnet):
    jmodel, jparams = jax_alexnet
    x, y = _batches((2, 16), seed=2)
    tx = jtr.build_tx("sgd", LR, momentum=0.9)
    jstate = _jax_state(jparams, tx)
    jstate, jlosses = jtr.make_scan_accum_train_step(jmodel, tx, 8, effective_update_batch=8)(
        jstate, jnp.asarray(x), jnp.asarray(y), jax.random.key(1))
    model = _port_alexnet(jparams)
    ttx = ttr.build_tx("sgd", LR, momentum=0.9)
    state = ttr.create_train_state(model, ttx)
    state, losses = ttr.make_scan_accum_train_step(model, ttx, 8, effective_update_batch=8)(
        state, x, y)
    assert state.step == int(jstate.step) == 2 and int(state.opt_state.count) == 2
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **LOSS_TOL)
    _assert_params(model, jstate.params)


def _flat(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


@pytest.mark.parametrize("name", ["alexnet", "lenet"])
def test_k_steps_a_dispatch_equal_k_single_steps(name):
    """Bit for bit, LeNet's dropout masks included (one generator, drawn in
    the same order)."""
    x, y = _batches((3, 4), seed=3)
    runs = []
    for scan in (True, False):
        model = get_model(name, seed=1, device="cpu")
        tx = ttr.build_tx("adamw", 1e-2, grad_clip=1.0)
        state = ttr.create_train_state(model, tx, torch.Generator().manual_seed(5))
        if scan:
            state, losses = ttr.make_scan_train_step(model, tx)(state, x, y)
        else:
            step = ttr.make_train_step(model, tx)
            losses = torch.stack([step(state, x[i], y[i])[1] for i in range(3)])
        runs.append((losses, _flat(model), state.step))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2] == 3


def test_remat_accumulation_is_bit_identical_and_refuses_a_generator():
    x, y = _batches((8,), seed=4)
    flats = []
    for remat in (False, True):
        model = get_model("alexnet", seed=2, device="cpu")
        tx = ttr.build_tx("sgd", LR)
        state = ttr.create_train_state(model, tx)
        state, loss = ttr.make_accum_train_step(model, tx, 4, remat=remat)(state, x, y)
        flats.append((float(loss), _flat(model)))
    assert flats[0][0] == flats[1][0] and torch.equal(flats[0][1], flats[1][1])
    model = get_model("lenet", device="cpu")
    tx = ttr.build_tx("sgd", LR)
    state = ttr.create_train_state(model, tx, torch.Generator())
    with pytest.raises(ValueError, match="remat"):
        ttr.make_accum_train_step(model, tx, 4, remat=True)(state, x, y)


def test_accum_step_refuses_a_ragged_batch():
    model = get_model("lenet", device="cpu")
    tx = ttr.build_tx("sgd", LR)
    step = ttr.make_accum_train_step(model, tx, 3)
    x, y = _batches((8,))
    with pytest.raises(ValueError, match="divide"):
        step(ttr.create_train_state(model, tx), x, y)
    with pytest.raises(ValueError, match="positive"):
        ttr.make_accum_train_step(model, tx, 4, effective_update_batch=0)(
            ttr.create_train_state(model, tx), x, y)


# ------------------------------------------------------------------ the loop

def _argv(tmp, tag, *extra):
    return ["--no-distributed", "--backend", "cpu", "--model", "lenet", "--epochs", "2",
            "--synthetic-data", "--synthetic-train-size", "96", "--synthetic-test-size", "16",
            "--batch-size", "8", "--log-interval", "4", "--log-dir", str(tmp / tag), *extra]


def _csv(path):
    with open(path, newline="") as fh:
        return [{k: r[k] for k in ("iteration", "training_loss", "test_loss", "test_accuracy")}
                for r in csv.DictReader(fh)]


def _run(argv):
    args = cli.build_parser().parse_args(argv)
    state, logger = ttr.train_single(args, device="cpu")
    return state, _csv(logger.to_csv("single.csv"))


@pytest.fixture
def chunk_spy(monkeypatch):
    """Records ``(state.step before, steps)`` of every K-step dispatch."""
    chunks = []
    real = ttr.make_scan_train_step

    def spying(model, tx, steps_per_dispatch=0):
        scan = real(model, tx, steps_per_dispatch)

        def wrapped(state, images, labels, generator=None):
            chunks.append((state.step, len(images)))
            return scan(state, images, labels, generator)
        return wrapped

    monkeypatch.setattr(ttr, "make_scan_train_step", spying)
    return chunks


def test_chunked_loop_equals_per_step_loop(tmp_path, chunk_spy):
    base = ["--optimizer", "adam", "--lr", "0.003", "--lr-schedule", "cosine"]
    per_step, rows = _run(_argv(tmp_path, "a", *base))
    chunked, rows_k = _run(_argv(tmp_path, "b", *base, "--steps-per-dispatch", "3",
                                 "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "5"))
    assert rows == rows_k and len(rows) == 24
    assert torch.equal(_flat(per_step.model), _flat(chunked.model))
    assert sum(n for _, n in chunk_spy) == 24
    ends = {s + n for s, n in chunk_spy}
    assert all(n <= 3 for _, n in chunk_spy)
    evals = {e * 12 + i + 1 for e in range(2) for i in range(4, 12, 4)}
    assert evals <= ends, (evals, ends)              # an eval sees exactly step i
    assert {5, 10, 15, 20} <= ends, ends             # checkpoints on exact multiples
    assert tck.Checkpointer(str(tmp_path / "ck")).all_steps() == [15, 20, 24]


def test_prefetch_changes_nothing(tmp_path):
    a, rows_a = _run(_argv(tmp_path, "a", "--prefetch", "0"))
    b, rows_b = _run(_argv(tmp_path, "b", "--prefetch", "3"))
    assert rows_a == rows_b and torch.equal(_flat(a.model), _flat(b.model))


class _Stop(Exception):
    pass


def test_resumed_run_equals_an_uninterrupted_one(tmp_path, monkeypatch):
    flags = ["--optimizer", "adamw", "--lr", "0.003", "--lr-schedule", "cosine",
             "--grad-clip", "1.0", "--grad-accum", "2", "--steps-per-dispatch", "3",
             "--ckpt-every", "5"]
    full, rows = _run(_argv(tmp_path, "full", *flags, "--ckpt-dir", str(tmp_path / "ca")))
    real_save = tck.Checkpointer.save

    def save_then_stop(self, step, state, *, force=False):
        accepted = real_save(self, step, state, force=force)
        if accepted and not force and step == 10:
            raise _Stop
        return accepted

    monkeypatch.setattr(tck.Checkpointer, "save", save_then_stop)
    argv = _argv(tmp_path, "cut", *flags, "--ckpt-dir", str(tmp_path / "cb"))
    with pytest.raises(_Stop):
        _run(argv)
    monkeypatch.setattr(tck.Checkpointer, "save", real_save)
    assert tck.Checkpointer(str(tmp_path / "cb")).latest_step() == 10
    resumed, rows_r = _run([*argv, "--resume"])
    assert rows_r == rows[10:]
    assert resumed.step == full.step == 24
    assert torch.equal(_flat(resumed.model), _flat(full.model))
    for a, b in zip(resumed.opt_state.tensors(), full.opt_state.tensors()):
        assert torch.equal(a, b)
    assert torch.equal(resumed.generator.get_state(), full.generator.get_state())
