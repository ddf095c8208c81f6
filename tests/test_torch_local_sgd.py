"""Local SGD (``parallel/local_sgd.py``) of the port on worlds of threads,
case for case as the JAX package's ``tests/test_local_sgd.py``.

Against the JAX round on a two-device mesh, from the same weights and
batches: a float32 AlexNet, k = 2 local steps of per-rank batch 8, then the
average. Tolerance: losses rtol 1e-5, parameters rtol 1e-5, atol 2e-6 (as
``tests/test_torch_sync_dp.py``). With k = 1 and plain SGD a round equals a
sync-DP step (rtol 2e-4, atol 1e-6, the JAX test's: the average of two
updated copies against the update by the mean gradient); with k = 2 it does
not. The ``--mode local-sgd`` CLI runs as two processes through
``launch.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_ml_pytorch_tpu.models import AlexNet as JAlexNet
from distributed_ml_pytorch_tpu.parallel import local_sgd as jlocal
from distributed_ml_pytorch_tpu.parallel import sync as jsync
from distributed_ml_pytorch_tpu.runtime.mesh import make_mesh as jmake_mesh
from distributed_ml_pytorch_tpu.training import trainer as jtr
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.parallel import local_sgd, sync
from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
from distributed_ml_pytorch_tpu_torch.training import cli
from distributed_ml_pytorch_tpu_torch.training import trainer as ttr
from distributed_ml_pytorch_tpu_torch.utils import interop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.05
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=2e-6)
K1_TOL = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_init():
    jparams = JAlexNet().init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.tree.map(np.asarray, jparams)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=(n,)).astype(np.int32))


def _port_alexnet(params):
    model = get_model("alexnet", device="cpu")
    model.load_state_dict(interop.params_from_jax(params, model))
    return model


def _round(params, xs, ys, k_sync=False):
    """Two ranks: one local-SGD round over ``xs [k, 16, ...]`` (or, with
    ``k_sync``, k sync-DP steps); returns rank 0's losses and parameters
    and whether the ranks' parameters are identical."""

    def rank(world):
        mesh = make_mesh(world=world)
        model = _port_alexnet(params)
        tx = ttr.SGD(LR)
        state = ttr.create_train_state(model, tx)
        if k_sync:
            step = sync.make_sync_train_step(model, tx, mesh)
            losses = [float(step(state, *sync.shard_batch(mesh, xs[i], ys[i]))[1])
                      for i in range(xs.shape[0])]
        else:
            round_fn = local_sgd.make_local_sgd_round(model, tx, mesh)
            losses = round_fn(state, *sync.shard_batch(mesh, xs, ys, dim=1))[1].tolist()
        return losses, {n: p.detach().clone() for n, p in model.state_dict().items()}, state

    out = run_threaded(2, rank)
    same = all(torch.equal(out[0][1][n], out[1][1][n]) for n in out[0][1])
    return out[0][0], out[0][1], same, out[0][2]


def test_k1_local_sgd_equals_sync_dp(jax_init):
    x, y = _batches(16)
    _, sync_params, _, _ = _round(jax_init, x[None], y[None], k_sync=True)
    _, local_params, same, _ = _round(jax_init, x[None], y[None])
    assert same
    for name, p in sync_params.items():
        np.testing.assert_allclose(local_params[name].numpy(), p.numpy(), err_msg=name,
                                   **K1_TOL)


def test_local_sgd_round_matches_jax(jax_init):
    """One k = 2 round against the JAX round on two devices."""
    x, y = _batches(32, seed=3)
    xs, ys = x.reshape(2, 16, 32, 32, 3), y.reshape(2, 16)
    jmodel = JAlexNet()
    mesh2 = jmake_mesh({"data": 2}, devices=jax.devices()[:2])
    jstate, tx = jtr.create_train_state(jmodel, jax.random.key(0), lr=LR)
    jstate = jsync.replicate(mesh2, jstate.replace(params=jax.tree.map(jnp.asarray, jax_init)))
    round_fn = jlocal.make_local_sgd_round(jmodel, tx, mesh2)
    rx = jax.device_put(xs, NamedSharding(mesh2, P(None, "data", None, None, None)))
    ry = jax.device_put(ys, NamedSharding(mesh2, P(None, "data")))
    jstate, jlosses = round_fn(jstate, rx, ry, jsync.replicate(mesh2, jax.random.key(1)))
    losses, params, same, state = _round(jax_init, xs, ys)
    assert same and state.step == 2
    np.testing.assert_allclose(losses, np.asarray(jlosses), **LOSS_TOL)
    ref = interop.params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                  _port_alexnet(jax_init))
    for name, p in params.items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), err_msg=name, **PARAM_TOL)


def test_local_sgd_round_shapes_and_progress():
    x, y = _batches(256, seed=4)
    k, gb = 4, 16

    def rank(world):
        mesh = make_mesh(world=world)
        model = get_model("lenet", device="cpu")
        tx = ttr.SGD(LR)
        state = sync.replicate(mesh, ttr.create_train_state(model, tx))
        round_fn = local_sgd.make_local_sgd_round(model, tx, mesh)
        means = []
        for r in range(6):
            sel = slice((r % 2) * k * gb, (r % 2 + 1) * k * gb)
            xs, ys = x[sel].reshape(k, gb, 32, 32, 3), y[sel].reshape(k, gb)
            state, losses = round_fn(state, *sync.shard_batch(mesh, xs, ys, dim=1))
            assert losses.shape == (k,)
            means.append(float(losses.mean()))
        return means, [p.detach().clone() for p in model.parameters()]

    out = run_threaded(2, rank)
    means = out[0][0]
    assert means[-1] < means[0], means
    # the parameters stay replicated (identical) across ranks after averaging
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_k2_local_sgd_differs_from_sync(jax_init):
    """With k > 1 the ranks' trajectories diverge between averages, so the
    round must not equal two sync-DP steps."""
    x, y = _batches(32, seed=5)
    xs, ys = x.reshape(2, 16, 32, 32, 3), y.reshape(2, 16)
    _, sync_params, _, _ = _round(jax_init, xs, ys, k_sync=True)
    _, local_params, _, _ = _round(jax_init, xs, ys)
    diff = max(float((local_params[n] - p).abs().max()) for n, p in sync_params.items())
    assert diff > 1e-6, "local-SGD trajectory identical to sync DP: grads are not local"


def test_local_sgd_honors_optimizer_knobs(tmp_path):
    """adam + cosine + clipping through the local-SGD loop: the loss falls,
    adam's moments exist and its count keeps its integer dtype across the
    rounds' averaging (MAX, not a float mean)."""
    args = cli.build_parser().parse_args([
        "--mode", "local-sgd", "--epochs", "2", "--synthetic-data",
        "--synthetic-train-size", "256", "--synthetic-test-size", "32",
        "--batch-size", "4", "--model", "lenet", "--lr", "0.003",
        "--optimizer", "adam", "--lr-schedule", "cosine", "--grad-clip", "1.0",
        "--log-interval", "1000", "--log-dir", str(tmp_path), "--sync-every", "2",
        "--backend", "cpu", "--steps-per-dispatch", "4"])

    def rank(world):
        state, logger = local_sgd.train_local_sgd(args, make_mesh(world=world))
        return [r["training_loss"] for r in logger.records], state.opt_state

    losses, opt = run_threaded(2, rank)[0]
    q = max(1, len(losses) // 4)
    assert float(np.mean(losses[-q:])) < float(np.mean(losses[:q]))
    assert len(losses) == 2 * 256 // 8
    assert set(opt.slots) == {"mu", "nu"}
    assert opt.count.dtype == torch.int32 and int(opt.count) == len(losses)


def test_local_sgd_step_counter_advances(jax_init):
    x, y = _batches(32, seed=6)
    _, _, _, state = _round(jax_init, x.reshape(2, 16, 32, 32, 3), y.reshape(2, 16))
    assert state.step == 2 and int(state.opt_state.count) == 2


def test_local_sgd_cli_two_processes(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.launch", "--world-size", "2",
         "--", "--mode", "local-sgd", "--sync-every", "2", "--dist-backend", "gloo",
         "--backend", "cpu", "--model", "lenet", "--epochs", "1", "--synthetic-data",
         "--synthetic-train-size", "128", "--synthetic-test-size", "16", "--batch-size", "8",
         "--log-interval", "4", "--log-dir", str(tmp_path)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "sync every 2 steps" in proc.stdout
    rows = [np.genfromtxt(tmp_path / f"node{r}.csv", delimiter=",", names=True)
            for r in (0, 1)]
    assert len(rows[0]) == 128 // 16
    np.testing.assert_array_equal(rows[0]["training_loss"], rows[1]["training_loss"])


def test_local_sgd_resume_equals_an_uninterrupted_run(tmp_path):
    """Checkpoints land on round boundaries (rank 0 writes, every rank
    restores): a run stopped after one epoch and resumed equals a run of two
    epochs, bit for bit."""

    def args(extra, tag):
        return cli.build_parser().parse_args([
            "--mode", "local-sgd", "--epochs", "2", "--synthetic-data",
            "--synthetic-train-size", "64", "--synthetic-test-size", "16", "--batch-size", "4",
            "--model", "lenet", "--backend", "cpu", "--log-interval", "1000",
            "--sync-every", "2", "--log-dir", str(tmp_path / tag), *extra])

    def run(a):
        return run_threaded(2, lambda w: local_sgd.train_local_sgd(a, make_mesh(world=w))[0])

    full = run(args([], "full"))
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "8"]
    run(args([*ck, "--epochs", "1"], "first"))
    assert sorted(os.listdir(tmp_path / "ck")) == ["8"]
    resumed = run(args([*ck, "--resume"], "second"))
    for a, b in zip(full, resumed):
        assert a.step == b.step == 16
        assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                     b.model.parameters()))
