"""Sync data parallelism (``parallel/sync.py``) and p2p (``parallel/p2p.py``)
of the port on worlds of threads, case for case as the JAX package's
``tests/test_sync_dp.py``.

Against the JAX step on a two-device mesh, from the same weights
(``utils/interop``) and the same seeded batches: a float32 AlexNet (no
dropout, as in the JAX test), two ranks of per-rank batch 8, three steps.
Tolerance: losses rtol 1e-5; parameters rtol 1e-5, atol 2e-6 (each side sums
the convolutions' products in its own order, about 1e-5 relative on a
gradient, and lr 0.05 moves a parameter by a twentieth of it). The port
against itself, bit for bit: K steps a dispatch equal K single steps, and a
one-rank world equals ``training.trainer.make_train_step``. The p2p cases
equal the JAX expectations exactly, and ``python -m ...parallel.p2p`` prints
the reference demo's lines. The ``--mode sync`` CLI runs as two processes
through ``launch.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.models import AlexNet as JAlexNet
from distributed_ml_pytorch_tpu.parallel import sync as jsync
from distributed_ml_pytorch_tpu.runtime.mesh import make_mesh as jmake_mesh
from distributed_ml_pytorch_tpu.training import trainer as jtr
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.parallel import p2p, sync
from distributed_ml_pytorch_tpu_torch.runtime.mesh import make_mesh, run_threaded
from distributed_ml_pytorch_tpu_torch.training import trainer as ttr
from distributed_ml_pytorch_tpu_torch.utils import interop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.05
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=2e-6)


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


def test_sync_step_matches_single_device(jax_init):
    """Two ranks of batch 8 == the JAX sync step on two devices == batch 16."""
    x, y = _batches(16)
    jmodel = JAlexNet()
    mesh2 = jmake_mesh({"data": 2}, devices=jax.devices()[:2])
    jstate, tx = jtr.create_train_state(jmodel, jax.random.key(0), lr=LR)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, jax_init))
    jstate = jsync.replicate(mesh2, jstate)
    jstep = jsync.make_sync_train_step(jmodel, tx, mesh2)
    rng = jsync.replicate(mesh2, jax.random.key(7))
    bx, by = jsync.shard_batch(mesh2, x, y)
    jlosses = []
    for _ in range(3):
        jstate, loss = jstep(jstate, bx, by, rng)
        jlosses.append(float(loss))

    def rank(world):
        mesh = make_mesh(world=world)
        model = _port_alexnet(jax_init)
        tx_ = ttr.SGD(LR)
        state = sync.replicate(mesh, ttr.create_train_state(model, tx_))
        step = sync.make_sync_train_step(model, tx_, mesh)
        sx, sy = sync.shard_batch(mesh, x, y)
        losses = [float(step(state, sx, sy)[1]) for _ in range(3)]
        return losses, {n: p.detach().clone() for n, p in model.state_dict().items()}

    out = run_threaded(2, rank)
    np.testing.assert_allclose(out[0][0], jlosses, **LOSS_TOL)
    ref = interop.params_from_jax(jax.tree.map(np.asarray, jstate.params), _port_alexnet(jax_init))
    for name, p in out[0][1].items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), err_msg=name, **PARAM_TOL)
        assert torch.equal(p, out[1][1][name]), name  # replicas stay identical


def test_sync_scan_matches_per_step_exactly(jax_init):
    """K = 3 steps in one dispatch == three per-step dispatches, bit for bit;
    and a one-rank world == ``make_train_step``, bit for bit."""
    x, y = _batches(48, seed=1)
    xs, ys = x.reshape(3, 16, 32, 32, 3), y.reshape(3, 16)

    def rank(world):
        mesh = make_mesh(world=world)
        a, b = _port_alexnet(jax_init), _port_alexnet(jax_init)
        tx_ = ttr.SGD(LR)
        sa, sb = ttr.create_train_state(a, tx_), ttr.create_train_state(b, tx_)
        step = sync.make_sync_train_step(a, tx_, mesh)
        per = [float(step(sa, *sync.shard_batch(mesh, xs[i], ys[i]))[1]) for i in range(3)]
        scan = sync.make_sync_scan_step(b, tx_, mesh)
        _, losses = scan(sb, *sync.shard_batch(mesh, xs, ys, dim=1))
        return per, losses.tolist(), list(a.parameters()), list(b.parameters())

    for per, chunk, pa, pb in run_threaded(2, rank):
        assert per == chunk
        assert all(torch.equal(u, v) for u, v in zip(pa, pb))
    one = run_threaded(1, lambda w: rank(w)[2])[0]
    model = _port_alexnet(jax_init)
    state = ttr.create_train_state(model, ttr.SGD(LR))
    step = ttr.make_train_step(model, ttr.SGD(LR))
    for i in range(3):
        step(state, xs[i], ys[i])
    assert all(torch.equal(u, v) for u, v in zip(one, model.parameters()))


def test_sync_step_loss_decreases():
    x, y = _batches(64, seed=2)

    def rank(world):
        mesh = make_mesh(world=world)
        model = get_model("lenet", device="cpu")
        tx_ = ttr.SGD(LR)
        state = sync.replicate(mesh, ttr.create_train_state(model, tx_))
        step = sync.make_sync_train_step(model, tx_, mesh)
        sx, sy = sync.shard_batch(mesh, x, y)
        return [float(step(state, sx, sy)[1]) for _ in range(20)]

    losses = run_threaded(2, rank)[0]
    assert losses[-1] < losses[0]


def _p2p(fn):
    return torch.cat(run_threaded(8, lambda w: fn(make_mesh(world=w),
                                                  torch.tensor([float(w.rank)])))).numpy()


def test_p2p_send_recv():
    out = _p2p(lambda mesh, x: p2p.p2p_send_recv(x, mesh, [(3, 1)]))
    # dst gets src's shard; everyone else zeros (ppermute semantics)
    expected = np.zeros(8)
    expected[1] = 3.0
    np.testing.assert_array_equal(out, expected)


def test_p2p_send_recv_keep_fill():
    out = _p2p(lambda mesh, x: p2p.p2p_send_recv(x, mesh, [(3, 1)], fill="keep"))
    expected = np.arange(8.0)
    expected[1] = 3.0
    np.testing.assert_array_equal(out, expected)


def test_p2p_ring_shift():
    out = _p2p(lambda mesh, x: p2p.p2p_shift(x, mesh, shift=1))
    np.testing.assert_array_equal(out, np.roll(np.arange(8.0), 1))


def test_p2p_demo_parity(capsys):
    """rank 0 sends 1.0 to rank 1; both print their values; the module's
    entry prints the same lines."""
    vals = p2p.run_demo(2, device="cpu")
    assert vals[1] == 1.0 and vals[0] == 1.0
    out = capsys.readouterr().out
    assert "Rank  0  has data  1.0" in out and "Rank  1  has data  1.0" in out
    assert p2p.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out == out


def test_sync_cli_two_processes(tmp_path):
    """``--mode sync`` through ``launch.py``: two gloo processes on the CPU,
    each writing its CSV; the ranks' losses are the same global means."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_ml_pytorch_tpu_torch.launch", "--world-size", "2",
         "--", "--mode", "sync", "--dist-backend", "gloo", "--backend", "cpu", "--model",
         "lenet", "--epochs", "1", "--synthetic-data", "--synthetic-train-size", "128",
         "--synthetic-test-size", "16", "--batch-size", "8", "--log-interval", "4",
         "--log-dir", str(tmp_path)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rows = [np.genfromtxt(tmp_path / f"node{r}.csv", delimiter=",", names=True)
            for r in (0, 1)]
    assert len(rows[0]) == 128 // 16
    np.testing.assert_array_equal(rows[0]["training_loss"], rows[1]["training_loss"])
