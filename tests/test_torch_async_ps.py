"""The port's DownPour parameter server against the JAX package's.

- the worker cadence of ``tests/test_async_ps.py::test_worker_cadence_and_
  accumulator``, mirrored: six ``Asynchronous`` steps of AlexNet in each
  package on the same batches from the same (carried) weights give the same
  message pattern per step, the same pushed payloads (rtol 1e-4, atol 1e-6:
  the two packages' convolutions sum in different orders) and the same
  final parameters;
- a port worker training against the JAX ``ParameterServer`` over a port
  ``InProcessTransport`` built on the JAX world's mailboxes: the central
  vector moves by exactly the sum of the pushes;
- a port world of one server and two workers converges and shuts down.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from distributed_ml_pytorch_tpu.models import AlexNet as JAlexNet
from distributed_ml_pytorch_tpu.parallel import async_ps as jps
from distributed_ml_pytorch_tpu.training.trainer import cross_entropy_loss as jce
from distributed_ml_pytorch_tpu.utils import messaging as jmsg
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads
from distributed_ml_pytorch_tpu_torch.utils import interop
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

PAYLOAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batches(n_steps, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1, 1, size=(batch, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, size=batch).astype(np.int32)) for _ in range(n_steps)]


def _drain(box):
    out = []
    while True:
        m = box.recv(timeout=0.05)
        if m is None:
            return out
        out.append((int(m[1]), np.asarray(m[2])))


def test_worker_cadence_payloads_and_params_match_jax():
    jmodel = JAlexNet()
    jparams = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    model = get_model("alexnet", device="cpu")
    model.load_state_dict(interop.params_from_jax(jax.tree.map(np.asarray, jparams), model))
    batches = _batches(6)

    @jax.jit
    def jgrad(p, bx, by):
        return jax.grad(lambda q: jce(jmodel.apply({"params": q}, bx), by))(p)

    jworld = jmsg.InProcessTransport.create_world(2)
    jopt = jps.Asynchronous(jparams, lr=0.05, n_push=3, n_pull=2, transport=jworld[1])
    tworld = tmsg.InProcessTransport.create_world(2)
    topt = tps.Asynchronous(model, lr=0.05, n_push=3, n_pull=2, transport=tworld[1])
    try:
        (jinit,) = _drain(jworld[0])
        (tinit,) = _drain(tworld[0])
        assert jinit[0] == tinit[0] == int(tmsg.MessageCode.ParameterUpdate)
        np.testing.assert_array_equal(tinit[1], jinit[1])
        params = jparams
        for bx, by in batches:
            params = jopt.step(params, jgrad(params, bx, by))
            jopt._flusher.drain()
            loss_and_grads(model, torch.from_numpy(bx), torch.from_numpy(by))
            topt.step()
            topt._flusher.drain()
            jmsgs, tmsgs = _drain(jworld[0]), _drain(tworld[0])
            assert [c for c, _ in tmsgs] == [c for c, _ in jmsgs]
            for (c, tp), (_, jp) in zip(tmsgs, jmsgs):
                assert tp.shape == jp.shape
                if c == int(tmsg.MessageCode.GradientUpdate):
                    np.testing.assert_allclose(tp, jp, **PAYLOAD_TOL)
        assert topt.idx == 6
        np.testing.assert_allclose(ravel_model_params(model).numpy(),
                                   np.asarray(ravel_pytree(params)[0]), **PAYLOAD_TOL)
    finally:
        jopt.listener.stop()
        topt.listener.stop()


def test_port_worker_against_jax_server_sums_pushes_exactly():
    jworld = jmsg.InProcessTransport.create_world(2)
    model = get_model("lenet", seed=2, device="cpu")
    flat0 = ravel_model_params(model).numpy()
    server = jps.ParameterServer(params=np.zeros_like(flat0), transport=jworld[0],
                                 n_workers=1)
    thread = threading.Thread(target=server.run, kwargs={"timeout": 60})
    thread.start()

    pushes = []

    class Recording(tmsg.InProcessTransport):
        def send(self, code, payload, dst=0):
            if int(code) == int(tmsg.MessageCode.GradientUpdate):
                pushes.append(np.array(payload, np.float32))
            super().send(code, payload, dst)

    transport = Recording(1, jworld[1]._boxes)
    opt = tps.Asynchronous(model, lr=0.05, n_push=2, n_pull=2, transport=transport)
    for bx, by in _batches(5, batch=8, seed=1):
        loss_and_grads(model, torch.from_numpy(bx), torch.from_numpy(by))
        opt.step()
    opt.finish()
    thread.join(timeout=60)
    assert not thread.is_alive()
    expected = flat0.copy()
    for p in pushes:
        expected += p
    assert len(pushes) == 4  # steps 0, 2, 4 and the final flush
    np.testing.assert_array_equal(server.central, expected)
    assert server.message_counts[jmsg.MessageCode.GradientUpdate] == 4
    assert server.message_counts[jmsg.MessageCode.ParameterRequest] == 3


def test_port_world_converges_and_shuts_down():
    from distributed_ml_pytorch_tpu_torch.data import load_cifar10

    world = tmsg.InProcessTransport.create_world(3)
    model0 = get_model("lenet", device="cpu")
    server = tps.ParameterServer(model0, transport=world[0], n_workers=2)
    server_thread = threading.Thread(target=server.run, kwargs={"timeout": 120})
    server_thread.start()
    x, y, *_ = load_cifar10(n_train=256, n_test=32, synthetic=True)
    results = {}

    def worker(rank):
        model = get_model("lenet", device="cpu")
        opt = tps.Asynchronous(model, lr=0.05, n_push=4, n_pull=4, transport=world[rank])
        gen = torch.Generator().manual_seed(rank)
        losses = []
        for step in range(24):
            sel = np.random.default_rng(rank * 100 + step).integers(0, len(x), 32)
            loss = loss_and_grads(model, torch.from_numpy(x[sel]),
                                  torch.from_numpy(y[sel]), generator=gen)
            opt.step()
            losses.append(float(loss))
        opt.finish()
        results[rank] = losses

    threads = [threading.Thread(target=worker, args=(r,)) for r in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    server_thread.join(timeout=30)
    assert not server_thread.is_alive(), "server did not shut down after WorkerDone x2"
    for rank in (1, 2):
        losses = results[rank]
        assert np.mean(losses[-6:]) < np.mean(losses[:6]), (rank, losses)
    assert server.message_counts[tmsg.MessageCode.GradientUpdate] >= 2
    assert server.message_counts[tmsg.MessageCode.ParameterRequest] >= 2
    assert np.isfinite(server.central).all()


def test_server_drops_wrong_size_update_and_replies_to_requests():
    world = tmsg.InProcessTransport.create_world(2)
    server = tps.ParameterServer(params=np.ones(8, np.float32), transport=world[0])
    server.handle(1, tmsg.MessageCode.GradientUpdate, np.ones(3, np.float32))
    assert server.dropped_bad_updates == 1 and server.staleness.version == 0
    server.handle(1, tmsg.MessageCode.GradientUpdate, np.full(8, 2.0, np.float32))
    server.handle(1, tmsg.MessageCode.ParameterRequest, np.zeros(0, np.float32))
    sender, code, payload = world[1].recv(timeout=2)
    assert (sender, code) == (0, tmsg.MessageCode.ParameterUpdate)
    np.testing.assert_array_equal(payload, np.full(8, 3.0, np.float32))
    assert tps.DownpourSGD is tps.Asynchronous
    with pytest.raises(ValueError):
        tps.validate_downpour_args(0.1, 0, 1)
