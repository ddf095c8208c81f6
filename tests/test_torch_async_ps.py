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
- a port world of one server and two workers converges and shuts down;
- a JAX worker training against the port's server: the central vector
  moves by exactly the sum of the pushes;
- the port's two-worker world, pumped in a fixed order, keeps within
  ``WORLD_LOSS_RTOL`` of the JAX world's losses;
- a rejoining worker, or one facing a restored server, adopts the central
  vector; staleness damping equals the JAX server's bit for bit.
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


def test_jax_worker_against_port_server_sums_pushes_exactly():
    """The mirror of the port-worker test above: a JAX ``Asynchronous``
    worker trains against the port's ``ParameterServer`` over the shared
    mailboxes; the central vector ends as the worker's initial vector plus
    the sum of its pushes, exactly."""
    from distributed_ml_pytorch_tpu.models import get_model as jget_model

    jmodel = jget_model("lenet")
    params = jmodel.init(jax.random.key(4), jnp.zeros((1, 32, 32, 3)))["params"]
    flat0 = np.asarray(ravel_pytree(params)[0], np.float32)
    jworld = jmsg.InProcessTransport.create_world(2)
    server = tps.ParameterServer(params=np.zeros_like(flat0),
                                 transport=tmsg.InProcessTransport(0, jworld[0]._boxes),
                                 n_workers=1)
    thread = threading.Thread(target=server.run, kwargs={"timeout": 60})
    thread.start()
    pushes = []

    class Recording(jmsg.InProcessTransport):
        def send(self, code, payload, dst=0):
            if int(code) == int(tmsg.MessageCode.GradientUpdate):
                pushes.append(np.array(payload, np.float32))
            super().send(code, payload, dst)

    @jax.jit
    def jgrad(p, bx, by):
        return jax.grad(lambda q: jce(jmodel.apply({"params": q}, bx), by))(p)

    opt = jps.Asynchronous(params, lr=0.05, n_push=2, n_pull=3,
                           transport=Recording(1, jworld[1]._boxes))
    for bx, by in _batches(5, batch=8, seed=2):
        params = opt.step(params, jgrad(params, bx, by))
    opt.finish()
    thread.join(timeout=60)
    assert not thread.is_alive()
    expected = flat0.copy()
    for p in pushes:
        expected += p
    assert len(pushes) == 4  # steps 0, 2, 4 and the final flush
    np.testing.assert_array_equal(server.central, expected)
    assert server.message_counts[tmsg.MessageCode.GradientUpdate] == 4
    assert server.message_counts[tmsg.MessageCode.ParameterRequest] == 2


#: per-step losses of the port's two-worker world against the JAX world's.
#: One step's pushed payloads agree within PAYLOAD_TOL (rtol 1e-4: the two
#: packages' convolutions sum in other orders); the worlds feed each
#: worker's pushes into the other's parameters through the server, so the
#: differences compound over the steps. The largest relative difference
#: measured over these 16 losses is about 1.1e-7 (CPU); 1e-3 leaves room for
#: the compounding over other thread counts and BLAS builds and is still
#: above no real divergence: the losses move by 4e-3 to 3e-2 a step.
WORLD_LOSS_RTOL = 1e-3


def test_two_worker_port_world_stays_in_the_jax_worlds_loss_corridor():
    """Two AlexNet workers and a server per package, from the same weights
    on the same batches (n_push 2, n_pull 3), with no thread of their own:
    the listeners are stopped and one loop pumps every mailbox in a fixed
    order (worker 1 steps and its push is flushed, the server handles its
    inbox, worker 1 takes its replies; then worker 2), so both worlds see
    the same interleaving."""
    steps = 8
    jmodel = JAlexNet()
    jparams = jmodel.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))["params"]
    state = interop.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    get_model("alexnet", device="cpu"))
    batches = {r: _batches(steps, batch=8, seed=10 + r) for r in (1, 2)}

    @jax.jit
    def jloss_grad(p, bx, by):
        return jax.value_and_grad(lambda q: jce(jmodel.apply({"params": q}, bx), by))(p)

    def world_run(pkg):
        msg = jmsg if pkg == "jax" else tmsg
        world = msg.InProcessTransport.create_world(3)
        cls = jps.ParameterServer if pkg == "jax" else tps.ParameterServer
        server = cls(params=np.zeros(ravel_pytree(jparams)[0].size, np.float32),
                     transport=world[0], n_workers=2)
        workers = {}
        for r in (1, 2):
            if pkg == "jax":
                opt = jps.Asynchronous(jparams, lr=0.05, n_push=2, n_pull=3,
                                       transport=world[r])
                workers[r] = [opt, jparams]
            else:
                model = get_model("alexnet", fused_epilogue=True, device="cpu")
                model.load_state_dict(state)
                opt = tps.Asynchronous(model, lr=0.05, n_push=2, n_pull=3,
                                       transport=world[r])
                workers[r] = [opt, model]
            opt.listener.stop()
            opt.listener.join(timeout=5)

        def pump(rank, handle):
            while (m := world[rank].recv(timeout=0.01)) is not None:
                handle(m[0], msg.MessageCode(int(m[1])), m[2])

        losses = {1: [], 2: []}
        for i in range(steps):
            for r in (1, 2):
                opt, held = workers[r]
                bx, by = batches[r][i]
                if pkg == "jax":
                    loss, grads = jloss_grad(held, bx, by.astype(np.int32))
                    workers[r][1] = opt.step(held, grads)
                else:
                    loss = loss_and_grads(held, torch.from_numpy(bx),
                                          torch.from_numpy(by.astype(np.int64)))
                    opt.step()
                losses[r].append(float(loss))
                opt._flusher.drain()
                pump(0, server.handle)
                pump(r, opt.listener.receive)
        for r in (1, 2):
            workers[r][0]._flusher.stop()
        return losses, server

    (jlosses, jserver), (tlosses, tserver) = world_run("jax"), world_run("port")
    for r in (1, 2):
        np.testing.assert_allclose(tlosses[r], jlosses[r], rtol=WORLD_LOSS_RTOL)
    assert tserver.staleness.version == jserver.staleness.version == 2 * steps // 2
    np.testing.assert_allclose(tserver.central, jserver.central, **PAYLOAD_TOL)


@pytest.mark.parametrize("how", ["rejoin", "restored_server"])
def test_worker_adopts_the_central_params_instead_of_stomping(tmp_path, how):
    """A rejoining worker (``rejoin=True``: a pull, awaited) and a fresh
    worker facing a restored server (its install answered with the restored
    vector) both end their first step on the server's central vector, which
    the worker never overwrites."""
    model = get_model("lenet", seed=5, device="cpu")
    n = ravel_model_params(model).numel()
    central = (np.arange(n, dtype=np.float32) % 97) * 1e-3
    world = tmsg.InProcessTransport.create_world(2)
    server = tps.ParameterServer(params=central, transport=world[0], n_workers=1,
                                 ckpt_dir=str(tmp_path))
    if how == "restored_server":
        server.save_checkpoint()
        server = tps.ParameterServer(params=np.zeros(n, np.float32), transport=world[0],
                                     n_workers=1, ckpt_dir=str(tmp_path))
        assert server.maybe_restore()
    thread = threading.Thread(target=server.run, kwargs={"timeout": 60})
    thread.start()
    opt = tps.Asynchronous(model, lr=0.1, n_push=10, n_pull=10, transport=world[1],
                           rejoin=how == "rejoin", install_timeout=10.0)
    if how == "restored_server":
        assert opt.listener.wait_for_update(10.0)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    np.testing.assert_array_equal(ravel_model_params(model).numpy(), central)
    opt.finish()
    thread.join(timeout=60)
    assert not thread.is_alive()
    np.testing.assert_array_equal(server.central, central)
    assert server.rejected_installs == (how == "restored_server")
    assert server.message_counts[tmsg.MessageCode.ParameterUpdate] == (how != "rejoin")


def test_staleness_damping_equals_jax_bit_for_bit():
    """Three senders pull and push in an interleaving that makes pushes
    stale by 0 to 4 versions; with damping 0.7 the port's central vector,
    version and per-worker staleness equal the JAX server's exactly."""
    rng = np.random.default_rng(9)
    tworld = tmsg.InProcessTransport.create_world(4)
    jworld = jmsg.InProcessTransport.create_world(4)
    mine = tps.ParameterServer(params=np.ones(33, np.float32), transport=tworld[0],
                               staleness_damping=0.7)
    ref = jps.ParameterServer(params=np.ones(33, np.float32), transport=jworld[0],
                              staleness_damping=0.7)
    for i in range(30):
        sender = 1 + int(rng.integers(0, 3))
        code = (tmsg.MessageCode.ParameterRequest if rng.random() < 0.3
                else tmsg.MessageCode.GradientUpdate)
        payload = (np.zeros(0, np.float32) if code == tmsg.MessageCode.ParameterRequest
                   else rng.normal(size=33).astype(np.float32))
        mine.handle(sender, code, payload)
        ref.handle(sender, jmsg.MessageCode(int(code)), payload)
    np.testing.assert_array_equal(mine.central, ref.central)
    assert mine.staleness.version == ref.staleness.version
    assert mine.staleness.per_worker == ref.staleness.per_worker
    assert max(max(v) for v in mine.staleness.per_worker.values()) >= 3
