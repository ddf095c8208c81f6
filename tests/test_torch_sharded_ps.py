"""The port's static sharded parameter server against the JAX package's.

- every test of the JAX ``tests/test_sharded_ps.py``, on the port: the
  ranges (equal to JAX's on a grid), per-shard updates, a partial install,
  two shard server processes over TCP, a dead shard degrading its slice
  only (its slice following pure local SGD exactly), the CLI world through
  ``launch_world(n_servers=2)``, rejoin adopting every shard's slice without
  an install, and a heartbeat's ``peer_down`` degrading its shard;
- the sharded client with one shard, and with two, equals the unsharded
  ``Asynchronous`` bit for bit: the same pushes (the shards' slices joined)
  and the same final parameters, every mailbox pumped in a fixed order;
- a JAX ``ShardedAsynchronous`` worker against the port's two shard servers,
  and a port worker against the JAX package's: each shard's central slice
  is the install's slice plus the sum of the pushes' slices, bit for bit;
- a two-worker world at k = 2 per package, from the same weights on the same
  batches, pumped single-threaded: the losses agree within
  ``WORLD_LOSS_RTOL`` (the unsharded world test's bound, 1e-3).
"""

import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from jax.flatten_util import ravel_pytree

from distributed_ml_pytorch_tpu.models import get_model as jget_model
from distributed_ml_pytorch_tpu.parallel import sharded_ps as jsp
from distributed_ml_pytorch_tpu.training.trainer import cross_entropy_loss as jce
from distributed_ml_pytorch_tpu.utils import messaging as jmsg
from distributed_ml_pytorch_tpu_torch.launch import _free_port, launch_world
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import (
    ShardedAsynchronous,
    make_shard_server,
    shard_ranges,
)
from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads
from distributed_ml_pytorch_tpu_torch.utils import interop
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    InProcessTransport,
    MessageCode,
    make_transport,
)
from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GU = MessageCode.GradientUpdate

#: the two packages' convolutions sum in other orders, so one step's
#: losses differ by ~1e-7 relative and the worlds compound it through the
#: servers; 1e-3 is the unsharded world test's bound
#: (``tests/test_torch_async_ps.py``), far below a real divergence
WORLD_LOSS_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class Tiny(nn.Module):
    """8 floats: the flat layout is the bias [0, 4), then the kernel [4, 8)
    (the JAX order), so two shards split them."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(1, 4)
        with torch.no_grad():
            self.fc.bias.copy_(torch.arange(4, dtype=torch.float32))
            self.fc.weight.copy_(torch.arange(4, dtype=torch.float32)[:, None] + 10.0)


def _ones_grads(model):
    for p in model.parameters():
        p.grad = torch.ones_like(p)


def _flat(model):
    return ravel_model_params(model).numpy().copy()


def _batches(n_steps, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1, 1, size=(batch, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, size=batch).astype(np.int32)) for _ in range(n_steps)]


class Dying:
    """A transport that raises on send once ``dead``."""

    def __init__(self, inner):
        self.inner, self.dead = inner, False

    def send(self, code, payload, dst=0):
        if self.dead:
            raise ConnectionError("shard down")
        self.inner.send(code, payload, dst)

    def recv(self, timeout=None):
        return self.inner.recv(timeout)

    def close(self):
        self.inner.close()

    @property
    def rank(self):
        return self.inner.rank


def _pump(box, handle):
    while (m := box.recv(timeout=0.01)) is not None:
        handle(m[0], MessageCode(int(m[1])), m[2])


# ----------------------------------------------------- the JAX tests, ported

def test_shard_ranges_equal_jax_on_a_grid():
    for n in (1, 2, 7, 8, 10, 62_006, 2_472_266):
        for k in (1, 2, 3, 4, 5, 7, 16):
            if k > n:
                with pytest.raises(ValueError):
                    shard_ranges(n, k)
                continue
            ranges = shard_ranges(n, k)
            assert ranges == jsp.shard_ranges(n, k)
            assert ranges[0][0] == 0 and ranges[-1][1] == n
            for (a, b), (c, d) in zip(ranges, ranges[1:]):
                assert b == c and b > a and d > c
    for bad in (0, 5):
        with pytest.raises(ValueError):
            shard_ranges(4, bad)


def test_sharded_downpour_updates_each_shard_server():
    """2 shards, 1 worker, n_push=1: after 2 steps of all-ones grads each
    server's central slice is install − 2·lr."""
    model = Tiny()
    init = _flat(model)
    worlds = [InProcessTransport.create_world(2) for _ in range(2)]
    servers = [make_shard_server(model, shard=s, n_shards=2, transport=worlds[s][0],
                                 n_workers=1) for s in range(2)]
    threads = [threading.Thread(target=s.run, kwargs={"timeout": 60}) for s in servers]
    for t in threads:
        t.start()
    opt = ShardedAsynchronous(model, lr=0.1, n_push=1, n_pull=100,
                              transports=[w[1] for w in worlds])
    try:
        for _ in range(2):
            _ones_grads(model)
            opt.step()
    finally:
        opt.finish()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = np.concatenate([servers[0].central, servers[1].central])
    np.testing.assert_allclose(got, init - 0.2, rtol=1e-6)
    assert [s.central.shape[0] for s in servers] == [4, 4]


def test_partial_shard_install_patches_only_arrived_range():
    """A reply from one shard installs alone — per-shard staleness; a reply
    of the wrong size raises."""
    model = Tiny()
    init = _flat(model)
    worlds = [InProcessTransport.create_world(2) for _ in range(2)]
    opt = ShardedAsynchronous(model, lr=0.0, n_push=100, n_pull=100,
                              transports=[w[1] for w in worlds])
    try:
        fresh = np.full(4, 99.0, np.float32)
        opt.listeners[1]._latest = fresh  # shard [4, 8) replied
        opt._install_arrived()
        flat = _flat(model)
        np.testing.assert_array_equal(flat[:4], init[:4])
        np.testing.assert_array_equal(flat[4:], fresh)
        opt.listeners[0]._latest = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match="ranges disagree"):
            opt._install_arrived()
    finally:
        opt.finish()


_SERVER_SRC = """
import sys
import numpy as np
from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import make_shard_server
from distributed_ml_pytorch_tpu_torch.utils.messaging import make_transport

shard, port = int(sys.argv[1]), sys.argv[2]
t = make_transport(0, 2, port=int(port), kind="python")
srv = make_shard_server(params=np.zeros(8, np.float32), shard=shard, n_shards=2,
                        transport=t, n_workers=1)
srv.run(timeout=120)
print("shard", shard, "central", ",".join(f"{x:.4f}" for x in srv.central), flush=True)
t.close()
"""


def test_sharded_ps_two_server_processes_over_tcp():
    """Two shard servers, each its own process on its own TCP star, one
    worker: each server ends at install − Σ lr·grads for its slice."""
    ports = [_free_port(), _free_port()]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _SERVER_SRC, str(s), ports[s]],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for s in range(2)]
    model = Tiny()
    init = _flat(model)
    transports = [make_transport(1, 2, port=int(p), kind="python", connect_timeout=120)
                  for p in ports]
    try:
        opt = ShardedAsynchronous(model, lr=0.5, n_push=1, n_pull=100,
                                  transports=transports)
        for _ in range(3):
            _ones_grads(model)
            opt.step()
        opt.finish()
    finally:
        outs = []
        for proc in procs:
            try:
                out, _ = proc.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                out = proc.communicate()[0]
            outs.append(out)
        for t in transports:
            t.close()
    assert all(p.returncode == 0 for p in procs), "\n\n".join(outs)
    want = init - 3 * 0.5
    for s, out in enumerate(outs):
        line = [ln for ln in out.splitlines() if ln.startswith(f"shard {s} central")]
        assert line, out
        got = np.array([float(x) for x in line[0].split("central ")[1].split(",")])
        lo, hi = shard_ranges(8, 2)[s]
        np.testing.assert_allclose(got, want[lo:hi], rtol=1e-5)


def test_dead_shard_degrades_that_slice_only():
    """A dead shard server does not crash the worker: sends to it stop, the
    other shard keeps its push/pull service."""
    model = Tiny()
    worlds = [InProcessTransport.create_world(2) for _ in range(2)]
    dying = Dying(worlds[0][1])
    opt = ShardedAsynchronous(model, lr=0.1, n_push=1, n_pull=1,
                              transports=[dying, worlds[1][1]])
    try:
        _ones_grads(model)
        opt.step()
        dying.dead = True
        for _ in range(2):  # must not raise
            _ones_grads(model)
            opt.step()
        opt._flusher.drain()
        assert opt.shard_down == [True, False]
        seen = []
        while (msg := worlds[1][0].recv(timeout=0.2)) is not None:
            seen.append(msg[1])
        assert seen.count(GU) == 3
    finally:
        opt.finish()  # must not raise either


def test_dead_shard_slice_follows_pure_local_sgd_quantitatively():
    """After a shard dies, its slice of the worker's parameters evolves
    exactly as pure local SGD, while the healthy shard's server still
    answers pulls."""
    model = Tiny()
    worlds = [InProcessTransport.create_world(2) for _ in range(2)]
    dying = Dying(worlds[0][1])
    server1 = make_shard_server(model, shard=1, n_shards=2, transport=worlds[1][0],
                                n_workers=1)
    t1 = threading.Thread(target=server1.run, kwargs={"timeout": 60})
    t1.start()
    lr = 0.1
    opt = ShardedAsynchronous(model, lr=lr, n_push=1, n_pull=1,
                              transports=[dying, worlds[1][1]])
    (lo0, hi0), _ = shard_ranges(8, 2)
    try:
        _ones_grads(model)
        opt.step()
        dying.dead = True
        expect_dead = _flat(model)[lo0:hi0].copy()
        for _ in range(4):
            _ones_grads(model)
            opt.step()
            expect_dead -= lr * 1.0
            time.sleep(0.05)  # let the healthy shard's replies arrive
        np.testing.assert_allclose(_flat(model)[lo0:hi0], expect_dead, rtol=1e-6)
        assert opt.shard_down == [True, False]
        assert server1.message_counts[MessageCode.ParameterRequest] >= 1
    finally:
        opt.finish()
        t1.join(timeout=30)
    assert not t1.is_alive()


def test_sharded_ps_cli_world_end_to_end(tmp_path, monkeypatch):
    """``launch_world(4, n_servers=2)``: two shard servers and two LeNet
    workers on the CPU, every process exits 0, and the worker CSVs keep the
    unsharded ``node1``/``node2`` names."""
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    code = launch_world(
        4, ["--backend", "cpu", "--model", "lenet", "--epochs", "1", "--batch-size", "16",
            "--test-batch-size", "32", "--num-push", "4", "--num-pull", "4",
            "--synthetic-data", "--synthetic-train-size", "96", "--synthetic-test-size",
            "32", "--log-interval", "1000", "--log-dir", str(tmp_path)],
        n_servers=2)
    assert code == 0
    for w in (1, 2):
        assert os.path.exists(tmp_path / f"node{w}.csv")
    assert not os.path.exists(tmp_path / "node3.csv")


def test_sharded_rejoin_adopts_central_without_install():
    """``rejoin=True`` pulls every shard's slice (never installs the fresh
    model) and the first step starts from the adopted values."""
    model = Tiny()
    worlds = [InProcessTransport.create_world(2) for _ in range(2)]
    central = np.arange(8, dtype=np.float32) * 10.0
    servers = [make_shard_server(params=central, shard=s, n_shards=2,
                                 transport=worlds[s][0], n_workers=1) for s in range(2)]
    threads = [threading.Thread(target=s.run, kwargs={"timeout": 60}) for s in servers]
    for t in threads:
        t.start()
    opt = ShardedAsynchronous(model, lr=0.0, n_push=100, n_pull=100,
                              transports=[w[1] for w in worlds], rejoin=True)
    try:
        np.testing.assert_array_equal(
            np.concatenate([servers[0].central, servers[1].central]), central)
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()  # installs the pulled slices
        np.testing.assert_array_equal(_flat(model), central)
        for srv in servers:
            assert srv.message_counts[MessageCode.ParameterUpdate] == 0
    finally:
        opt.finish()
    for t in threads:
        t.join(timeout=30)


def test_peer_down_heartbeat_degrades_shard():
    """A shard whose heartbeat reports ``peer_down`` degrades without a send
    being tried."""
    model = Tiny()
    worlds = [InProcessTransport.create_world(2) for _ in range(2)]

    class FakeHeartbeat:
        peer_down = False

    hbs = [FakeHeartbeat(), FakeHeartbeat()]
    opt = ShardedAsynchronous(model, lr=0.1, n_push=1, n_pull=1,
                              transports=[w[1] for w in worlds], heartbeats=hbs)
    try:
        _ones_grads(model)
        opt.step()
        hbs[0].peer_down = True
        _ones_grads(model)
        opt.step()
        assert opt.shard_down == [True, False]
    finally:
        opt.finish()


def test_nonfinite_loss_skips_the_update_and_keeps_the_cadence():
    model = Tiny()
    worlds = [InProcessTransport.create_world(2) for _ in range(2)]
    opt = ShardedAsynchronous(model, lr=0.1, n_push=1, n_pull=100,
                              transports=[w[1] for w in worlds])
    try:
        before = _flat(model)
        _ones_grads(model)
        opt.step(loss=float("nan"))
        np.testing.assert_array_equal(_flat(model), before)
        assert opt.skipped_updates == 1 and opt.bad_losses == 1 and opt.idx == 1
        opt._flusher.drain()
        pushes = [m for m in iter(lambda: worlds[0][0].recv(timeout=0.1), None)
                  if m[1] == GU]
        assert len(pushes) == 1 and not pushes[0][2].any()
    finally:
        opt.finish()


# ------------------------------------------ one shard, two: the unsharded client

def _pumped_port_run(k, state, batches, n_push=2, n_pull=3):
    """One LeNet worker from ``state`` over ``batches`` against ``k`` shard
    servers (``k = 0``: the unsharded ``Asynchronous`` and one server), the
    listeners stopped and every mailbox pumped after each step. Returns the
    servers' push payloads per step (shards joined) and the final flat
    parameters."""
    model = get_model("lenet", device="cpu")
    model.load_state_dict(state)
    n = sum(p.numel() for p in model.parameters())
    worlds = [InProcessTransport.create_world(2) for _ in range(max(k, 1))]
    pushes = [[] for _ in worlds]
    servers = []
    for s, w in enumerate(worlds):
        srv = (tps.ParameterServer(params=np.zeros(n, np.float32), transport=w[0]) if k == 0
               else make_shard_server(params=np.zeros(n, np.float32), shard=s, n_shards=k,
                                      transport=w[0]))
        inner = srv.handle

        def handle(sender, code, payload, inner=inner, s=s):
            if code == GU:
                pushes[s].append(np.array(payload, np.float32))
            inner(sender, code, payload)

        servers.append(handle)
    if k == 0:
        opt = tps.Asynchronous(model, lr=0.05, n_push=n_push, n_pull=n_pull,
                               transport=worlds[0][1])
        listeners = [opt.listener]
    else:
        opt = ShardedAsynchronous(model, lr=0.05, n_push=n_push, n_pull=n_pull,
                                  transports=[w[1] for w in worlds])
        listeners = opt.listeners
    for listener in listeners:
        listener.stop()
        listener.join(timeout=5)
    gen = torch.Generator().manual_seed(5)
    for bx, by in batches:
        loss_and_grads(model, torch.from_numpy(bx), torch.from_numpy(by.astype(np.int64)),
                       generator=gen)
        opt.step()
        opt._flusher.drain()
        for w, handle, listener in zip(worlds, servers, listeners):
            _pump(w[0], handle)
            _pump(w[1], listener.receive)
    opt._flusher.stop()
    joined = [np.concatenate(parts) for parts in zip(*pushes)]
    return joined, _flat(model)


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_client_equals_the_unsharded_client_bit_for_bit(k):
    state = get_model("lenet", seed=7, device="cpu").state_dict()
    batches = _batches(7, seed=3)
    ref_pushes, ref_flat = _pumped_port_run(0, state, batches)
    pushes, flat = _pumped_port_run(k, state, batches)
    assert len(pushes) == len(ref_pushes) == 4  # steps 0, 2, 4, 6
    for a, b in zip(pushes, ref_pushes):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(flat, ref_flat)


# --------------------------------------------- across the packages, exactly

def _recording(base, pushes):
    class Recording(base):
        def send(self, code, payload, dst=0):
            if int(code) == int(GU):
                pushes.append(np.array(payload, np.float32, copy=True))
            super().send(code, payload, dst)

    return Recording


def _jlenet(seed):
    jmodel = jget_model("lenet")
    params = jmodel.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)))["params"]

    @jax.jit
    def jloss_grad(p, bx, by):
        return jax.value_and_grad(lambda q: jce(jmodel.apply({"params": q}, bx), by))(p)

    return params, jloss_grad


@pytest.mark.parametrize("worker_pkg,server_pkg", [("jax", "port"), ("port", "jax")])
def test_shard_servers_sum_each_slice_exactly_across_the_packages(worker_pkg, server_pkg):
    """A worker of one package against the other package's two shard
    servers (threads, the shared mailboxes): each server's central slice
    ends as the worker's install slice plus the sum of that shard's pushes,
    bit for bit."""
    jparams, jloss_grad = _jlenet(4)
    flat0 = np.asarray(ravel_pytree(jparams)[0], np.float32)
    n, k = flat0.size, 2
    smsg = jmsg if server_pkg == "jax" else tmsg
    wmsg = jmsg if worker_pkg == "jax" else tmsg
    boxes = [smsg.InProcessTransport.create_world(2)[0]._boxes for _ in range(k)]
    make = jsp.make_shard_server if server_pkg == "jax" else make_shard_server
    servers = [make(params=np.zeros(n, np.float32), shard=s, n_shards=k,
                    transport=smsg.InProcessTransport(0, boxes[s]), n_workers=1)
               for s in range(k)]
    threads = [threading.Thread(target=srv.run, kwargs={"timeout": 120}) for srv in servers]
    for t in threads:
        t.start()
    pushes = [[] for _ in range(k)]
    transports = [_recording(wmsg.InProcessTransport, pushes[s])(1, boxes[s])
                  for s in range(k)]
    batches = _batches(5, seed=2)
    if worker_pkg == "jax":
        opt = jsp.ShardedAsynchronous(jparams, lr=0.05, n_push=2, n_pull=3,
                                      transports=transports)
        params = jparams
        for bx, by in batches:
            _loss, grads = jloss_grad(params, bx, by)
            params = opt.step(params, grads)
    else:
        model = get_model("lenet", device="cpu")
        model.load_state_dict(interop.params_from_jax(jax.tree.map(np.asarray, jparams),
                                                      model))
        np.testing.assert_array_equal(_flat(model), flat0)
        opt = ShardedAsynchronous(model, lr=0.05, n_push=2, n_pull=3, transports=transports)
        for bx, by in batches:
            loss_and_grads(model, torch.from_numpy(bx), torch.from_numpy(by.astype(np.int64)))
            opt.step()
    opt.finish()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for s, (lo, hi) in enumerate(shard_ranges(n, k)):
        assert len(pushes[s]) == 4  # steps 0, 2, 4 and the final push
        expected = flat0[lo:hi].copy()
        for p in pushes[s]:
            expected += p
        np.testing.assert_array_equal(servers[s].central, expected)
        assert servers[s].message_counts[MessageCode.GradientUpdate] == 4


def test_two_worker_k2_worlds_agree_across_the_packages():
    """Two LeNet workers against two shard servers per package, from the
    same weights on the same batches (n_push 2, n_pull 3), with no thread
    of their own: the listeners are stopped and one loop pumps every
    mailbox in a fixed order (worker 1 steps and its push is flushed, each
    shard server handles its inbox, worker 1 takes its replies; then worker
    2)."""
    steps, k = 8, 2
    jparams, jloss_grad = _jlenet(1)
    n = int(ravel_pytree(jparams)[0].size)
    state = interop.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    get_model("lenet", device="cpu"))
    batches = {r: _batches(steps, seed=10 + r) for r in (1, 2)}

    def world_run(pkg):
        msg = jmsg if pkg == "jax" else tmsg
        make = jsp.make_shard_server if pkg == "jax" else make_shard_server
        worlds = [msg.InProcessTransport.create_world(3) for _ in range(k)]
        servers = [make(params=np.zeros(n, np.float32), shard=s, n_shards=k,
                        transport=worlds[s][0], n_workers=2) for s in range(k)]
        workers = {}
        for r in (1, 2):
            transports = [w[r] for w in worlds]
            if pkg == "jax":
                opt = jsp.ShardedAsynchronous(jparams, lr=0.05, n_push=2, n_pull=3,
                                              transports=transports)
                workers[r] = [opt, jparams]
            else:
                model = get_model("lenet", device="cpu")
                model.load_state_dict(state)
                model.dropout_rate = 0.0  # the JAX side applies LeNet without dropout
                opt = ShardedAsynchronous(model, lr=0.05, n_push=2, n_pull=3,
                                          transports=transports)
                workers[r] = [opt, model]
            for listener in opt.listeners:
                listener.stop()
                listener.join(timeout=5)

        def pump(box, handle):
            while (m := box.recv(timeout=0.01)) is not None:
                handle(m[0], msg.MessageCode(int(m[1])), m[2])

        losses = {1: [], 2: []}
        for i in range(steps):
            for r in (1, 2):
                opt, held = workers[r]
                bx, by = batches[r][i]
                if pkg == "jax":
                    loss, grads = jloss_grad(held, bx, by)
                    workers[r][1] = opt.step(held, grads)
                else:
                    loss = loss_and_grads(held, torch.from_numpy(bx),
                                          torch.from_numpy(by.astype(np.int64)))
                    opt.step()
                losses[r].append(float(loss))
                opt._flusher.drain()
                for s in range(k):
                    pump(worlds[s][0], servers[s].handle)
                    pump(worlds[s][r], opt.listeners[s].receive)
        for r in (1, 2):
            workers[r][0]._flusher.stop()
        return losses, servers

    (jlosses, jservers), (tlosses, tservers) = world_run("jax"), world_run("port")
    for r in (1, 2):
        np.testing.assert_allclose(tlosses[r], jlosses[r], rtol=WORLD_LOSS_RTOL)
    for ts, js in zip(tservers, jservers):
        assert ts.staleness.version == js.staleness.version == steps
        np.testing.assert_allclose(ts.central, js.central, rtol=1e-4, atol=1e-6)
