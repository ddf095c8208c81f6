"""The port's elastic PS plane (``coord/elastic.py``, the elastic path of
``parallel/sharded_ps.py``, ``coord/demo.py``) against the JAX package's.

- The scripted elastic server: both packages' ``ElasticShardServer`` (a stub
  member) through map v1, map v2 with a fresh range, a parked pull, a first
  and a duplicate ``RangeInstall``, an equal-size ``ShardPush`` at moved
  offsets, an unstamped ``GradientUpdate``, stamped, unstamped, other-range
  and truncated ``CompressedUpdate`` frames, a ``SpeculativeUpdate`` and its
  duplicate, a whole-range install and a resize under an sgdm optimizer:
  equal central values, stats, optimizer state and reply frames.
- The elastic worker: ``apply_shard_map`` on the same parameters and map
  sends the same ``RangeInstall`` frames in both packages, and the pushes
  after it the same stamped ``ShardPush`` (and compressed) frames.
- The JAX scenarios ``test_elastic_acceptance_join_crash_rebalance_corridor``,
  ``test_speculation_straggler_no_longer_gates_epoch``,
  ``test_stamped_push_drops_same_size_cross_version_traffic`` and
  ``test_stamped_pull_reply_dropped_by_cross_version_worker``
  (``tests/test_coord.py``) on the port's LeNet on the CPU.
- The port's server adopts a map as it arrives (before its serve loop
  runs) and serves what it has taken in before a clean stop ends it.
"""

import threading
import time

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.coord import elastic as jel
from distributed_ml_pytorch_tpu.coord.shardmap import ShardMap as JShardMap
from distributed_ml_pytorch_tpu.parallel import optplane as jopt
from distributed_ml_pytorch_tpu.parallel import sharded_ps as jsp
from distributed_ml_pytorch_tpu.utils import messaging as jmsg
from distributed_ml_pytorch_tpu_torch.coord import elastic as tel
from distributed_ml_pytorch_tpu_torch.coord.coordinator import Coordinator
from distributed_ml_pytorch_tpu_torch.coord.demo import ElasticWorld, _worker_rank, \
    default_fixture, elastic_scenario
from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient
from distributed_ml_pytorch_tpu_torch.coord.shardmap import ShardMap, rebalance
from distributed_ml_pytorch_tpu_torch.models import get_model
from distributed_ml_pytorch_tpu_torch.parallel import optplane as topt
from distributed_ml_pytorch_tpu_torch.parallel.async_ps import Listener
from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import ShardedAsynchronous
from distributed_ml_pytorch_tpu_torch.training.trainer import loss_and_grads, to_device
from distributed_ml_pytorch_tpu_torch.utils import compress as tcompress
from distributed_ml_pytorch_tpu_torch.utils import interop
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport, MessageCode, \
    _split16
from distributed_ml_pytorch_tpu_torch.utils.serialization import ravel_model_params

MC = MessageCode


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _StubCoord:
    """Just enough member surface for a server or worker driven by hand."""

    on_snapshot = on_rollback = on_preempt = None

    def __init__(self):
        self.reports, self.maps = [], []

    def report(self, *a, **k):
        self.reports.append(a)

    def report_gray_health(self, **k):
        pass

    def take_shard_map(self):
        return self.maps.pop(0) if self.maps else None


def _stamped(head, values):
    return np.concatenate([np.asarray([v for x in head for v in _split16(x)], np.float32),
                           np.asarray(values, np.float32)])


def _same_count_rebalance_maps(n=100):
    """A join and a death in one rebalance: server 2 keeps a 50-param range
    at moved offsets."""
    m1 = rebalance(ShardMap(0, n, ()), [1, 2])   # v1: s1=[0,50) s2=[50,100)
    m2 = rebalance(m1, [2, 3])                   # v2: s2=[0,50) s3=[50,100)
    e1, e2 = m1.entry_for(2), m2.entry_for(2)
    assert (e1.size == e2.size == 50) and (e1.lo, e1.hi) != (e2.lo, e2.hi)
    return m1, m2


# ------------------------------------------------------------ the scripted server

def _compressed(stamp, n, seed):
    enc = tcompress.CompressingEncoder(n, tcompress.make_codec("int8", block=16))
    vals = np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 0.01
    return np.concatenate(enc.encode_range(vals, 0, n, stamp=stamp))


def _server_script(n=100):
    m1, m2 = _same_count_rebalance_maps(n)
    m3 = rebalance(m2, [2])
    rng = np.random.default_rng(5)
    d = lambda k: (rng.standard_normal(k) * 0.1).astype(np.float32)  # noqa: E731
    return [
        ("map", m1),
        (1, MC.ShardPush, _stamped((1, 50, 100), d(50))),
        (1, MC.ParameterRequest, np.zeros(0, np.float32)),
        ("map", m2),
        (1, MC.ParameterRequest, np.zeros(0, np.float32)),  # parked: [0,50) is fresh
        (1, MC.RangeInstall, _stamped((0, 50), d(50))),
        (3, MC.RangeInstall, _stamped((0, 50), d(50))),  # the first install won
        (1, MC.RangeInstall, _stamped((0, 50), d(49))),  # a size that lies
        (1, MC.ShardPush, _stamped((1, 50, 100), d(50))),  # equal size, moved offsets
        (1, MC.GradientUpdate, d(50)),  # unstamped
        (1, MC.ShardPush, _stamped((2, 0, 50), d(50))),
        (1, MC.CompressedUpdate, _compressed((2, 0, 50), 50, 1)),
        (3, MC.CompressedUpdate, _compressed(None, 50, 2)),  # unstamped
        (3, MC.CompressedUpdate, _compressed((1, 50, 100), 50, 3)),  # another range
        (3, MC.CompressedUpdate, _compressed((2, 0, 50), 50, 4)[:12]),  # truncated
        (1, MC.SpeculativeUpdate, _stamped((7, 2, 0, 50), d(50))),
        (3, MC.SpeculativeUpdate, _stamped((7, 2, 0, 50), d(50))),  # the late copy
        (3, MC.SpeculativeUpdate, _stamped((8, 1, 50, 100), d(50))),  # another range
        (1, MC.ParameterRequest, np.zeros(0, np.float32)),
        (3, MC.ParameterUpdate, d(50)),
        ("map", m3),  # [0,100): the fresh half under the optimizer
        (1, MC.ParameterRequest, np.zeros(0, np.float32)),
        (3, MC.ShardPush, _stamped((3, 0, 100), d(100))),
        (1, MC.RangeInstall, _stamped((50, 100), d(50))),
        (3, MC.ShardPush, _stamped((3, 0, 100), d(100))),
        (1, MC.ParameterRequest, np.zeros(0, np.float32)),
        (3, MC.ParameterRequest, np.asarray([-1.0, 0.0, 0.0], np.float32)),  # delta-opted
    ]


#: the port server's counters (the JAX one also counts its rollbacks)
STATS = ("stale_dropped", "parked_pulls", "installs", "dup_installs", "spec_applied",
         "spec_dropped", "resizes")


def _run_server(pkg):
    el, opt, msg = (tel, topt, tmsg) if pkg == "port" else (jel, jopt, jmsg)
    world = msg.InProcessTransport.create_world(4)
    srv = el.ElasticShardServer(
        2, 100, world[0], _StubCoord(), init_params=np.arange(100, dtype=np.float32),
        optimizer=opt.ShardedOptimizer("sgdm", 0, 0, lr=0.5, momentum=0.5))
    outs = []
    for item in _server_script():
        if item[0] == "map":
            # a map frame decoded by the package's own shard map class
            srv._apply_map(item[1] if pkg == "port" else JShardMap.decode(item[1].encode()))
            continue
        sender, code, payload = item
        srv.handle(sender, code if pkg == "port" else jmsg.MessageCode(int(code)), payload)
        for r in (1, 3):
            while (m := world[r].recv(timeout=0.0)) is not None:
                outs.append((r, int(m[1]), m[2].tobytes()))
    o = srv.ps.optimizer
    return (srv.central.tobytes(), {k: srv.stats[k] for k in STATS},
            (o.lo, o.hi, o.t, o.m.tobytes(), o.v.tobytes()),
        outs, (srv.lo, srv.hi, srv.map_version, srv.pending_install, srv.ps._apply_seq),
        srv.ps.pull_reply_head.tobytes())


def test_scripted_elastic_server_equals_jax():
    mine, ref = _run_server("port"), _run_server("jax")
    assert mine == ref
    stats = mine[1]
    assert stats == {"stale_dropped": 7, "parked_pulls": 2, "installs": 2, "dup_installs": 1,
                     "spec_applied": 1, "spec_dropped": 1, "resizes": 3}
    assert [c for _r, c, _b in mine[3]] == [int(MC.ShardParams)] * 3 + [int(MC.DeltaParams)]


# ------------------------------------------------------------ the elastic worker

def _worker_frames(pkg, compress=None):
    """A worker cut over from v1 (two shards) to v2 (server 1 alone): the
    frames each server's mailbox took, from construction to one push."""
    model = get_model("lenet", seed=3, device="cpu")
    n = ravel_model_params(model).numel()
    m1 = rebalance(ShardMap(0, n), [1, 2])
    m2 = rebalance(m1, [1])
    arr = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    msg = tmsg if pkg == "port" else jmsg
    worlds = {sid: msg.InProcessTransport.create_world(2) for sid in (1, 2)}
    coord = _StubCoord()
    kw = dict(transports=[worlds[e.server_id][1] for e in m1.entries], coord=coord,
              transport_factory=lambda e: worlds[e.server_id][1], compress=compress)
    if pkg == "port":
        opt = ShardedAsynchronous(model, lr=0.01, n_push=1, n_pull=1, shard_map=m1, **kw)
        opt.apply_shard_map(m2)
    else:
        params = interop.params_to_jax(model)
        opt = jsp.ShardedAsynchronous(params, lr=0.01, n_push=1, n_pull=1,
                                      shard_map=JShardMap.decode(m1.encode()), **kw)
        opt.apply_shard_map(JShardMap.decode(m2.encode()), params)
    opt._push_all(arr)
    opt._flusher.stop()
    for listener in opt.listeners:
        listener.stop()
    frames = {}
    for sid, w in worlds.items():
        box = []
        while (m := w[0].recv(timeout=0.0)) is not None:
            box.append((int(m[1]), m[2].tobytes()))
        frames[sid] = box
    return frames, n


@pytest.mark.parametrize("compress", [None, "int8"])
def test_elastic_worker_cutover_sends_the_jax_frames(compress):
    (mine, n), (ref, _n) = _worker_frames("port", compress), _worker_frames("jax", compress)
    assert mine == ref
    codes = [c for c, _b in mine[1]]
    assert codes == [int(MC.ParameterUpdate), int(MC.RangeInstall),
                     int(MC.CompressedUpdate if compress else MC.ShardPush)]
    assert [c for c, _b in mine[2]] == [int(MC.ParameterUpdate)]
    push = np.frombuffer(mine[1][-1][1], np.float32)
    if compress:
        assert tcompress.peek_stamp(push) == (2, 0, n)
    else:
        assert push.size == n + 6


def test_elastic_client_refuses_heartbeats_and_checks_the_map():
    model = get_model("lenet", device="cpu")
    world = InProcessTransport.create_world(2)
    with pytest.raises(ValueError, match="lease"):
        ShardedAsynchronous(model, 0.1, 1, 1, transports=[world[1]], coord=_StubCoord(),
                            transport_factory=lambda e: None, heartbeats=[object()])
    with pytest.raises(ValueError, match="transport_factory"):
        ShardedAsynchronous(model, 0.1, 1, 1, transports=[world[1]], coord=_StubCoord())
    with pytest.raises(ValueError, match="covers"):
        ShardedAsynchronous(model, 0.1, 1, 1, transports=[world[1]], coord=_StubCoord(),
                            transport_factory=lambda e: None,
                            shard_map=rebalance(ShardMap(0, 10), [1]))


# ------------------------------------------------------------ the JAX scenarios

@pytest.fixture(scope="module")
def fixture():
    return default_fixture("lenet", device="cpu")


def test_stamped_push_drops_same_size_cross_version_traffic():
    n = 100
    flat0 = np.arange(n, dtype=np.float32)
    m1, m2 = _same_count_rebalance_maps(n)
    world = InProcessTransport.create_world(2)
    srv = tel.ElasticShardServer(server_id=2, n_params=n, transport=world[0],
                                 coord=_StubCoord(), init_params=flat0)
    srv._apply_map(m1)
    assert (srv.lo, srv.hi) == (50, 100)
    srv._apply_map(m2)
    assert (srv.lo, srv.hi) == (0, 50)
    before = srv.central
    delta = np.full(50, 0.5, np.float32)
    srv.handle(9, MC.ShardPush, _stamped((m1.version, 50, 100), delta))
    assert srv.stats["stale_dropped"] == 1
    np.testing.assert_array_equal(srv.central, before)
    srv.handle(9, MC.GradientUpdate, delta)
    assert srv.stats["stale_dropped"] == 2
    np.testing.assert_array_equal(srv.central, before)
    srv.handle(9, MC.ShardPush, _stamped((m2.version, 0, 50), delta))
    np.testing.assert_array_equal(srv.central, before + delta)
    srv.handle(9, MC.SpeculativeUpdate, _stamped((7, m1.version, 50, 100), delta))
    assert srv.stats["stale_dropped"] == 3 and srv.stats["spec_applied"] == 0
    # a version bump that left the range in place keeps in-flight pushes
    m3 = rebalance(m2, [2, 3])
    assert m3.entry_for(2).lo == 0 and m3.entry_for(2).hi == 50
    srv._apply_map(m3)
    srv.handle(9, MC.ShardPush, _stamped((m2.version, 0, 50), delta))
    np.testing.assert_array_equal(srv.central, before + 2 * delta)
    assert srv.stats["stale_dropped"] == 3
    for t in world.values():
        t.close()


def test_stamped_pull_reply_dropped_by_cross_version_worker():
    n = 100
    flat0 = np.arange(n, dtype=np.float32)
    m1, m2 = _same_count_rebalance_maps(n)
    world = InProcessTransport.create_world(2)
    srv = tel.ElasticShardServer(server_id=2, n_params=n, transport=world[0],
                                 coord=_StubCoord(), init_params=flat0)
    srv._apply_map(m1)
    srv._apply_map(m2)
    srv.handle(1, MC.RangeInstall, _stamped((0, 50), flat0[0:50]))
    assert srv.pending_install is None
    srv.handle(1, MC.ParameterRequest, np.zeros(0, np.float32))
    listener = Listener(transport=world[1])
    msg = world[1].recv(timeout=5)
    assert msg is not None and msg[1] == MC.ShardParams
    listener.receive(*msg)
    stamp, values = listener.take_latest_versioned()
    assert stamp == (m2.version, 0, 50) and values.shape == (50,)
    e1 = m1.entry_for(2)
    assert stamp[1:] != (e1.lo, e1.hi)
    listener.receive(1, MC.ParameterUpdate, np.zeros(50, np.float32))
    stamp2, values2 = listener.take_latest_versioned()
    assert stamp2 is None and values2.shape == (50,)
    assert listener.replies == 2
    # the elastic client's gate drops the stamped reply in a slot cut for v1
    model = get_model("lenet", device="cpu")
    flat = ravel_model_params(model).numpy().copy()
    nm1 = rebalance(ShardMap(0, flat.size), [1, 2])
    w2 = InProcessTransport.create_world(2)
    opt = ShardedAsynchronous(model, 0.1, 5, 5, transports=[w2[1], w2[1]], coord=_StubCoord(),
                              transport_factory=lambda e: w2[1], shard_map=nm1)
    for listener_ in opt.listeners:
        listener_.stop()
    lo, hi = nm1.ranges[1]
    opt.listeners[1].receive(0, MC.ShardParams,
                             _stamped((1, 0, hi - lo), np.ones(hi - lo, np.float32)))
    opt._install_arrived()
    np.testing.assert_array_equal(ravel_model_params(model).numpy(), flat)
    opt._flusher.stop()


@pytest.fixture(scope="module")
def clean_final(fixture):
    clean = elastic_scenario(seed=0, steps=20, n_workers=2, n_shards=2, fixture=fixture,
                             lease=0.5, step_sleep=0.06, device="cpu")
    assert clean["ok"], clean["errors"]
    return float(np.mean([np.mean(v[-6:]) for v in clean["losses"].values()]))


@pytest.mark.parametrize("run", [0, 1, 2])
def test_elastic_acceptance_join_crash_rebalance_corridor(fixture, clean_final, run):
    """Two workers and two shards under chaos; a third worker joins at step
    5, shard 2 crashes silently at step 8; the coordinator finds it by its
    lease and rebalances; training goes on into the fault-free corridor.
    The JAX test's three runs, one a case."""
    from distributed_ml_pytorch_tpu_torch.utils.chaos import ChaosPlan, FaultRule

    plan = ChaosPlan([FaultRule(code=int(c), drop=0.05, dup=0.05)
                      for c in (MC.GradientUpdate, MC.ParameterRequest, MC.ParameterUpdate)],
                     seed=42)
    out = elastic_scenario(seed=0, steps=20, n_workers=2, n_shards=2, join_worker_at=5,
                           join_worker_steps=10, crash_shard_at=8, plan=plan, lease=0.5,
                           step_sleep=0.06, fixture=fixture, device="cpu")
    assert out["ok"], (out["errors"], out["events"])
    assert out["map_version"] >= 3, out["events"]
    assert any("lease expired" in e for e in out["events"]), out["events"]
    assert sorted(out["losses"]) == [1, 2, 3]
    assert len(out["losses"][3]) == 10
    assert out["worker_map_versions"][1] >= 3, out["worker_map_versions"]
    assert out["worker_map_versions"][2] >= 3, out["worker_map_versions"]
    assert out["stats"][1]["resizes"] >= 1
    for losses in out["losses"].values():
        assert np.mean(losses[-6:]) < np.mean(losses[:6]) + 0.05, losses
    final = np.mean([np.mean(v[-6:]) for v in out["losses"].values()])
    assert abs(final - clean_final) < 0.45, (final, clean_final)


def test_speculation_straggler_no_longer_gates_epoch(fixture):
    """A 10x-slow straggler's tail is speculated on the fast worker; the
    shard applies the first result of the task and drops the late one."""
    x, y, make_model = fixture
    flat0 = ravel_model_params(make_model()).numpy()
    n = flat0.size
    steps, slow_sleep = 10, 0.4
    world = ElasticWorld(n_shards=1, max_workers=2)
    coord = Coordinator(world.coord_world[0], n, lease=2.0, straggler_factor=3.0,
                        straggler_after_steps=2, speculation=True)
    coord_thread = threading.Thread(target=coord.run, kwargs={"timeout": 120}, daemon=True)
    coord_thread.start()
    sclient = CoordClient(world.coord_world[1], "shard", renew_interval=0.2)
    srv = tel.ElasticShardServer(server_id=1, n_params=n, transport=world.shard_worlds[0][0],
                                 coord=sclient, init_params=flat0)
    srv_thread = threading.Thread(target=srv.run, kwargs={"timeout": 120}, daemon=True)
    srv_thread.start()
    done_at, spec_by_worker = {}, {}

    def worker(j, slow):
        tasks = []
        spec_by_worker[j] = tasks
        client = CoordClient(world.coord_world[_worker_rank(1, j)], "worker",
                             renew_interval=0.2, on_speculate=lambda *a: tasks.append(a))
        m = client.join(timeout=30)
        factory = world.worker_factory(j)
        net = make_model()
        opt = ShardedAsynchronous(net, lr=0.05, n_push=2, n_pull=2,
                                  transports=[factory(e) for e in m.entries], coord=client,
                                  transport_factory=factory, shard_map=m)
        gen = torch.Generator().manual_seed(j)
        for step in range(steps):
            sel = np.random.default_rng(j * 100 + step).integers(0, len(x), 16)
            loss_and_grads(net, *to_device(x[sel], y[sel], "cpu"), generator=gen)
            opt.step()
            if slow:
                time.sleep(slow_sleep)
        if not slow:
            deadline = time.monotonic() + 30
            while not tasks and time.monotonic() < deadline:
                time.sleep(0.05)
        if tasks:
            tid, _victim, _frm = tasks[0]
            upd = np.zeros(n, np.float32)
            upd[:8] = 0.001
            opt.push_speculative(tid, upd)
        opt.finish()
        client.close()
        done_at[j] = time.monotonic()

    t0 = time.monotonic()
    threads = [threading.Thread(target=worker, args=(1, False), daemon=True),
               threading.Thread(target=worker, args=(2, True), daemon=True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    srv_thread.join(timeout=30)
    srv.stop()
    coord.stop()
    coord_thread.join(timeout=10)
    assert any("straggler:" in e for e in coord.events), coord.events
    assert spec_by_worker[1] and spec_by_worker[2]
    assert spec_by_worker[1][0] == spec_by_worker[2][0]
    assert srv.stats["spec_applied"] == 1
    assert srv.stats["spec_dropped"] == 1
    fast_done, slow_done = done_at[1] - t0, done_at[2] - t0
    assert slow_done > fast_done + 0.5 * slow_sleep * steps / 2, (fast_done, slow_done)
    world.close()


# ------------------------------------------------------------ the port's server

def test_the_server_adopts_a_map_as_it_arrives():
    """The member's listener applies a map to the server at once: a worker
    that cut over first never finds the server on the old map."""
    world = InProcessTransport.create_world(2)
    coord_world = InProcessTransport.create_world(2)
    client = CoordClient(coord_world[1], "shard", renew_interval=60.0)
    srv = tel.ElasticShardServer(1, 100, world[0], client,
                                 init_params=np.zeros(100, np.float32))
    try:
        m1 = rebalance(ShardMap(0, 100), [1])
        coord_world[0].send(MC.ShardMapUpdate, tmsg.stamp_epoch(m1.encode(), 1), dst=1)
        deadline = time.monotonic() + 5
        while srv.map_version < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert (srv.lo, srv.hi, srv.map_version) == (0, 100, 1)
        srv.handle(2, MC.ShardPush, _stamped((1, 0, 100), np.ones(100, np.float32)))
        assert srv.stats["stale_dropped"] == 0 and srv.ps._apply_seq == 1
    finally:
        client.stop()


def test_a_clean_stop_serves_the_frames_already_taken_in():
    """Frames in the server's inbox when it is stopped are served before it
    leaves; a crash serves nothing more."""
    class Member(_StubCoord):
        fleet = type("Fleet", (), {"workers_done": staticmethod(lambda: False)})()

        def join(self):
            return None

        def stop(self):
            self.stopped = True

        def close(self):
            self.closed = True

    for crash in (False, True):
        world = InProcessTransport.create_world(2)
        member = Member()
        srv = tel.ElasticShardServer(1, 10, world[0], member,
                                     init_params=np.zeros(10, np.float32))
        srv._apply_map(rebalance(ShardMap(0, 10), [1]))
        for _ in range(3):
            world[1].send(MC.ShardPush, _stamped((1, 0, 10), np.ones(10, np.float32)))
        if crash:
            srv.crash()
        else:
            srv.stop()
        srv.run(timeout=5)
        assert srv.ps._apply_seq == (0 if crash else 3)
        assert getattr(member, "closed", False) is not crash


def test_a_durable_server_closes_its_group_on_an_empty_inbox(tmp_path):
    """A logged push's ack is released as soon as the server's inbox is
    empty, not after an idle receive (0.1 s): otherwise each push of a
    sender held to a narrow window (a lagging server's credit) waited that
    long for its ack, and the health scenario ran about three times longer.
    Five pushes sent one at a time, each waiting for its ack: the quickest
    ack comes well inside 0.1 s (before, none did)."""
    class Member(_StubCoord):
        fleet = type("Fleet", (), {"workers_done": staticmethod(lambda: False)})()

        def join(self):
            return None

        def stop(self):
            pass

        def close(self):
            pass

    world = InProcessTransport.create_world(2)
    server_t = tmsg.ReliableTransport(world[0], ack_on_delivery=False)
    worker = tmsg.ReliableTransport(world[1])
    srv = tel.ElasticShardServer(1, 10, server_t, Member(), ckpt_dir=str(tmp_path), wal=True,
                                 init_params=np.zeros(10, np.float32))
    srv._apply_map(rebalance(ShardMap(0, 10), [1]))
    serve = threading.Thread(target=srv.run, kwargs={"timeout": 30})
    serve.start()
    waits = []
    try:
        for _ in range(5):
            t0 = time.monotonic()
            worker.send(MC.ShardPush, _stamped((1, 0, 10), np.ones(10, np.float32)))
            assert worker.flush(timeout=5), worker.stats
            waits.append(time.monotonic() - t0)
    finally:
        srv.stop()
        serve.join(timeout=10)
        for t in (worker, server_t):
            t.detach()
    assert srv.ps._apply_seq == 5 and worker.stats["retries"] == 0
    assert min(waits) < 0.05, waits
