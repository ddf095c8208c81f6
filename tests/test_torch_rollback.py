"""The port's rollback plane against the JAX package's: the server's
in-place ``rollback_restore`` (``parallel/async_ps.py``), reputation and the
watchdog with its barrier (``coord/coordinator.py``), the member's hold
(``coord/member.py``), the shard's rollback mailbox (``coord/elastic.py``)
and the sharded worker's barrier (``parallel/sharded_ps.py``).

- ``rollback_restore``: the same seeded pushes, pulls and checkpoint
  through a JAX and a port server, then a rollback to one apply seq:
  central vector, clocks, per-sender counts, optimizer moments, the WAL
  records left and the next pull reply equal bit for bit, for plain adds,
  a server ``sgdm``, Adasum and delta replies; the refusal when the
  checkpoint is already past the target, as JAX's.
- The coordinator: reputation's revoke and cooldown, the watchdog on a
  diverging loss and on nonfinite losses (and a reborn worker's fresh
  evidence), the barrier's timeout and its refusal without a manifest, all
  driven through both packages under a fake clock: the same frames and
  events.
- ``FleetView``'s hold and its fail-open TTL; a ``RollbackRequest`` through
  the client sets it and reaches the callback.
- The shard: a rollback through the mailbox restores in place and
  reports; a manifest of another range is a loud no-op, and so is a
  manifest that omits the server (the JAX serve loop dies on that one).
- The worker: a barrier drains the push thread, zeroes the accumulator in
  place, discards the replies taken in, pulls every shard and holds the
  updates until each has installed.
"""

import os
import time

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.coord import coordinator as jco
from distributed_ml_pytorch_tpu.coord import member as jmem
from distributed_ml_pytorch_tpu.parallel import async_ps as jps
from distributed_ml_pytorch_tpu.parallel import optplane as jopt
from distributed_ml_pytorch_tpu_torch.coord import coordinator as tco
from distributed_ml_pytorch_tpu_torch.coord import manifest as tman
from distributed_ml_pytorch_tpu_torch.coord import member as tmem
from distributed_ml_pytorch_tpu_torch.coord.elastic import ElasticShardServer
from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
from distributed_ml_pytorch_tpu_torch.parallel import optplane as topt
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    InProcessTransport,
    stamp_epoch,
)
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode as MC

N = 64


def _b(a):
    return np.asarray(a, np.float32).tobytes()


class _Recorder:
    rank = 0

    def __init__(self):
        self.sent = []

    def send(self, code, payload, dst=0):
        self.sent.append((dst, int(code), _b(payload)))

    def sendv(self, code, parts, dst=0):
        self.send(code, np.concatenate([np.asarray(p, np.float32).ravel() for p in parts]),
                  dst)

    def recv(self, timeout=None):
        return None


# ------------------------------------------------------------ the server

def _server(pkg, kind, d):
    ps_mod, opt_mod = (jps, jopt) if pkg == "jax" else (tps, topt)
    opt = opt_mod.ShardedOptimizer("sgdm", 0, N, lr=1.0, momentum=0.5) if kind == "sgdm" \
        else None
    return ps_mod.ParameterServer(params=np.zeros(N, np.float32), transport=_Recorder(),
                                  ckpt_dir=str(d), ckpt_every=0, wal=True,
                                  combine="adasum" if kind == "adasum" else "add",
                                  optimizer=opt)


def _pull(ps, sender, kind):
    held = (np.asarray([ps._pull_epoch, *tps._split16(ps._apply_seq)], np.float32)
            if kind == "delta" else np.zeros(0, np.float32))
    ps.handle(sender, MC.ParameterRequest, held)


def _script(ps, kind, rng):
    """Seeded pushes from two senders around a checkpoint at apply seq 3;
    pulls open Adasum windows and delta bases."""
    for step in range(8):
        sender = 1 + step % 2
        if step in (1, 4, 6):
            _pull(ps, sender, kind)
        ps.handle(sender, MC.GradientUpdate, (0.1 * rng.standard_normal(N)).astype(np.float32))
        if step == 2:
            ps.save_checkpoint()
    ps.commit()


def _state(ps):
    st = {"central": _b(ps.central), "seq": ps._apply_seq, "push": ps._push_count,
          "version": ps.staleness.version, "by_sender": dict(ps.applied_by_sender),
          "rolled": ps.rolled_back_updates,
          "wal": [(r.seq, r.sender, r.codec, _b(r.payload)) for r in ps.wal.replay()[0]],
          "overlap": sorted(ps._overlap), "bases": sorted(ps._pull_bases)}
    if ps.optimizer is not None:
        st["opt"] = (_b(ps.optimizer.m), _b(ps.optimizer.v), ps.optimizer.t)
    return st


@pytest.mark.parametrize("kind", ["add", "sgdm", "adasum", "delta"])
def test_rollback_restore_equals_jax_bit_for_bit(tmp_path, kind):
    states, replies = [], []
    for pkg in ("jax", "port"):
        ps = _server(pkg, kind, tmp_path / pkg)
        _script(ps, kind, np.random.default_rng(0))
        before_epoch = ps._pull_epoch
        assert ps.rollback_restore(5) == 3
        assert ps._pull_epoch == before_epoch + 1
        states.append(_state(ps))
        ps.transport.sent.clear()
        _pull(ps, 2, kind)  # the first reply after a rollback is a full install
        replies.append(ps.transport.sent)
    assert states[0] == states[1]
    assert states[1]["seq"] == 5 and [r[0] for r in states[1]["wal"]] == [4, 5]
    assert states[1]["overlap"] == [] and states[1]["bases"] == []
    assert replies[0] == replies[1] and len(replies[1]) == 1
    if kind == "delta":
        assert np.frombuffer(replies[1][0][2], np.float32)[0] == 0.0  # codec 0: dense


def test_a_restore_after_a_rollback_finds_the_tail_gone(tmp_path):
    ps = _server("port", "add", tmp_path / "p")
    _script(ps, "add", np.random.default_rng(1))
    ps.rollback_restore(4)
    again = tps.ParameterServer(params=np.zeros(N, np.float32), ckpt_dir=str(tmp_path / "p"),
                                wal=True)
    assert again.maybe_restore() and again._apply_seq == 4
    assert np.array_equal(again.central, ps.central)


def test_rollback_restore_refuses_a_checkpoint_ahead_of_the_target(tmp_path):
    for pkg in ("jax", "port"):
        ps = _server(pkg, "add", tmp_path / pkg)
        for _ in range(6):
            ps.handle(1, MC.GradientUpdate, np.ones(N, np.float32))
        ps.save_checkpoint()
        with pytest.raises(ValueError, match="BEHIND the on-disk checkpoint"):
            ps.rollback_restore(3)
    with pytest.raises(ValueError, match="needs a ckpt_dir"):
        tps.ParameterServer(params=np.zeros(4, np.float32)).rollback_restore(0)
    with pytest.raises(ValueError, match="no checkpoint"):
        tps.ParameterServer(params=np.zeros(4, np.float32),
                            ckpt_dir=str(tmp_path / "none")).rollback_restore(0)


# ---------------------------------------------------------- the coordinator

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _pair(tmp_path, **kw):
    out = []
    for name, mod in (("jax", jco), ("port", tco)):
        clock, rec = _Clock(), _Recorder()
        c = mod.Coordinator(rec, 100, speculation=False, clock=clock,
                            manifest_dir=str(tmp_path / name), **kw)
        out.append((c, clock, rec, str(tmp_path / name)))
    return out


def _drive(pair, script):
    """``(t, sender, what, payload)``: a code is a frame, None a tick, a
    str a method call."""
    for c, clock, _rec, _d in pair:
        for t, sender, what, payload in script:
            clock.t = t
            if what is None:
                c.tick()
            elif isinstance(what, str):
                getattr(c, what)()
            else:
                c.handle(sender, what, payload)


def _same(pair, revoked=()):
    """The two coordinators' frames, events and counters, equal. ``revoked``
    lists the ``(rank, incarnation)`` lives the script revokes: the port's
    coordinator tells each one (a ``CoordLeave`` of its incarnation, so its
    worker's finish does not wait on shards that stopped counting it),
    which the JAX coordinator never does; every other frame is JAX's."""
    (jc, _, jrec, jd), (tc, _, trec, td) = pair
    leave = int(MC.CoordLeave)
    assert [f for f in trec.sent if f[1] == leave] == [
        (rank, leave, _b(stamp_epoch(tco.encode_leave(inc), tc.epoch))) for rank, inc in revoked]
    assert [f for f in trec.sent if f[1] != leave] == jrec.sent
    assert [e.replace(td, "<d>") for e in tc.events] == [e.replace(jd, "<d>")
                                                        for e in jc.events]
    for attr in ("rollbacks_done", "rollbacks_abandoned", "revoked_workers", "_roll_seq"):
        assert getattr(tc, attr) == getattr(jc, attr), attr
    assert list(tc.rollback_mttrs) == list(jc.rollback_mttrs)
    assert sorted(tc.members) == sorted(jc.members)


def _renew(t, rank, inc, **kw):
    return (t, rank, MC.LeaseRenew, tco.encode_renew(inc, **kw))


def _with_manifest():
    """A shard and a worker, one completed barrier (the watchdog's
    precondition)."""
    return [(0.0, 1, MC.CoordJoin, tco.encode_join(tco.KIND_SHARD, 3)),
            (0.0, 4, MC.CoordJoin, tco.encode_join(tco.KIND_WORKER, 5)),
            (0.0, None, "trigger_snapshot", None), (0.0, None, None, None),
            (0.0, 1, MC.SnapshotDone, tco.encode_snapshot_done(1, 1, 0, 100, 12, 12))]


def test_reputation_revokes_and_cools_down_as_jax(tmp_path):
    pair = _pair(tmp_path, lease=10.0, reputation_nacks=3, reputation_cooldown=5.0)
    J = MC.CoordJoin
    _drive(pair, [
        (0.0, 2, J, tco.encode_join(tco.KIND_WORKER, 7)),
        _renew(0.0, 2, 7, nacks=0, loss_ewma=1.0),  # the base anchors at 0
        _renew(0.1, 2, 7, nacks=2, loss_ewma=1.0),
        _renew(0.2, 2, 7, nacks=3, loss_ewma=1.0),  # revoked
        (2.0, 2, J, tco.encode_join(tco.KIND_WORKER, 8)),  # refused in the cooldown
        (2.5, 2, J, tco.encode_join(tco.KIND_WORKER, 8)),  # logged once
        (6.0, 2, J, tco.encode_join(tco.KIND_WORKER, 8)),  # admitted
        _renew(6.1, 2, 8, nacks=4, loss_ewma=1.0),  # the base re-anchors at 4
    ])
    _same(pair, revoked=[(2, 7)])
    tc = pair[1][0]
    assert 2 in tc.members and tc.revoked_workers == 1
    assert sum("refused: reputation cooldown" in e for e in tc.events) == 1


def test_watchdog_rolls_back_on_divergence_and_measures_mttr_as_jax(tmp_path):
    pair = _pair(tmp_path, lease=100.0, auto_rollback=True, rollback_cooldown=50.0,
                 rollback_timeout=20.0, rollback_loss_factor=1.5)
    _drive(pair, _with_manifest() + [
        _renew(0.5, 4, 5, loss_ewma=2.0), (1.0, None, None, None),
        _renew(1.5, 4, 5, loss_ewma=3.5), (2.0, None, None, None),  # > 1.5x best
        (2.2, 1, MC.RollbackDone, tco.encode_rollback_done(9, 1, 0, 100, 12)),  # stale
        (2.3, 1, MC.RollbackDone, tco.encode_rollback_done(1, 1, 0, 60, 12)),  # range
        (2.5, 1, MC.RollbackDone, tco.encode_rollback_done(1, 1, 0, 100, 12)),
        _renew(2.6, 4, 5, loss_ewma=3.5), (3.0, None, None, None),  # cooldown: no re-fire
    ])
    _same(pair)
    tc, _, trec, _ = pair[1]
    assert tc.rollbacks_done == 1 and tc._roll is None
    assert abs(tc.rollback_mttrs[0] - 0.5) < 1e-9
    phases = [np.frombuffer(p, np.float32)[6] for _d, code, p in trec.sent
              if code == int(MC.RollbackRequest)]
    assert phases == [0.0, 0.0, 1.0, 1.0]  # start and end, to the shard and the worker


def test_watchdog_rolls_back_on_nonfinite_losses_and_a_reborn_workers_as_jax(tmp_path):
    pair = _pair(tmp_path, lease=100.0, auto_rollback=True, rollback_cooldown=50.0,
                 rollback_timeout=20.0)
    _drive(pair, _with_manifest() + [
        _renew(0.5, 4, 5, loss_ewma=2.0), (1.0, None, None, None),
        _renew(1.5, 4, 5, loss_ewma=2.0, bad_loss=1), (2.0, None, None, None),
        (2.5, 1, MC.RollbackDone, tco.encode_rollback_done(1, 1, 0, 100, 12)),
        # a new life counts from 0: its first nonfinite report is evidence
        (60.0, 4, MC.CoordJoin, tco.encode_join(tco.KIND_WORKER, 9)),
        _renew(60.0, 4, 9, loss_ewma=2.0, bad_loss=1), (60.0, None, None, None),
    ])
    _same(pair)
    tc = pair[1][0]
    assert tc.rollbacks_done == 1 and tc._roll is not None and tc._roll["id"] == 2
    assert any("nonfinite" in e for e in tc.events)


def test_the_barrier_times_out_and_releases_as_jax(tmp_path):
    pair = _pair(tmp_path, lease=100.0, auto_rollback=True, rollback_timeout=20.0,
                 reputation_nacks=1, reputation_cooldown=100.0)
    _drive(pair, _with_manifest() + [
        # a revoked worker still gets the barrier's frames
        (0.2, 6, MC.CoordJoin, tco.encode_join(tco.KIND_WORKER, 8)),
        _renew(0.3, 6, 8, nacks=0), _renew(0.4, 6, 8, nacks=1),
        (0.5, None, "trigger_rollback", None), (1.0, None, None, None),
        (1.5, None, "trigger_rollback", None), (1.6, None, None, None),  # in flight
        (30.0, None, None, None),
    ])
    _same(pair, revoked=[(6, 8)])
    tc, _, trec, _ = pair[1]
    assert tc._roll is None and tc.rollbacks_abandoned == 1
    assert any("ABANDONED" in e for e in tc.events)
    assert sorted({d for d, code, _p in trec.sent if code == int(MC.RollbackRequest)}) == [1, 4, 6]


@pytest.mark.parametrize("why", ["no_manifest", "old_map"])
def test_a_rollback_without_a_matching_manifest_is_refused_as_jax(tmp_path, why):
    pair = _pair(tmp_path, lease=100.0, auto_rollback=True)
    if why == "old_map":
        script = _with_manifest() + [(0.1, 2, MC.CoordJoin, tco.encode_join(tco.KIND_SHARD, 6))]
    else:
        script = [(0.0, 4, MC.CoordJoin, tco.encode_join(tco.KIND_WORKER, 5))]
    script += [(1.0, None, "trigger_rollback", None), (1.0, None, None, None)]
    _drive(pair, script)
    _same(pair)
    tc = pair[1][0]
    assert tc._roll is None
    word = {"no_manifest": "no FleetManifest", "old_map": "take a fresh snapshot"}[why]
    assert any(word in e for e in tc.events), list(tc.events)


def test_fleet_view_holds_and_fails_open_as_jax():
    for view in (tmem.FleetView(), jmem.FleetView()):
        assert not view.rollback_active()
        view.note_rollback(True, ttl=0.15)
        assert view.rollback_active()
        view.note_rollback(False)
        assert not view.rollback_active()
        view.note_rollback(True, ttl=0.1)
        time.sleep(0.15)
        assert not view.rollback_active()


def test_a_rollback_request_holds_the_view_and_reaches_the_callback():
    world = InProcessTransport.create_world(2)
    seen = []
    client = tmem.CoordClient(world[1], "worker", renew_interval=60.0, rollback_hold_ttl=5.0,
                              on_rollback=lambda rid, phase: seen.append((rid, phase)))
    try:
        client._handle(MC.RollbackRequest, stamp_epoch(tco.encode_rollback_request(3, 1, 2, 0), 2))
        assert client.fleet.rollback_active() and seen == [(3, 0)]
        client._handle(MC.RollbackRequest, stamp_epoch(tco.encode_rollback_request(3, 1, 2, 1), 2))
        assert not client.fleet.rollback_active() and seen == [(3, 0), (3, 1)]
        # an older coordinator life's barrier is fenced
        client._handle(MC.RollbackRequest, stamp_epoch(tco.encode_rollback_request(4, 1, 2, 0), 1))
        assert seen == [(3, 0), (3, 1)] and client.stale_epoch_dropped == 1
        assert not client.fleet.rollback_active()
        client._handle(MC.RollbackRequest, np.full(7, np.nan, np.float32))
        assert len(seen) == 2
    finally:
        client.stop()
        for t in world.values():
            t.close()


# --------------------------------------------------------------- the shard

def _shard(tmp_path, manifest_path):
    coord_world = InProcessTransport.create_world(2)
    client = tmem.CoordClient(coord_world[1], "shard", renew_interval=60.0)
    world = InProcessTransport.create_world(2)
    srv = ElasticShardServer(server_id=1, n_params=N, transport=world[0], coord=client,
                             init_params=np.zeros(N, np.float32),
                             ckpt_dir=str(tmp_path / "s"), wal=True,
                             manifest_path=manifest_path)
    srv._apply_map(tco.ShardMap(2, N, [tco.ShardEntry(1, 0, N)]))
    return srv, client, coord_world, world


def _push(srv, v):
    srv.handle(1, MC.ShardPush, np.concatenate([
        np.asarray([2, 0, 0, 0, N, 0], np.float32), np.full(N, v, np.float32)]))


def _dones(coord_end):
    out = []
    while (msg := coord_end.recv(timeout=0.3)) is not None:
        if msg[1] == MC.RollbackDone:
            out.append(_b(msg[2]))
    return out


@pytest.mark.parametrize("manifest", ["good", "other_range", "omits_server", "missing"])
def test_the_shards_rollback_restores_in_place_or_refuses_loudly(tmp_path, manifest):
    path = str(tmp_path / tman.MANIFEST_NAME)
    srv, client, coord_world, world = _shard(tmp_path, path)
    try:
        for v in (1.0, 2.0):
            _push(srv, v)
        srv.ps.save_checkpoint()
        for v in (3.0, 4.0):
            _push(srv, v)
        srv.ps.commit()
        records = {
            "good": (tman.ShardRecord(1, 0, N, 2, 2, 2),),
            "other_range": (tman.ShardRecord(1, 0, N // 2, 2, 2, 2),
                            tman.ShardRecord(2, N // 2, N, 2, 2, 2)),
            "omits_server": (tman.ShardRecord(7, 0, N, 2, 2, 2),),
        }
        if manifest != "missing":
            tman.FleetManifest(snapshot_id=1, map_version=2, n_params=N,
                               shards=records[manifest]).write(path)
        client._handle(MC.RollbackRequest, stamp_epoch(tco.encode_rollback_request(5, 1, 2, 0), 1))
        snap, roll = srv._take_requests()
        assert snap is None and roll == 5
        srv._do_rollback(roll)  # the serve loop's call; it must never raise
        dones = _dones(coord_world[0])
        if manifest == "good":
            assert np.array_equal(srv.central, np.full(N, 3.0, np.float32))
            assert srv.ps._apply_seq == 2 and srv.stats["rollbacks"] == 1
            assert srv.stats["rolled_back_updates"] == 2
            assert dones == [_b(tco.encode_rollback_done(5, 2, 0, N, 2))]
        else:
            assert np.array_equal(srv.central, np.full(N, 10.0, np.float32))
            assert srv.ps._apply_seq == 4 and dones == []
    finally:
        client.stop()
        for w in (coord_world, world):
            for t in w.values():
                t.close()


def test_a_stopped_or_crashed_server_takes_no_late_map(tmp_path):
    """A map reaching the member's listener after the serve loop ended (a
    peer's leave rebalances the fleet) neither resizes the server nor
    writes its directory, after a clean stop or a crash."""
    for end in ("stop", "crash"):
        srv, client, coord_world, world = _shard(tmp_path / end, None)
        try:
            _push(srv, 1.0)
            getattr(srv, end)()
            files = sorted(os.listdir(tmp_path / end / "s"))
            srv._apply_map(tco.ShardMap(3, N, [tco.ShardEntry(1, 0, N // 2),
                                               tco.ShardEntry(2, N // 2, N)]))
            assert (srv.lo, srv.hi, srv.map_version) == (0, N, 2)
            assert sorted(os.listdir(tmp_path / end / "s")) == files
        finally:
            client.stop()
            for w in (coord_world, world):
                for t in w.values():
                    t.close()


def test_the_jax_shard_server_dies_on_a_manifest_that_omits_it(tmp_path):
    """The reference's fault the port's server avoids (the case above):
    JAX ``_do_rollback`` raises out of its serve loop."""
    from distributed_ml_pytorch_tpu.coord import elastic as jel
    from distributed_ml_pytorch_tpu.coord import manifest as jman
    from distributed_ml_pytorch_tpu.utils import messaging as jmsg

    path = str(tmp_path / jman.MANIFEST_NAME)
    jman.FleetManifest(snapshot_id=1, map_version=2, n_params=N,
                       shards=(jman.ShardRecord(7, 0, N, 2, 2, 2),)).write(path)
    world = jmsg.InProcessTransport.create_world(2)
    client = jmem.CoordClient(world[1], "shard", renew_interval=60.0)
    try:
        srv = jel.ElasticShardServer(server_id=1, n_params=N, transport=world[0],
                                     coord=client, ckpt_dir=str(tmp_path / "j"), wal=True,
                                     manifest_path=path)
        with pytest.raises(jman.ManifestError, match="no record for server 1"):
            srv._do_rollback(5)
    finally:
        client.stop()
        for t in world.values():
            t.close()


def test_a_parked_rollback_supersedes_a_parked_snapshot(tmp_path):
    srv, client, coord_world, world = _shard(tmp_path, None)
    try:
        srv._note_snapshot(4, 2)
        srv._note_rollback(2, 1)  # an end needs nothing
        assert srv._take_requests() == ((4, 2), None)
        srv._note_snapshot(5, 2)
        srv._note_rollback(3, 0)
        assert srv._take_requests() == (None, 3)
        assert srv._take_requests() == (None, None)
    finally:
        client.stop()
        for w in (coord_world, world):
            for t in w.values():
                t.close()


# -------------------------------------------------------------- the worker

class _FakeCoord:
    on_rollback = None

    def report(self, *a, **k):
        pass

    def report_gray_health(self, *a, **k):
        pass

    def take_shard_map(self):
        return None


def test_the_workers_barrier_drains_zeroes_in_place_pulls_and_holds():
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import ShardedAsynchronous

    worlds = [InProcessTransport.create_world(2) for _ in range(2)]
    net = get_model("lenet", seed=0, device="cpu")
    n = sum(p.numel() for p in net.parameters())
    m = tco.ShardMap(1, n, [tco.ShardEntry(1, 0, n // 2), tco.ShardEntry(2, n // 2, n)])
    coord = _FakeCoord()
    opt = ShardedAsynchronous(net, lr=0.05, n_push=4, n_pull=4,
                              transports=[w[1] for w in worlds], coord=coord,
                              transport_factory=lambda e: worlds[e.server_id - 1][1],
                              shard_map=m)
    try:
        assert coord.on_rollback == opt._note_rollback
        for w in worlds:  # the construction installs
            assert w[0].recv(timeout=1)[1] == MC.ParameterUpdate
        for p in net.parameters():
            p.grad = torch.full_like(p, 0.01)
        opt.step()
        opt.step()
        accum = opt.accum
        assert float(accum.abs().sum()) > 0
        # a stale reply already taken in must be discarded by the barrier
        worlds[0][0].send(MC.ShardParams, np.concatenate([
            np.asarray([*tps._split16(1), 0, 0, *tps._split16(n // 2)], np.float32),
            np.full(n // 2, 9.0, np.float32)]), dst=1)
        time.sleep(0.2)
        for w in worlds:
            while w[0].recv(timeout=0.1) is not None:
                pass
        opt._note_rollback(1, 1)  # an end is not a start
        opt._note_rollback(1, 0)
        opt.step()
        assert opt.rollbacks_seen == 1 and opt.accum is accum
        assert opt._hold_updates
        pulls = [w[0].recv(timeout=1) for w in worlds]
        assert [p[1] for p in pulls] == [MC.ParameterRequest] * 2
        flat_before = torch.cat([p.detach().flatten() for p in net.parameters()])
        assert not bool((flat_before == 9.0).any())  # the stale reply never installed
        held_steps = opt.skipped_updates
        # every shard's restored slice arrives: one more held step, then updates
        for s, (lo, hi) in enumerate(m.ranges):
            worlds[s][0].send(MC.ShardParams, np.concatenate([
                np.asarray([*tps._split16(1), *tps._split16(lo), *tps._split16(hi)],
                           np.float32), np.zeros(hi - lo, np.float32)]), dst=1)
        time.sleep(0.3)
        opt.step()
        assert opt.skipped_updates == held_steps + 1 and not opt._hold_updates
        opt.step()
        assert opt.skipped_updates == held_steps + 1
    finally:
        opt._flusher.stop()
        for listener in opt.listeners:
            listener.stop()
        for w in worlds:
            for t in w.values():
                t.close()


def test_observe_loss_counts_nonfinite_and_folds_finite():
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import ShardedAsynchronous

    world = InProcessTransport.create_world(2)
    opt = ShardedAsynchronous(get_model("lenet", seed=0, device="cpu"), lr=0.05, n_push=2,
                              n_pull=2, transports=[world[1]])
    try:
        opt.observe_loss(float("nan"))
        opt.observe_loss(2.0)
        assert opt.bad_losses == 1 and opt._loss_ewma.value == 2.0
    finally:
        opt._flusher.stop()
        for listener in opt.listeners:
            listener.stop()
        for t in world.values():
            t.close()
