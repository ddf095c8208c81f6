"""The port's coordinator plane (``coord/shardmap.py``, ``coord/coordinator.py``,
``coord/member.py``, ``coord/cli.py``) against the JAX package's.

- Shard maps and frames: ``ShardMap.encode`` bytes, ``decode`` and
  ``rebalance`` over a seeded sequence of live sets; ``encode_join``,
  ``encode_leave``, ``encode_renew`` at every tail length,
  ``encode_fleet``/``decode_fleet`` and the epoch fence, equal in both.
- The scripted coordinator: both packages' ``Coordinator`` driven by one
  ``(time, sender, code, payload)`` script through a recording transport
  and a fake clock — two shard joins, three worker joins, renewals with
  progress, open circuits, a straggler and its speculation, a missed
  lease, a leave, stale joins and leaves, a same-rank rejoin of a newer
  life, an idempotent re-join, the five-field and the gray-tailed renewals
  — send the same frames (destination, code and bytes, the fence trailer
  included), log the same ``events`` lines and end on the same map.
- The member: the same coordinator frames through both ``CoordClient``s
  give the same map, fleet view, speculation call and epoch-fence counts.
- Cross-package TCP worlds: a JAX coordinator with the port's members and
  the reverse adopt the same maps, and rebalance when a shard member dies.
- Refusals: unknown options and flags are refused, never ignored. The
  MPMD stage plane's callback, frames and ``--mpmd`` flag and the metrics
  dump are handled (they were refused, and the frames dropped and
  counted, before their planes were ported).
"""

import threading
import time

import numpy as np
import pytest

from distributed_ml_pytorch_tpu.coord import coordinator as jco
from distributed_ml_pytorch_tpu.coord import member as jmem
from distributed_ml_pytorch_tpu.coord import shardmap as jsm
from distributed_ml_pytorch_tpu.utils import messaging as jmsg
from distributed_ml_pytorch_tpu_torch.coord import cli as tcli
from distributed_ml_pytorch_tpu_torch.coord import coordinator as tco
from distributed_ml_pytorch_tpu_torch.coord import member as tmem
from distributed_ml_pytorch_tpu_torch.coord import shardmap as tsm
from distributed_ml_pytorch_tpu_torch.launch import _free_port
from distributed_ml_pytorch_tpu_torch.training import cli as ttcli
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode as MC


def _b(a):
    return np.asarray(a, np.float32).tobytes()


# ------------------------------------------------------------ maps and frames

def test_shard_maps_encode_decode_and_rebalance_as_jax():
    rng = np.random.default_rng(0)
    mine, ref = tsm.ShardMap(0, 2_472_266), jsm.ShardMap(0, 2_472_266)
    for _ in range(40):
        live = sorted(set(int(i) for i in rng.integers(1, 9, int(rng.integers(0, 6)))))
        mine, ref = tsm.rebalance(mine, live), jsm.rebalance(ref, live)
        assert _b(mine.encode()) == _b(ref.encode())
        back = tsm.ShardMap.decode(ref.encode())
        assert (back.version, back.n_params, back.ranges) == (ref.version, ref.n_params,
                                                              ref.ranges)
        assert [(e.fresh_lo, e.fresh_hi, e.needs_install) for e in mine.entries] == [
            (e.fresh_lo, e.fresh_hi, e.needs_install) for e in ref.entries]
        for sid in live[:1]:
            assert mine.entry_for(sid).size == ref.entry_for(sid).size
    for bad in (np.zeros(3, np.float32), np.asarray([2, 1, 0, 100, 0], np.float32),
                np.asarray([np.nan] * 5, np.float32)):
        for mod in (tsm, jsm):
            with pytest.raises(ValueError):
                mod.ShardMap.decode(bad)


RENEWS = [
    dict(),
    dict(push_count=3, step=12, ewma_ms=41.5),
    dict(push_count=3, step=12, ewma_ms=41.5, wire_open=2),
    dict(push_count=3, step=12, ewma_ms=41.5, wire_open=1, nacks=4, bad_loss=1,
         loss_ewma=2.25, gnorm_ewma=float("inf")),
    dict(push_count=9, step=40, ewma_ms=9.0, retrans_rate=0.1, nack_rate=float("nan"),
         blocked_s=0.5, fsync_p95_ms=3.0, busy_ratio=0.7, links=((1, 0.5, 0.25), (2, 0.0, 1e40))),
]


@pytest.mark.parametrize("kw", RENEWS)
def test_member_frames_equal_jax(kw):
    inc = 1_792_000_123
    assert _b(tco.encode_renew(inc, **kw)) == _b(jco.encode_renew(inc, **kw))
    assert _b(tco.encode_join(tco.KIND_SHARD, inc)) == _b(jco.encode_join(jco.KIND_SHARD, inc))
    assert _b(tco.encode_leave(inc)) == _b(jco.encode_leave(inc))


@pytest.mark.parametrize("ranks,metrics", [((), ()), ((3, 7), ()), ((), (5.0, 12.5, 1, 0)),
                                           ((4,), (9.0, 1.5, 0, 2, 1))])
def test_fleet_frames_and_the_epoch_fence_equal_jax(ranks, metrics):
    args = (70000, 3, 2, len(ranks), True, ranks, metrics)
    frame = tco.encode_fleet(*args)
    assert _b(frame) == _b(jco.encode_fleet(*args))
    assert tco.decode_fleet(frame) == jco.decode_fleet(frame)
    stamped = tmsg.stamp_epoch(frame, 70001)
    assert _b(stamped) == _b(jmsg.stamp_epoch(frame, 70001))
    for strip in (tmsg.strip_epoch, jmsg.strip_epoch):
        body, epoch = strip(stamped)
        assert _b(body) == _b(frame) and epoch == 70001
        assert strip(frame)[1] is None
    assert tco.FLEET_METRICS_FIELDS == jco.FLEET_METRICS_FIELDS
    assert (tco.FLEET_TAIL_SEPARATOR, tmsg.FENCE_SEPARATOR, tmsg.FENCE_MAGIC) == (
        jco.FLEET_TAIL_SEPARATOR, jmsg.FENCE_SEPARATOR, jmsg.FENCE_MAGIC)


# ------------------------------------------------------------ the scripted coordinator

class _Recorder:
    """A coordinator transport that records every frame sent."""

    rank = 0

    def __init__(self):
        self.sent = []

    def send(self, code, payload, dst=0):
        self.sent.append((dst, int(code), _b(payload)))

    def recv(self, timeout=None):
        return None


def _script():
    """``(time, sender, code, payload)`` items; ``code`` None is a tick."""
    J, R, L = MC.CoordJoin, MC.LeaseRenew, MC.CoordLeave
    join, renew, leave = tco.encode_join, tco.encode_renew, tco.encode_leave
    s = [(0.0, 1, J, join(1, 100)), (0.1, 2, J, join(1, 101)),
         (0.2, 3, J, join(0, 200)), (0.3, 4, J, join(0, 201)), (0.35, 5, J, join(0, 202)),
         (0.36, 6, J, np.asarray([0, np.nan, 1], np.float32)),
         (0.4, None, None, None)]
    for t in (0.5, 1.1):
        s += [(t, 1, R, renew(100, 7, 0, 0.0)[:5]), (t, 2, R, renew(101, 7, 0, 0.0)),
              (t, 3, R, renew(200, 1, 3, 10.0)), (t, 4, R, renew(201, 1, 3, 11.0, wire_open=2)),
              (t, 5, R, renew(202, 1, 3, 40.0, nacks=1, loss_ewma=2.5))]
        s.append((t + 0.05, None, None, None))  # the straggler fires once
    s += [(1.2, 4, R, renew(201, 2, 5, 11.0, wire_open=0)),
          (1.3, 9, R, renew(900, 1, 1, 1.0)),  # an unknown rank's chatter
          (1.4, 3, R, renew(199, 9, 9, 9.0)),  # an older life's heartbeat
          (1.6, 1, R, renew(100, 8, 0, 0.0)), (1.6, 3, R, renew(200, 2, 6, 10.0)),
          (1.6, 4, R, renew(201, 2, 6, 12.0)), (1.6, 5, R, renew(202, 2, 4, 45.0)),
          # shard 2 missed its lease (silent since 1.1)
          (2.2, None, None, None),
          (2.3, 4, L, leave(201)), (2.4, 3, L, leave(199)),
          (2.5, 5, J, join(0, 300)), (2.55, 5, J, join(0, 250)), (2.6, 3, J, join(0, 200)),
          (2.7, 3, R, renew(200, 3, 9, 10.0)[:5]),
          (2.8, 5, R, renew(300, 0, 1, 5.0, retrans_rate=0.2, blocked_s=0.1,
                            links=((1, 0.5, 0.0),))),
          (2.9, 1, R, renew(100, 9, 0, 0.0)),
          (2.95, 2, J, join(1, 400)),  # shard 2 comes back as a new life
          (3.0, None, None, None), (3.1, 3, MC.Heartbeat, np.zeros(0, np.float32)),
          (3.2, 3, L, leave(200)), (3.3, 5, L, leave(300)), (3.4, None, None, None)]
    return s


def _drive(mod, script, **kw):
    clock = [0.0]
    transport = _Recorder()
    coord = mod.Coordinator(transport, 1000, lease=1.0, straggler_factor=3.0,
                            straggler_after_steps=2, clock=lambda: clock[0], **kw)
    for t, sender, code, payload in script:
        clock[0] = t
        if code is None:
            coord.tick()
        else:
            code = jmsg.MessageCode(int(code)) if mod is jco else code
            coord.handle(sender, code, payload)
    return coord, transport.sent


def test_scripted_coordinator_equals_jax_frame_for_frame():
    mine, mine_sent = _drive(tco, _script())
    ref, ref_sent = _drive(jco, _script())
    assert mine_sent == ref_sent
    assert list(mine.events) == list(ref.events)
    assert _b(mine.shard_map.encode()) == _b(ref.shard_map.encode())
    assert mine.fleet_state() == ref.fleet_state()
    assert mine.wire_health() == ref.wire_health()
    assert mine.speculated == ref.speculated and mine.done_workers == ref.done_workers
    # the script covers what it claims to
    text = "\n".join(mine.events)
    for needle in ("shard 2 lease expired", "straggler: worker 5", "ignored stale leave",
                   "ignored stale join", "worker 5 rejoined", "open circuit",
                   "wire healthy again", "worker 4 left", "shard map v4"):
        assert needle in text, needle
    assert all(f[2][-16:-8] == _b([tmsg.FENCE_SEPARATOR, tmsg.FENCE_MAGIC])
               for f in mine_sent)
    spec = [f for f in mine_sent if f[1] == int(MC.SpeculateTask)]
    assert [f[0] for f in spec] == [3, 5]


def test_speculate_victim_and_engines_equal_jax():
    script = _script()[:13] + [(0.6, 7, MC.CoordJoin, tco.encode_join(tco.KIND_ENGINE, 700))]
    mine, _ = _drive(tco, script)
    ref, _ = _drive(jco, script)
    assert mine.speculate_victim(4) == ref.speculate_victim(4)
    assert mine.speculate_victim(1) is ref.speculate_victim(1) is None
    assert list(mine.events) == list(ref.events)
    assert mine.engine_up() == ref.engine_up() is True
    assert mine.live_engine_ranks() == ref.live_engine_ranks() == {7}
    assert mine.check_stragglers() == ref.check_stragglers()


# ------------------------------------------------------------ the member

class _Quiet:
    rank = 3

    def __init__(self):
        self.sent = []

    def send(self, code, payload, dst=0):
        self.sent.append((int(code), _b(payload)))

    def recv(self, timeout=None):
        time.sleep(min(timeout or 0.0, 0.01))
        return None

    def close(self):
        pass


def test_member_handles_coordinator_frames_as_jax():
    m1 = tsm.rebalance(tsm.ShardMap(0, 100), [1, 2])
    m2 = tsm.rebalance(m1, [1])
    frames = [(MC.ShardMapUpdate, tmsg.stamp_epoch(m1.encode(), 1)),
              (MC.FleetState, tmsg.stamp_epoch(tco.encode_fleet(1, 2, 2, 0, False), 1)),
              (MC.ShardMapUpdate, tmsg.stamp_epoch(m2.encode(), 2)),
              (MC.ShardMapUpdate, tmsg.stamp_epoch(m1.encode(), 2)),  # a stale rebroadcast
              (MC.SpeculateTask, tmsg.stamp_epoch(np.asarray([4, 5, 6], np.float32), 1)),
              (MC.SpeculateTask, np.asarray([7, 5, 6], np.float32)),  # unfenced
              (MC.FleetState, tco.encode_fleet(2, 1, 1, 0, True, (), (3.0, 1.0, 0, 0))),
              (MC.ShardMapUpdate, np.asarray([3.0], np.float32))]  # malformed
    out = {}
    for name, mod in (("port", tmem), ("jax", jmem)):
        calls = []
        client = mod.CoordClient(_Quiet(), "worker", renew_interval=60.0, incarnation=77,
                                 on_speculate=lambda *a, calls=calls: calls.append(a))
        for code, payload in frames:
            code = jmsg.MessageCode(int(code)) if mod is jmem else code
            try:
                client._handle(code, payload)
            except ValueError:
                calls.append("malformed")
        client.stop()
        m = client.current_map()
        taken = client.take_shard_map()
        out[name] = (_b(m.encode()), client.fleet.state, client.fleet.workers_done(),
                     client.fleet.engine_up(), client.fleet.fleet_metrics(), calls,
                     client.stale_epoch_dropped, client.coord_epoch, taken is m,
                     client.take_shard_map(), client.fleet.live_engine_ranks())
    assert out["port"] == out["jax"]
    assert out["port"][6] == 1  # the epoch-1 speculation after epoch 2


def test_member_join_renew_and_leave_frames_equal_jax():
    sent = {}
    for name, mod in (("port", tmem), ("jax", jmem)):
        t = _Quiet()
        client = mod.CoordClient(t, "shard", renew_interval=0.05, incarnation=1234)
        client.report(5, 11, 3.5, wire_open=1, nacks=2, bad_loss=0, loss_ewma=1.5,
                      gnorm_ewma=0.25)
        client.report_gray_health(retrans_rate=0.1, links=((2, 0.5, 0.0),))
        assert client.join(timeout=0.2) is None
        time.sleep(0.5)
        client.close()
        sent[name] = t.sent
    first = {name: [f for f in s if f[0] == int(MC.CoordJoin)][0] for name, s in sent.items()}
    renews = {name: {f for f in s if f[0] == int(MC.LeaseRenew)} for name, s in sent.items()}
    assert first["port"] == first["jax"]
    assert renews["port"] == renews["jax"] and len(renews["port"]) == 1
    assert sent["port"][-1] == sent["jax"][-1] == (int(MC.CoordLeave),
                                                   _b(tco.encode_leave(1234)))


# ------------------------------------------------------------ cross-package TCP worlds

def _tcp_world(coord_mod, coord_msg, member_mod, member_msg):
    """A coordinator of one package over its TCP hub and two shard members
    and a worker of the other; shard 2 dies (its client stops renewing).
    Returns the coordinator's maps seen by the survivor and the worker."""
    port = int(_free_port())
    hub = coord_msg.TCPTransport(rank=0, world_size=16, port=port, wait_for=0)
    coord = coord_mod.Coordinator(hub, 1000, lease=0.8, speculation=False)
    th = threading.Thread(target=coord.run, kwargs={"timeout": 30}, daemon=True)
    th.start()
    links, clients = [], {}
    try:
        for rank, kind in ((1, "shard"), (2, "shard"), (3, "worker")):
            t = member_msg.TCPTransport(rank=rank, world_size=16, port=port)
            links.append(t)
            clients[rank] = member_mod.CoordClient(t, kind, renew_interval=0.1)
            assert clients[rank].join(timeout=10) is not None
        deadline = time.monotonic() + 10
        while coord.shard_map.version < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)
        v2 = [_b(clients[r].current_map().encode()) for r in (1, 2, 3)]
        assert v2 == [_b(coord.shard_map.encode())] * 3 and coord.shard_map.version == 2
        clients[2].stop()  # silent: no leave
        deadline = time.monotonic() + 10
        while coord.shard_map.version < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)
        final = _b(coord.shard_map.encode())
        seen = [_b(clients[r].current_map().encode()) for r in (1, 3)]
        events = list(coord.events)
        ranges = coord.shard_map.ranges
        for r in (1, 3):
            clients[r].close()
    finally:
        coord.stop()
        th.join(timeout=10)
        for t in links:
            t.close()
        hub.close()
    return final, seen, events, ranges


@pytest.mark.parametrize("coordinator", ["jax", "port"])
def test_cross_package_tcp_world_adopts_the_same_maps(coordinator):
    if coordinator == "jax":
        final, seen, events, ranges = _tcp_world(jco, jmsg, tmem, tmsg)
    else:
        final, seen, events, ranges = _tcp_world(tco, tmsg, jmem, jmsg)
    assert seen == [final, final]
    assert ranges == [(0, 1000)]
    assert any("shard 2 lease expired" in e for e in events), events
    assert any(e.startswith("shard map v3 on lease expiry") for e in events), events


# ------------------------------------------------------------ refusals

def test_later_plane_attachments_callbacks_and_frames_are_refused():
    """The stage plane's client callback and codes, once refused and
    dropped, are handled: ``on_stage_assign`` is an option and an
    attribute, a ``StageAssign`` reaches it (a stale one does not), and the
    base coordinator takes a stage frame as any other frame of a known
    member, as the JAX one does. Unknown options still raise."""
    from distributed_ml_pytorch_tpu_torch.coord import stages as tst

    coord = tco.Coordinator(None, 10)
    with pytest.raises(TypeError):
        tco.Coordinator(None, 10, no_such_option=1)
    with pytest.raises(TypeError):
        tmem.CoordClient(_Quiet(), "worker", no_such_option=print)
    seen = []
    client = tmem.CoordClient(_Quiet(), "stage", renew_interval=60.0,
                              on_stage_assign=seen.append)
    try:
        assert client.on_stage_assign is not None and client.current_placement() is None
        placement = tst.StagePlacement(2, 10, [tst.StageEntry(0, rank=3, inc=7, hi=10)])
        client._handle(MC.StageAssign, tmsg.stamp_epoch(placement.encode(), 1))
        stale = tst.StagePlacement(1, 10, [tst.StageEntry(0)])
        client._handle(MC.StageAssign, tmsg.stamp_epoch(stale.encode(), 1))
        assert [p.version for p in seen] == [2] and client.current_placement() == placement
        client.on_stage_assign = None
        assert client.on_stage_assign is None
        client.stage_ready(0, 12)
        code, payload = client.transport.sent[-1]
        assert code == int(MC.StageReady) and payload == _b(
            tst.encode_stage_ready(0, client.incarnation, 12))
    finally:
        client.stop()
    coord.handle(1, MC.CoordJoin, tco.encode_join(tco.KIND_SHARD, 5))
    before = list(coord.events)
    ref = jco.Coordinator(None, 10)
    ref.handle(1, MC.CoordJoin, jco.encode_join(jco.KIND_SHARD, 5))
    for code in (MC.StageReady, MC.StageAssign, MC.ActivationGrad):
        coord.handle(1, code, np.zeros(12, np.float32))
        ref.handle(1, code, np.zeros(12, np.float32))
    assert list(coord.events) == before and list(ref.events) == before
    assert not hasattr(coord, "later_plane_dropped")


@pytest.mark.parametrize("flags", [["--mpmd", "--metrics-dump", "-"], ["--metrics-dump", "-"]])
def test_a_later_planes_coordinator_flag_is_rejected(flags):
    """``--metrics-dump``, rejected until the observability plane was
    ported, parses beside the scenario flags; an unknown flag is still
    rejected."""
    args = tcli.build_parser().parse_args(flags)
    assert args.metrics_dump == "-" and args.mpmd == ("--mpmd" in flags)
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(flags + ["--no-such-flag"])


@pytest.mark.parametrize("flags", [["--metrics-dump", "-"]])
def test_a_later_planes_training_flag_is_rejected(flags):
    """The training CLI's ``--metrics-dump`` parses beside ``--coord``."""
    args = ttcli.build_parser().parse_args(flags + ["--coord", "localhost:1"])
    assert (args.metrics_dump, args.coord) == ("-", "localhost:1")


def test_coordinator_flags_take_the_jax_names_and_defaults():
    from distributed_ml_pytorch_tpu.coord import cli as jcli

    mine = {a.dest: a for a in tcli.build_parser()._actions}
    ref = {a.dest: a for a in jcli.build_parser()._actions}
    for dest in ("port", "master", "max_members", "n_params", "lease", "straggler_factor",
                 "no_speculation", "timeout", "demo", "seed", "drill", "health", "sched_demo",
                 "auto_rollback",
                 "rollback_loss_factor", "reputation_nacks", "manifest_dir",
                 "snapshot_interval"):
        assert mine[dest].option_strings == ref[dest].option_strings, dest
        assert mine[dest].default == ref[dest].default, dest
    assert mine["model"].default == ref["model"].default
    args = ttcli.build_parser().parse_args(["--coord", "localhost:5"])
    assert args.coord == "localhost:5"
