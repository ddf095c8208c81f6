"""The port's durable coordinator (``coord/coordinator.py`` with
``durable_dir``) against the JAX package's.

- Byte-equal durable state: both packages' coordinators, driven by one
  frame script under a fake clock (joins, renewals, a leave, a lease
  expiry, a snapshot barrier, a watchdog rollback, a reputation revoke,
  checkpoints every few records), leave the same ``coord_epoch``,
  ``coord_ckpt.json`` and ``coord.wal`` bytes, send the same frames and log
  the same events.
- Restarts: each new life bumps the epoch (written before its first
  frame), replays checkpoint and log (records past the checkpoint on top of
  it, once), and stamps its frames with the new epoch; a JAX life followed
  by a port life over one directory, and the reverse, restore what a
  same-package restart restores.
- The grace window: a restart holds lease expiry until the members
  re-attach (closing early when all have) or the window ends; a first life
  has none.
- The fence: a member drops a stale epoch's ``RollbackRequest`` and
  ``SnapshotRequest``.

The park table's records and restarts are ``tests/test_torch_sched.py``'s.
"""

import json
import os

import numpy as np
import pytest

from distributed_ml_pytorch_tpu.coord import coordinator as jco
from distributed_ml_pytorch_tpu_torch.coord import coordinator as tco
from distributed_ml_pytorch_tpu_torch.coord import member as tmem
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    InProcessTransport,
    stamp_epoch,
    strip_epoch,
)
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode as MC

J, R, L = MC.CoordJoin, MC.LeaseRenew, MC.CoordLeave
FILES = (tco.COORD_EPOCH_NAME, tco.COORD_CKPT_NAME, tco.COORD_WAL_NAME)


def _b(a):
    return np.asarray(a, np.float32).tobytes()


class _Recorder:
    rank = 0

    def __init__(self):
        self.sent = []

    def send(self, code, payload, dst=0):
        self.sent.append((dst, int(code), _b(payload)))

    def recv(self, timeout=None):
        return None


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _coord(mod, d, clock, rec=None, **kw):
    kw.setdefault("lease", 2.0)
    return mod.Coordinator(rec if rec is not None else _Recorder(), 1000, speculation=False,
                           clock=clock, durable_dir=str(d / "coord"),
                           manifest_dir=str(d), **kw)


def _drive(c, clock, script):
    for t, sender, what, payload in script:
        clock.t = t
        if what is None:
            c.tick()
        elif isinstance(what, str):
            getattr(c, what)()
        else:
            c.handle(sender, what, payload)


def _history():
    join, renew = tco.encode_join, tco.encode_renew
    s = [(0.0, 1, J, join(1, 101)), (0.0, 2, J, join(1, 102)), (0.1, 3, J, join(0, 103)),
         (0.1, 4, J, join(0, 104)), (0.2, 5, J, join(0, 105)), (0.3, None, None, None)]
    for t in (0.5, 1.0, 1.5):
        s += [(t, r, R, renew(100 + r, 1, 1, 5.0, loss_ewma=2.0)) for r in (1, 2, 3, 4)]
        s.append((t, None, None, None))
    s += [(1.6, None, "trigger_snapshot", None), (1.6, None, None, None),
          (1.7, 1, MC.SnapshotDone, tco.encode_snapshot_done(1, 2, 0, 500, 4, 4)),
          (1.7, 2, MC.SnapshotDone, tco.encode_snapshot_done(1, 2, 500, 1000, 3, 3)),
          (2.0, 5, L, tco.encode_leave(105)),
          (2.1, 4, R, renew(104, 2, 2, 5.0, nacks=0)), (2.2, 4, R, renew(104, 2, 2, 5.0, nacks=2)),
          (2.3, 3, R, renew(103, 2, 2, 5.0, loss_ewma=9.0)), (2.3, None, None, None),
          (2.4, 1, MC.RollbackDone, tco.encode_rollback_done(1, 2, 0, 500, 4)),
          (2.4, 2, MC.RollbackDone, tco.encode_rollback_done(1, 2, 500, 1000, 3))]
    # shard 2 falls silent: its lease expires and the map moves
    s += [(t, r, R, renew(100 + r, 3, 3, 5.0)) for t in (2.6, 3.2, 3.8) for r in (1, 3)]
    s += [(4.2, None, None, None), (4.3, 6, J, join(1, 106)), (4.4, None, None, None)]
    return s


def _run(mod, d, script=None, **kw):
    clock, rec = _Clock(), _Recorder()
    c = _coord(mod, d, clock, rec, auto_rollback=True, rollback_loss_factor=2.0,
               reputation_nacks=2, ckpt_every=5, **kw)
    _drive(c, clock, _history() if script is None else script)
    return c, rec


def test_durable_files_and_frames_equal_jax_byte_for_byte(tmp_path):
    (jc, jrec), (tc, trec) = _run(jco, tmp_path / "jax"), _run(tco, tmp_path / "port")
    # the port tells the revoked life (worker 4, incarnation 104) with a
    # CoordLeave, which the JAX coordinator never sends; every other frame
    # is JAX's
    leave = int(L)
    assert [f for f in trec.sent if f[1] == leave] == [
        (4, leave, _b(stamp_epoch(tco.encode_leave(104), 1)))]
    assert [f for f in trec.sent if f[1] != leave] == jrec.sent
    norm = [str(tmp_path / "jax"), str(tmp_path / "port")]
    assert ([e.replace(norm[1], "<d>") for e in tc.events]
            == [e.replace(norm[0], "<d>") for e in jc.events])
    assert tc.revoked_workers == 1 and tc.rollbacks_done == 1 and tc.manifests_written == 1
    assert any("lease expired" in e for e in tc.events)
    for name in FILES:
        mine = (tmp_path / "port" / "coord" / name).read_bytes()
        assert mine == (tmp_path / "jax" / "coord" / name).read_bytes(), name
    # the checkpoint is sorted JSON with nothing parked and no scheduler
    state = json.loads((tmp_path / "port" / "coord" / tco.COORD_CKPT_NAME).read_bytes())
    assert state["parked"] == {} and state["sched"] is None and state["epoch"] == 1
    tc.checkpoint()
    jc.checkpoint()
    for name in FILES:
        assert ((tmp_path / "port" / "coord" / name).read_bytes()
                == (tmp_path / "jax" / "coord" / name).read_bytes()), name


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax"),
                                          ("port", "port")])
def test_a_second_life_restores_what_the_first_left_across_packages(tmp_path, first, second):
    """The first life's records past its last checkpoint replay on top of
    it; the second life, in either package, restores the same members,
    map, clocks and epoch as a JAX second life over a copy of the files."""
    mods = {"jax": jco, "port": tco}
    lives = []
    for d in (tmp_path / "a", tmp_path / "ref"):
        c1, _rec = _run(mods[first], d)
        assert c1._wal_seq > c1._ckpt_seq  # records past the checkpoint
        clock = _Clock(10.0)
        c2 = _coord(mods[second] if d.name == "a" else jco, d, clock)
        lives.append(c2)
    c2, ref = lives
    assert c2.epoch == ref.epoch == 2
    assert sorted((m.rank, m.kind, m.incarnation) for m in c2.members.values()) == sorted(
        (m.rank, m.kind, m.incarnation) for m in ref.members.values())
    assert c2.shard_map.encode().tobytes() == ref.shard_map.encode().tobytes()
    assert (c2._snap_seq, c2._roll_seq, c2._next_task, c2._wal_seq) == (
        ref._snap_seq, ref._roll_seq, ref._next_task, ref._wal_seq)
    assert c2.restored_members == ref.restored_members == 3
    assert c2.last_manifest is not None and c2.last_manifest.snapshot_id == 1
    assert [e.replace(str(tmp_path / "a"), "<d>") for e in c2.events] == [
        e.replace(str(tmp_path / "ref"), "<d>") for e in ref.events]


def test_the_epoch_is_durable_before_the_first_frame_and_stamps_every_frame(tmp_path):
    seen = []

    class _Checking(_Recorder):
        def send(self, code, payload, dst=0):
            seen.append(int((tmp_path / "coord" / tco.COORD_EPOCH_NAME).read_text()))
            super().send(code, payload, dst)

    for life in (1, 2, 3):
        rec = _Checking()
        c = _coord(tco, tmp_path, _Clock(), rec)
        c.handle(life, J, tco.encode_join(tco.KIND_WORKER, life))
        assert c.epoch == life and seen[-1] == life
        epochs = {strip_epoch(np.frombuffer(p, np.float32))[1] for _d, _c, p in rec.sent}
        assert epochs == {life}


def test_records_after_a_checkpoint_replay_on_top_of_it_once(tmp_path):
    clock = _Clock()
    c = _coord(tco, tmp_path, clock)
    for rank in (1, 2):
        c.handle(rank, J, tco.encode_join(tco.KIND_SHARD, rank))
    c.checkpoint()
    c.handle(2, L, tco.encode_leave(2))  # only in the log
    c2 = _coord(tco, tmp_path, clock)
    assert set(c2.members) == {1} and c2.shard_map.version == 3
    assert c2._wal_seq == c._wal_seq
    c3 = _coord(tco, tmp_path, clock)  # replay is idempotent
    assert set(c3.members) == {1} and c3.shard_map.version == 3 and c3.epoch == 3


def test_a_first_life_has_no_grace_window(tmp_path):
    clock = _Clock()
    c = _coord(tco, tmp_path, clock)
    assert c.restored_members == 0 and c._grace_until == 0.0
    c.handle(1, J, tco.encode_join(tco.KIND_SHARD, 1))
    clock.t = 50.0
    c.tick()
    assert 1 not in c.members


@pytest.mark.parametrize("mod", [jco, tco], ids=["jax", "port"])
def test_the_grace_window_holds_expiry_until_reattach(tmp_path, mod):
    clock = _Clock()
    c = _coord(mod, tmp_path, clock)
    for rank in (1, 2):
        c.handle(rank, J, tco.encode_join(tco.KIND_SHARD, rank))
    c2 = _coord(mod, tmp_path, clock, grace=10.0)
    clock.t = 5.0  # past every lease, inside the window
    c2.tick()
    assert set(c2.members) == {1, 2}
    c2.handle(1, J, tco.encode_join(tco.KIND_SHARD, 1))  # rank 1 re-attaches
    clock.t = 11.0
    c2.handle(1, R, tco.encode_renew(1))
    clock.t = 12.0  # the window is over: rank 2 expires
    c2.tick()
    assert set(c2.members) == {1}
    assert any("grace window over; still silent: [2]" in e for e in c2.events)


@pytest.mark.parametrize("mod", [jco, tco], ids=["jax", "port"])
def test_the_grace_window_closes_early_once_everyone_is_back(tmp_path, mod):
    clock = _Clock()
    c = _coord(mod, tmp_path, clock)
    for rank in (1, 2):
        c.handle(rank, J, tco.encode_join(tco.KIND_SHARD, rank))
    c2 = _coord(mod, tmp_path, clock)  # grace = one lease
    assert c2._grace_until == 2.0 and c2._grace_pending == {1, 2}
    for rank in (1, 2):
        c2.handle(rank, R, tco.encode_renew(rank))
    clock.t = 0.5
    c2.tick()
    assert c2._grace_until == 0.0
    assert any("closed early" in e for e in c2.events)


@pytest.mark.parametrize("code", [MC.RollbackRequest, MC.SnapshotRequest])
def test_a_stale_epochs_barrier_is_dropped_on_the_wire(code):
    world = InProcessTransport.create_world(2)
    seen = []
    client = tmem.CoordClient(world[1], "shard", renew_interval=60.0,
                              on_rollback=lambda *a: seen.append(("roll", a)),
                              on_snapshot=lambda *a: seen.append(("snap", a)))
    try:
        frame = (tco.encode_rollback_request(1, 1, 1, 0) if code == MC.RollbackRequest
                 else tco.encode_snapshot_request(1, 1))
        client._handle(code, stamp_epoch(frame, 3))  # the new life speaks
        client._handle(code, stamp_epoch(frame, 2))  # the zombie
        assert len(seen) == 1 and client.stale_epoch_dropped == 1 and client.coord_epoch == 3
        assert client.fleet.rollback_active() == (code == MC.RollbackRequest)
    finally:
        client.stop()
        for t in world.values():
            t.close()


def test_the_log_record_layout_is_the_jax_one():
    for op in ({"op": "join", "rank": 3, "kind": 0, "inc": 77}, {"op": "snap", "id": 12},
               {"op": "map", "version": 2, "n_params": 9, "entries": [[1, 0, 9, 0, 9]]}):
        assert _b(tco._op_to_f32(op)) == _b(jco._op_to_f32(op))
        assert tco._f32_to_op(jco._op_to_f32(op)) == op
    assert os.path.basename(tco.COORD_WAL_NAME) == jco.COORD_WAL_NAME
