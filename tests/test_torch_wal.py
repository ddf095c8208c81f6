"""The port's durability plane against the JAX package's
(``tests/test_wal.py``, mirrored): ``atomic_write``, the write-ahead log and
the parameter server's checkpoint/log handshake.

- a log record's bytes are equal in the two packages for the same inputs,
  and each package replays the other's log;
- the recovery matrix: a torn tail is tolerated, a WAL1 log is refused, a
  corrupt record mid-log raises, a dead life's stale records are skipped,
  committed updates replay without a checkpoint, replay is idempotent when
  a checkpoint raced the truncation, the tear window between the two
  renames restores the previous generation and the log replays the gap, a
  vector matching neither generation raises, ``wal`` needs a ``ckpt_dir``,
  and a wrong-size push is dropped before the log and the clock;
- a checkpoint directory (vector, meta, log) written by either package's
  server restores in the other's with the central vector, ``version``,
  ``push_count``, ``apply_seq`` and ``applied_by_sender`` bit for bit.
"""

import io
import os
import shutil
import struct
import zlib

import numpy as np
import pytest

from distributed_ml_pytorch_tpu.parallel.async_ps import ParameterServer as JServer
from distributed_ml_pytorch_tpu.utils import wal as jwal
from distributed_ml_pytorch_tpu_torch.parallel import async_ps as tps
from distributed_ml_pytorch_tpu_torch.parallel.async_ps import ParameterServer
from distributed_ml_pytorch_tpu_torch.utils import wal as twal
from distributed_ml_pytorch_tpu_torch.utils.durability import atomic_write
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

GU = MessageCode.GradientUpdate


def test_atomic_write_replaces_durably(tmp_path, monkeypatch):
    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (synced.append(fd), real_fsync(fd))[1])
    path = str(tmp_path / "state.bin")
    atomic_write(path, b"generation-1")
    atomic_write(path, b"generation-2")
    with open(path, "rb") as f:
        assert f.read() == b"generation-2"
    assert os.listdir(tmp_path) == ["state.bin"]
    assert len(synced) >= 4  # a data and a directory fsync per write


@pytest.mark.parametrize("inc,seq,sender,env_inc,env_seq,codec,n", [
    (20, 1, 1, 0, 0, 0, 4), (0xFFFFFFFF, 2**40, -3, 9, 7, 2, 5), (7, 3, 2, 0, 0, 0, 0)])
def test_record_bytes_equal_jax(inc, seq, sender, env_inc, env_seq, codec, n):
    payload = np.random.default_rng(seq % 97).normal(size=n).astype(np.float32)
    mine = twal._record_bytes(inc, seq, sender, env_inc, env_seq, payload, codec)
    assert mine == jwal._record_bytes(inc, seq, sender, env_inc, env_seq, payload, codec)
    assert mine[:4] == struct.pack("<I", 0x57414C32) and len(mine) == 44 + 4 * n


def _fill(mod, path, n=3, inc=20, start_seq=1):
    w = mod.WriteAheadLog(path, incarnation=inc)
    for i in range(n):
        w.append(start_seq + i, np.full(4, start_seq + i, np.float32), sender=1,
                 env_inc=9, env_seq=i)
    w.sync()
    return w


def _same_records(a, b):
    assert [(r.incarnation, r.seq, r.sender, r.env_inc, r.env_seq, r.codec) for r in a] == [
        (r.incarnation, r.seq, r.sender, r.env_inc, r.env_seq, r.codec) for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.payload, y.payload)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_each_package_replays_the_others_log(tmp_path, writer, reader):
    writer, reader = [{"jax": jwal, "port": twal}[k] for k in (writer, reader)]
    path = str(tmp_path / "w.log")
    w = _fill(writer, path, n=4)
    w.truncate(1)
    w.append(5, np.arange(4, dtype=np.float32), sender=2, codec=3)
    w.close()
    got, stats = reader.replay_wal(path)
    want, want_stats = writer.replay_wal(path)
    _same_records(got, want)
    assert stats == want_stats == {"records": 4, "torn_tail": 0, "stale_skipped": 0}
    assert [r.seq for r in got] == [2, 3, 4, 5] and got[-1].codec == 3


def test_wal_roundtrip_and_truncate(tmp_path):
    path = str(tmp_path / "w.log")
    w = _fill(twal, path)
    records, stats = twal.replay_wal(path)
    assert [r.seq for r in records] == [1, 2, 3]
    assert stats == {"records": 3, "torn_tail": 0, "stale_skipped": 0}
    assert records[1].sender == 1 and records[1].env_seq == 1
    w.truncate(2)
    assert [r.seq for r in twal.replay_wal(path)[0]] == [3]
    w.append(4, np.zeros(4, np.float32))
    w.sync()
    assert [r.seq for r in twal.replay_wal(path)[0]] == [3, 4]
    w.drop_after(3)
    assert [r.seq for r in twal.replay_wal(path)[0]] == [3]
    w.close()


def _rewrite(path, fn):
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(fn(data))


def test_wal_torn_tail_is_tolerated_as_jax(tmp_path):
    path = str(tmp_path / "w.log")
    _fill(twal, path).close()
    _rewrite(path, lambda d: d[:-5])
    records, stats = twal.replay_wal(path)
    assert [r.seq for r in records] == [1, 2] and stats["torn_tail"] == 1
    _same_records(records, jwal.replay_wal(path)[0])
    assert jwal.replay_wal(path)[1] == stats


def test_wal_v1_log_refused_loudly(tmp_path):
    body = np.ones(4, np.float32).tobytes()
    head = struct.pack("<IIQiIIQ", twal._MAGIC_V1, 7, 1, 2, 0, 0, len(body))
    crc = zlib.crc32(body, zlib.crc32(head)) & 0xFFFFFFFF
    path = str(tmp_path / "w.log")
    with open(path, "wb") as f:
        f.write(head + struct.pack("<I", crc) + body)
    with pytest.raises(twal.WALCorruptionError, match="WAL1"):
        twal.replay_wal(path)
    with pytest.raises(jwal.WALCorruptionError, match="WAL1"):
        jwal.replay_wal(path)


def test_wal_midlog_corruption_fails_loudly(tmp_path):
    path = str(tmp_path / "w.log")
    _fill(twal, path).close()

    def flip(data):
        out = bytearray(data)
        out[len(data) // 3 - 3] ^= 0x5A  # inside record 1's payload
        return bytes(out)

    _rewrite(path, flip)
    with pytest.raises(twal.WALCorruptionError):
        twal.replay_wal(path)
    with pytest.raises(jwal.WALCorruptionError):
        jwal.replay_wal(path)


def test_wal_stale_incarnation_records_skipped(tmp_path):
    path = str(tmp_path / "w.log")
    _fill(twal, path, n=2, inc=20, start_seq=1).close()
    stale = twal.WriteAheadLog(path, incarnation=10)  # an older life appends
    stale.append(99, np.full(4, 99, np.float32))
    stale.close()
    _fill(jwal, path, n=1, inc=21, start_seq=3).close()
    records, stats = twal.replay_wal(path)
    assert [r.seq for r in records] == [1, 2, 3] and stats["stale_skipped"] == 1
    _same_records(records, jwal.replay_wal(path)[0])


def _server(cls, tmp_path, wal=True, **kw):
    return cls(params=np.zeros(8, np.float32), ckpt_dir=str(tmp_path), ckpt_every=0,
               wal=wal, **kw)


def _clock(ps):
    return (ps.staleness.version, ps._push_count, ps._apply_seq, dict(ps.applied_by_sender))


def test_ps_wal_replays_committed_updates_without_checkpoint(tmp_path):
    ps = _server(ParameterServer, tmp_path)
    delta = np.arange(8, dtype=np.float32)
    for _ in range(3):
        ps.handle(1, GU, delta)
    ps.commit()
    del ps  # the crash: no save_checkpoint
    ps2 = _server(ParameterServer, tmp_path)
    assert ps2.maybe_restore()
    np.testing.assert_array_equal(ps2.central, 3 * delta)
    assert _clock(ps2) == (3, 3, 3, {1: 3}) and ps2.replayed_updates == 3


def test_ps_wal_replay_is_idempotent_when_checkpoint_raced_truncation(tmp_path, monkeypatch):
    ps = _server(ParameterServer, tmp_path)
    delta = np.arange(8, dtype=np.float32)
    for _ in range(3):
        ps.handle(1, GU, delta)
    monkeypatch.setattr(twal.WriteAheadLog, "truncate", lambda self, upto_seq: None)
    ps.save_checkpoint()
    assert len(twal.replay_wal(ps.wal.path)[0]) == 3
    del ps
    ps2 = _server(ParameterServer, tmp_path)
    assert ps2.maybe_restore()
    np.testing.assert_array_equal(ps2.central, 3 * delta)  # not 6x
    assert ps2._apply_seq == 3 and ps2.replayed_updates == 0


def test_ckpt_tear_window_restores_consistent_previous_generation(tmp_path, monkeypatch):
    ps = _server(ParameterServer, tmp_path)
    delta = np.arange(8, dtype=np.float32)
    ps.handle(1, GU, delta)
    ps.save_checkpoint()  # generation 1
    for _ in range(2):
        ps.handle(1, GU, delta)
    ps.commit()
    real, calls = tps.atomic_write, []

    def crash_on_vector(path, data):
        if path.endswith("ps_central.npy"):
            calls.append(path)
            raise OSError("simulated crash between the two renames")
        return real(path, data)

    monkeypatch.setattr(tps, "atomic_write", crash_on_vector)
    with pytest.raises(OSError):
        ps.save_checkpoint()  # the meta of generation 2 lands, the vector does not
    monkeypatch.setattr(tps, "atomic_write", real)
    assert calls
    del ps
    for cls in (ParameterServer, JServer):  # the JAX server resolves it the same way
        ps2 = _server(cls, tmp_path)
        assert ps2.maybe_restore()
        np.testing.assert_array_equal(ps2.central, 3 * delta)
        assert _clock(ps2) == (3, 3, 3, {1: 3}) and ps2.replayed_updates == 2
        ps2.wal.close()


def test_ckpt_vector_matching_neither_generation_fails_loudly(tmp_path):
    ps = _server(ParameterServer, tmp_path, wal=False)
    ps.handle(1, GU, np.ones(8, np.float32))
    ps.save_checkpoint()
    buf = io.BytesIO()
    np.save(buf, np.full(8, 7.5, np.float32))
    with open(ps._ckpt_path(), "wb") as f:
        f.write(buf.getvalue())
    with pytest.raises(ValueError, match="neither its meta"):
        _server(ParameterServer, tmp_path, wal=False).maybe_restore()


def test_ps_wal_requires_ckpt_dir():
    with pytest.raises(ValueError, match="ckpt_dir"):
        ParameterServer(params=np.zeros(4, np.float32), wal=True)


def test_wrong_size_update_dropped_before_wal_or_accounting(tmp_path):
    ps = _server(ParameterServer, tmp_path)
    ps.handle(1, GU, np.ones(3, np.float32))
    ps.handle(1, GU, np.ones(1, np.float32))
    assert ps.dropped_bad_updates == 2
    assert ps._apply_seq == 0 and ps.applied_by_sender == {} and ps.wal.appended == 0
    np.testing.assert_array_equal(ps.central, np.zeros(8, np.float32))


def _pushes(n_params, seed):
    rng = np.random.default_rng(seed)
    return [(1 + i % 2, rng.normal(size=n_params).astype(np.float32)) for i in range(7)]


def _drive(ps, pushes, ckpt_after):
    for i, (sender, delta) in enumerate(pushes):
        if i % 3 == 0:
            ps.handle(sender, MessageCode.ParameterRequest, np.zeros(0, np.float32))
        ps.handle(sender, GU, delta)
        if i + 1 == ckpt_after:
            ps.save_checkpoint()
    ps.commit()


def _world(cls):
    from distributed_ml_pytorch_tpu.utils.messaging import InProcessTransport as JT
    from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport as TT

    return (JT if cls is JServer else TT).create_world(3)[0]


SERVERS = {"jax": JServer, "port": ParameterServer}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_checkpoint_directory_restores_in_the_other_package(tmp_path, writer, reader):
    """A directory holding a checkpoint at push 4 and three logged pushes
    after it, written by one package's server (with staleness damping, so
    the logged deltas are the damped ones), restores in the other's to the
    writer's live vector and clock bit for bit; a final checkpoint taken by
    the reader restores back in the writer's."""
    writer, reader = SERVERS[writer], SERVERS[reader]
    src = writer(params=np.linspace(-1, 1, 40).astype(np.float32), ckpt_dir=str(tmp_path),
                 ckpt_every=0, wal=True, staleness_damping=0.5, transport=_world(writer))
    _drive(src, _pushes(40, seed=3), ckpt_after=4)
    live, clock = src.central.copy(), _clock(src)
    src.wal.close()
    assert sorted(os.listdir(tmp_path)) == ["ps_central.npy", "ps_meta.json", "ps_wal.log"]
    dst = reader(params=np.zeros(40, np.float32), ckpt_dir=str(tmp_path), ckpt_every=0,
                 wal=True)
    assert dst.maybe_restore() and dst.replayed_updates == 3
    np.testing.assert_array_equal(dst.central, live)
    assert _clock(dst) == clock == (7, 7, 7, {1: 4, 2: 3})
    dst.save_checkpoint()
    dst.wal.close()
    back_dir = tmp_path / "back"
    shutil.copytree(tmp_path, back_dir, ignore=shutil.ignore_patterns("back"))
    back = writer(params=np.zeros(40, np.float32), ckpt_dir=str(back_dir), ckpt_every=0)
    assert back.maybe_restore()
    np.testing.assert_array_equal(back.central, live)
    assert _clock(back) == clock
