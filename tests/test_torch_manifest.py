"""The port's fleet manifests and snapshot barrier (``coord/manifest.py``,
the barrier half of ``coord/coordinator.py``, ``coord/elastic.py``'s
snapshot mailbox and manifest restore) against the JAX package's.

- Manifests: the bytes ``write`` publishes equal the JAX package's for the
  same manifest, and each package loads the other's file; ``validate``
  refuses the incomplete, mixed, gapped, short and duplicated manifests
  with the JAX messages.
- The barrier: both packages' ``Coordinator`` driven by one script under a
  fake clock through a recording transport send the same frames (bytes,
  fence trailer included), log the same events and publish byte-equal
  manifests; the mixed-version refusal, the range refusal, the abort on a
  rebalance, the abort of a barrier nobody finishes and
  ``snapshot_interval`` behave as in JAX.
- The shard's half: a ``SnapshotRequest`` through the client reaches the
  server's mailbox, and its serve loop checkpoints and reports (its own map
  version when the request names another);
- ``restore_from_manifest``: its loud refusals (invalid manifest, a server
  the manifest omits, nothing restorable, state behind the promise) and a
  restore across packages.
"""

import os
import threading
import time

import numpy as np
import pytest

from distributed_ml_pytorch_tpu.coord import coordinator as jco
from distributed_ml_pytorch_tpu.coord import manifest as jman
from distributed_ml_pytorch_tpu.parallel.async_ps import ParameterServer as JServer
from distributed_ml_pytorch_tpu_torch.coord import coordinator as tco
from distributed_ml_pytorch_tpu_torch.coord import manifest as tman
from distributed_ml_pytorch_tpu_torch.coord.elastic import ElasticShardServer
from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient
from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode as MC
from distributed_ml_pytorch_tpu_torch.utils.messaging import strip_epoch


def _b(a):
    return np.asarray(a, np.float32).tobytes()


def _manifest(mod, **over):
    kw = dict(snapshot_id=3, map_version=5, n_params=100,
              shards=(mod.ShardRecord(1, 0, 50, 5, 10, 10), mod.ShardRecord(2, 50, 100, 5, 8, 8)),
              complete=True)
    kw.update(over)
    return mod.FleetManifest(**kw)


# --------------------------------------------------------------- manifests

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_manifest_bytes_equal_and_each_package_loads_the_others(tmp_path, writer):
    paths = {}
    for name, mod in (("jax", jman), ("port", tman)):
        paths[name] = str(tmp_path / f"{name}.json")
        _manifest(mod).write(paths[name])
    assert open(paths["jax"], "rb").read() == open(paths["port"], "rb").read()
    reader = tman if writer == "jax" else jman
    m = reader.FleetManifest.load(paths[writer])
    assert m == _manifest(reader)
    assert m.shard_map.version == 5 and m.shard_map.ranges == [(0, 50), (50, 100)]
    assert m.entry_for(2).apply_seq == 8
    with pytest.raises(reader.ManifestError, match="no record for server 9"):
        m.entry_for(9)


def _bad(mod):
    R = mod.ShardRecord
    return {
        "incomplete": _manifest(mod, complete=False),
        "MIXED": _manifest(mod, shards=(R(1, 0, 50, 5, 10, 10), R(2, 50, 100, 4, 8, 8))),
        "tile": _manifest(mod, shards=(R(1, 0, 40, 5, 10, 10), R(2, 50, 100, 5, 8, 8))),
        "covers": _manifest(mod, shards=(R(1, 0, 90, 5, 10, 10),)),
        "more than once": _manifest(mod, shards=(R(1, 0, 50, 5, 10, 10),
                                                 R(1, 50, 100, 5, 8, 8))),
        "records no shards": _manifest(mod, shards=()),
    }


@pytest.mark.parametrize("case", list(_bad(tman)))
def test_validate_refuses_as_jax(tmp_path, case):
    msgs = []
    for mod in (jman, tman):
        with pytest.raises(mod.ManifestError, match=case) as err:
            _bad(mod)[case].validate()
        msgs.append(str(err.value))
        with pytest.raises(mod.ManifestError):  # never published either
            _bad(mod)[case].write(str(tmp_path / f"{mod.__name__}.json"))
    assert msgs[0] == msgs[1]


def test_load_refuses_unreadable_and_malformed_files(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"snapshot_id": 1}')
    for mod in (jman, tman):
        with pytest.raises(mod.ManifestError, match="unreadable"):
            mod.FleetManifest.load(str(tmp_path / "missing.json"))
        with pytest.raises(mod.ManifestError, match="malformed"):
            mod.FleetManifest.load(str(bad))


# ------------------------------------------------------------- the barrier

class _Recorder:
    rank = 0

    def __init__(self):
        self.sent = []

    def send(self, code, payload, dst=0):
        self.sent.append((dst, int(code), _b(payload)))

    def recv(self, timeout=None):
        return None


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _pair(tmp_path, **kw):
    """Both packages' coordinators over their own recorder, clock and
    manifest directory."""
    out = []
    for name, mod in (("jax", jco), ("port", tco)):
        clock, rec = _Clock(), _Recorder()
        d = tmp_path / name
        c = mod.Coordinator(rec, 100, lease=10.0, clock=clock, speculation=False,
                            manifest_dir=str(d), **kw)
        out.append((c, clock, rec, d))
    return out


def _drive(pair, script):
    """``(t, sender, code, payload)``; a None code ticks, a str calls that
    method."""
    for c, clock, _rec, _d in pair:
        for t, sender, code, payload in script:
            clock.t = t
            if code is None:
                c.tick()
            elif isinstance(code, str):
                getattr(c, code)()
            else:
                c.handle(sender, code, payload)


def _same(pair):
    (jc, _, jrec, jd), (tc, _, trec, td) = pair
    assert trec.sent == jrec.sent
    assert ([e.replace(str(td), "<dir>") for e in tc.events]
            == [e.replace(str(jd), "<dir>") for e in jc.events])
    assert (tc.manifests_written, tc._snap_seq) == (jc.manifests_written, jc._snap_seq)
    jm, tm = jd / tman.MANIFEST_NAME, td / tman.MANIFEST_NAME
    assert jm.exists() == tm.exists()
    if jm.exists():
        assert jm.read_bytes() == tm.read_bytes()


def _joins():
    join = tco.encode_join
    return [(0.0, 1, MC.CoordJoin, join(1, 10)), (0.0, 2, MC.CoordJoin, join(1, 11)),
            (0.0, 3, MC.CoordJoin, join(0, 12))]


def test_barrier_frames_and_manifest_equal_jax(tmp_path):
    pair = _pair(tmp_path)
    done = tco.encode_snapshot_done
    script = _joins() + [
        (0.05, None, "trigger_snapshot", None), (0.1, None, None, None),
        # a stale id, then shard 1, a duplicate, then shard 2 completes
        (0.2, 1, MC.SnapshotDone, done(9, 2, 0, 50, 1, 1)),
        (0.2, 1, MC.SnapshotDone, done(1, 2, 0, 50, 14, 14)),
        (0.25, 1, MC.SnapshotDone, done(1, 2, 0, 50, 14, 14)),
        (0.3, 2, MC.SnapshotDone, done(1, 2, 50, 100, 12, 13)),
        # a truncated and a nonfinite report change nothing
        (0.35, 2, MC.SnapshotDone, done(2, 2, 50, 100, 1, 1)[:8]),
        (0.35, 2, MC.SnapshotDone, np.full(12, np.nan, np.float32)),
        (0.4, None, "trigger_snapshot", None), (0.5, None, None, None),
        (0.6, None, "trigger_snapshot", None), (0.7, None, None, None),  # in flight
    ]
    _drive(pair, script)
    _same(pair)
    (jc, _, jrec, _), (tc, _, trec, _) = pair
    assert tc.manifests_written == 1 and tc._snap["id"] == 2
    m = tman.FleetManifest.load(tc.manifest_path())
    assert (m.snapshot_id, m.map_version) == (1, 2)
    assert (m.entry_for(1).apply_seq, m.entry_for(2).push_count) == (14, 13)
    requests = [(dst, strip_epoch(np.frombuffer(p, np.float32))) for dst, code, p in trec.sent
                if code == int(MC.SnapshotRequest)]
    assert [d for d, _ in requests] == [1, 2, 1, 2]
    assert [_b(p) for _, (p, _e) in requests[:1]] == [_b(tco.encode_snapshot_request(1, 2))]
    assert all(e == 1 for _, (_p, e) in requests)


@pytest.mark.parametrize("fault", ["mixed_version", "wrong_range", "rebalance", "timeout",
                                   "no_shards"])
def test_barrier_refusals_and_aborts_as_jax(tmp_path, fault):
    kw = {"snapshot_timeout": 5.0} if fault == "timeout" else {}
    pair = _pair(tmp_path, **kw)
    done = tco.encode_snapshot_done
    script = [] if fault == "no_shards" else _joins()
    script += [(0.05, None, "trigger_snapshot", None), (0.1, None, None, None)]
    if fault == "mixed_version":
        script += [(0.2, 1, MC.SnapshotDone, done(1, 1, 0, 50, 14, 14))]
    elif fault == "wrong_range":
        script += [(0.2, 1, MC.SnapshotDone, done(1, 2, 0, 49, 14, 14))]
    elif fault == "rebalance":
        script += [(0.2, 4, MC.CoordJoin, tco.encode_join(1, 13))]
    elif fault == "timeout":
        script += [(0.2, 1, MC.SnapshotDone, done(1, 2, 0, 50, 14, 14)),
                   (5.2, None, None, None)]
    # the late report of the dead barrier is stale
    script += [(6.0, 2, MC.SnapshotDone, done(1, 2, 50, 100, 12, 12))]
    _drive(pair, script)
    _same(pair)
    tc = pair[1][0]
    assert tc._snap is None and tc.manifests_written == 0
    word = {"timeout": "abandoned", "no_shards": "no live shard"}.get(fault, "aborted")
    assert any(word in e for e in tc.events), list(tc.events)


def test_snapshot_interval_drives_periodic_barriers_as_jax(tmp_path):
    pair = _pair(tmp_path, snapshot_interval=5.0)
    _drive(pair, [(0.0, 1, MC.CoordJoin, tco.encode_join(1, 10)), (4.9, None, None, None),
                  (5.1, None, None, None), (9.0, 1, MC.LeaseRenew, tco.encode_renew(10)),
                  (10.2, None, None, None)])
    _same(pair)
    tc = pair[1][0]
    # the first barrier never finished: the second request is ignored
    assert tc._snap["id"] == 1 and any("still in flight" in e for e in tc.events)


def test_coordinator_adopts_a_manifests_map_and_clock_as_jax():
    cs = [mod.Coordinator(None, 100, speculation=False, restore_manifest=_manifest(man))
          for mod, man in ((jco, jman), (tco, tman))]
    for c in cs:
        assert c.shard_map.version == 5 and c.shard_map.ranges == [(0, 50), (50, 100)]
        assert c._snap_seq == 3 and c.last_manifest.snapshot_id == 3
    assert list(cs[0].events) == list(cs[1].events)
    with pytest.raises(tman.ManifestError):
        tco.Coordinator(None, 100, restore_manifest=_manifest(tman, complete=False))


# ----------------------------------------------------------- the shard's half

def _shard(tmp_path, name="shard0", **kw):
    world = InProcessTransport.create_world(2)
    client = CoordClient(world[1], "shard", renew_interval=60.0)
    srv = ElasticShardServer(server_id=1, n_params=100, transport=world[0], coord=client,
                             ckpt_dir=str(tmp_path / name), wal=True, **kw)
    return srv, client, world


def _close(client, world):
    client.stop()
    for t in world.values():
        t.close()


def _reports(coord_end):
    out = []
    while (msg := coord_end.recv(timeout=0.5)) is not None:
        if msg[1] == MC.SnapshotDone:
            out.append(msg[2])
    return out


@pytest.mark.parametrize("asked", [2, 7])
def test_a_snapshot_request_checkpoints_at_the_next_boundary_and_reports(tmp_path, asked):
    """The request reaches the client, whose callback parks it; the serve
    loop takes it, commits, checkpoints and reports its own map version
    (so a request for another version is refused by the coordinator)."""
    coord_world = InProcessTransport.create_world(2)
    client = CoordClient(coord_world[1], "shard", renew_interval=60.0)
    world = InProcessTransport.create_world(2)
    srv = ElasticShardServer(server_id=1, n_params=100, transport=world[0], coord=client,
                             init_params=np.arange(100, dtype=np.float32),
                             ckpt_dir=str(tmp_path / "s"), wal=True)
    srv._apply_map(tco.ShardMap(2, 100, [tco.ShardEntry(1, 0, 100)]))
    srv.handle(1, MC.ShardPush, np.concatenate([
        np.asarray([2, 0, 0, 0, 100, 0], np.float32), np.ones(100, np.float32)]))
    th = threading.Thread(target=srv.run, kwargs={"timeout": 20}, daemon=True)
    try:
        srv.coord.join = lambda timeout=10.0: None  # no coordinator serves this star
        th.start()
        from distributed_ml_pytorch_tpu_torch.utils.messaging import stamp_epoch

        coord_world[0].send(MC.SnapshotRequest,
                            stamp_epoch(tco.encode_snapshot_request(4, asked), 1), dst=1)
        reports = []
        deadline = time.monotonic() + 10
        while not reports and time.monotonic() < deadline:
            reports = _reports(coord_world[0])
        assert len(reports) == 1
        assert _b(reports[0]) == _b(tco.encode_snapshot_done(4, 2, 0, 100, 1, 1))
        meta = os.path.join(str(tmp_path / "s"), "ps_meta.json")
        assert os.path.exists(meta)
    finally:
        srv.stop()
        th.join(timeout=10)
        client.stop()
        for w in (coord_world, world):
            for t in w.values():
                t.close()


# ------------------------------------------------------------------ restore

def test_restore_from_manifest_refuses_missing_checkpoint(tmp_path):
    srv, client, world = _shard(tmp_path)
    try:
        manifest = tman.FleetManifest(snapshot_id=1, map_version=2, n_params=100,
                                      shards=(tman.ShardRecord(1, 0, 100, 2, 5, 5),))
        with pytest.raises(tman.ManifestError, match="nothing restorable"):
            srv.restore_from_manifest(manifest)
    finally:
        _close(client, world)


def test_restore_from_manifest_refuses_state_behind_the_promise(tmp_path):
    srv, client, world = _shard(tmp_path)
    try:
        with srv._mu:
            srv.lo, srv.hi = 0, 100
            srv.ps.central = np.zeros(100, np.float32)
            srv.ps.handle(1, MC.GradientUpdate, np.ones(100, np.float32))
            srv.ps.save_checkpoint()  # apply seq 1 on disk
        manifest = tman.FleetManifest(snapshot_id=1, map_version=2, n_params=100,
                                      shards=(tman.ShardRecord(1, 0, 100, 2, 9, 9),))
        srv2, client2, world2 = _shard(tmp_path)
        try:
            with pytest.raises(tman.ManifestError, match="BEHIND"):
                srv2.restore_from_manifest(manifest)
        finally:
            _close(client2, world2)
    finally:
        _close(client, world)


def test_restore_from_manifest_refuses_invalid_and_foreign_manifests(tmp_path):
    srv, client, world = _shard(tmp_path)
    try:
        with pytest.raises(tman.ManifestError, match="incomplete"):
            srv.restore_from_manifest(_manifest(tman, complete=False))
        other = tman.FleetManifest(snapshot_id=1, map_version=2, n_params=100,
                                   shards=(tman.ShardRecord(7, 0, 100, 2, 5, 5),))
        with pytest.raises(tman.ManifestError, match="no record for server 1"):
            srv.restore_from_manifest(other)
    finally:
        _close(client, world)


def test_a_port_shard_restores_a_jax_servers_directory_from_a_jax_manifest(tmp_path):
    """A JAX server's checkpoint and WAL, under a JAX manifest: the port's
    shard restores the same vector and clock a JAX restore does."""
    rng = np.random.default_rng(0)
    d = str(tmp_path / "shard0")
    js = JServer(params=np.zeros(100, np.float32), ckpt_dir=d, wal=True)
    for _ in range(3):
        js.handle(1, MC.GradientUpdate, rng.standard_normal(100).astype(np.float32))
    js.save_checkpoint()
    for _ in range(2):
        js.handle(2, MC.GradientUpdate, rng.standard_normal(100).astype(np.float32))
    js.commit()
    jman.FleetManifest(snapshot_id=1, map_version=2, n_params=100,
                       shards=(jman.ShardRecord(1, 0, 100, 2, 3, 3),)).write(
        str(tmp_path / jman.MANIFEST_NAME))
    manifest = tman.FleetManifest.load(str(tmp_path / tman.MANIFEST_NAME))
    srv, client, world = _shard(tmp_path)
    try:
        srv.restore_from_manifest(manifest)
        assert (srv.lo, srv.hi, srv.map_version) == (0, 100, 2)
        assert srv.ps._apply_seq == 5 and srv.ps.replayed_updates == 2
        assert np.array_equal(srv.ps.central, js.central)
        assert srv.pending_install is None
    finally:
        _close(client, world)
