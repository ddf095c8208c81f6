"""The port's gray-failure plane (``coord/grayhealth.py``, the coordinator's
gray hooks, ``coord/drill.gray_drill``) against the JAX package's.

- **ladder**: one scripted sequence of renewals, link triples and clock
  readings drives both packages' ``GrayHealth`` over a recording
  coordinator; states, scores, ``stats()``, flap counts and the frames and
  park tickets the plane produced are equal after every round, exactly
  (the counterparts of JAX ``tests/test_gray.py``'s ladder tests: the
  hysteresis clear, evict-on-first-suspicion, quarantine park, resume and
  re-probation, and the asymmetric link witness);
- **fleet**: the probation penalty bends a ``FleetRouter``'s pick without
  removing the engine, as the JAX router picks;
- **wire**: ``WireEvidence`` reads the same rates from both packages'
  reliable transports over one drop script; the coordinator decodes the
  renewal's link triples (nonfinite and truncated tails gated), reports
  ``gray_suspects`` in its fleet broadcast, and routes ``PreemptDone`` by
  grant id: the gray plane's grants to it and never to the scheduler;
- **drill**: one contained ``gray_drill`` at LeNet meets the JAX drill's
  contract (probation, quarantine, no eviction, a recovery, no lease
  expiry, acked <= applied, a bit-identical resume of the whole range),
  and its chaos log equals the JAX drill's at seed 0 (the windowed
  partition's log is a function of the window); the unmanaged leg
  (``contain=False``) puts no one on probation.
"""

import queue
import threading
import time
import types

import numpy as np
import pytest

from distributed_ml_pytorch_tpu.coord import grayhealth as jgray
from distributed_ml_pytorch_tpu_torch.coord import coordinator as tco
from distributed_ml_pytorch_tpu_torch.coord import grayhealth as tgray
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode


class _FakeMember:
    def __init__(self, rank):
        self.rank = rank
        self.kind = 99  # not a worker: no speculation
        self.kind_name = "shard"
        self.incarnation = 0
        self.retrans_rate = 0.0
        self.nack_rate = 0.0
        self.blocked_s = 0.0
        self.fsync_p95_ms = 0.0
        self.busy_ratio = 0.0


class _FakeCoord:
    """The coordinator surface ``GrayHealth`` acts on, recording what the
    plane did (log lines, frames, park tickets, revocations)."""

    def __init__(self, ranks=(1,)):
        self.members = {r: _FakeMember(r) for r in ranks}
        self.speculation = False
        self.manifests_written = 0
        self.last_manifest = None
        self.logs = []
        self.sent = []
        self.parked = {}
        self.revoked = []
        self.gray = None

    def _log(self, msg):
        self.logs.append(msg)

    def _send(self, rank, code, payload):
        self.sent.append((rank, int(code), np.asarray(payload).tolist()))

    def trigger_snapshot(self):
        self.manifests_written += 1
        self.last_manifest = types.SimpleNamespace(snapshot_id=7)

    def note_parked(self, rank, ticket):
        self.parked[rank] = dict(ticket)

    def note_unparked(self, rank):
        self.parked.pop(rank, None)

    def revoke_member(self, rank, why, cooldown=0.0):
        self.revoked.append((rank, why))
        self.members.pop(rank, None)


LADDER = dict(raise_threshold=2.5, confirm_ticks=2, clear_ticks=2, quarantine_after=3,
              quarantine_cooldown=0.5, actuator_rank=9)


class _Pair:
    """The same plane in both packages, stepped in lockstep."""

    def __init__(self, ranks=(1,), **knobs):
        self.coords = [_FakeCoord(ranks), _FakeCoord(ranks)]
        self.grays = [mod.GrayHealth(c, **knobs) for mod, c in zip((jgray, tgray), self.coords)]
        self.now = 100.0

    def renew(self, rank, x=0.0, links=()):
        for c, g in zip(self.coords, self.grays):
            m = c.members.get(rank) or _FakeMember(rank)
            m.retrans_rate = x
            g.on_renew(m, self.now, links)

    def tick(self):
        for g in self.grays:
            g.tick(self.now)

    def round(self, rank=1, x=0.01, dt=0.25):
        """One renew-then-tick round at the drills' lease / 4 cadence;
        ``x`` is the member's own retransmit rate."""
        self.now += dt
        self.renew(rank, x)
        self.tick()
        self.check()

    def preempt_done(self, rank, **kw):
        for g in self.grays:
            g.on_preempt_done(rank, grant_id=g._tracks[rank].grant_id, now=self.now, **kw)
        self.check()

    def check(self):
        """Everything observable, equal across the packages."""
        jg, tg = self.grays
        assert tg.stats() == jg.stats()
        ranks = sorted(set(jg._tracks) | set(tg._tracks))
        assert [tg.state_of(r) for r in ranks] == [jg.state_of(r) for r in ranks]
        assert [tg.score(r, self.now) for r in ranks] == [jg.score(r, self.now) for r in ranks]
        assert [tg.flaps_of(r) for r in ranks] == [jg.flaps_of(r) for r in ranks]
        assert tg.suspects() == jg.suspects() and tg.suspect_count() == jg.suspect_count()
        jc, tc = self.coords
        assert tc.logs == jc.logs and tc.sent == jc.sent
        assert tc.parked == jc.parked and tc.revoked == jc.revoked
        return tg

    def state(self, rank=1):
        return self.check().state_of(rank)


def test_gray_grant_base_and_states_are_the_jax_values():
    assert tgray.GRAY_GRANT_BASE == jgray.GRAY_GRANT_BASE == 1 << 24
    assert (tgray.OK, tgray.PROBATION, tgray.QUARANTINED, tgray.EVICTED) == \
        (jgray.OK, jgray.PROBATION, jgray.QUARANTINED, jgray.EVICTED)


@pytest.mark.parametrize("args", [(0.1, 0.0, 0.0, 0.0, 0.0), (0.02, 0.3, 0.7, 48.0, 0.4),
                                  (0.0, 0.0, 0.0, 0.0, 1.0), (1e-7, 2.5, 1e3, 1e-3, 0.999)])
def test_evidence_scalars_equal_jax(args):
    assert tgray.member_evidence(*args) == jgray.member_evidence(*args)
    assert tgray.link_evidence(args[0], args[2]) == jgray.link_evidence(args[0], args[2])


def test_ladder_probation_entry_and_hysteresis_clear():
    p = _Pair(**LADDER)
    for _ in range(10):
        p.round()  # warm the baseline
    assert p.state() == tgray.OK
    p.round(x=2.0)  # suspicious tick 1: not confirmed yet
    assert p.state() == tgray.OK
    p.round(x=2.0)  # tick 2: confirmed
    assert p.state() == tgray.PROBATION
    tg = p.check()
    assert tg.probations == 1 and tg.flaps_of(1) == 1 and tg.detection_latencies[0] >= 0
    p.round()  # hysteresis: one calm tick is not enough
    assert p.state() == tgray.PROBATION
    p.round()
    assert p.state() == tgray.OK and tg.suspect_count() == 0
    assert not p.coords[1].revoked and not p.coords[1].parked


@pytest.mark.parametrize("knobs", [dict(hysteresis=False), dict(confirm_ticks=3, clear_ticks=1)])
def test_flapping_weather_gives_equal_flaps(knobs):
    """Weather that alternates across the thresholds: the flap counts and
    detection latencies of both planes stay equal, with and without
    hysteresis."""
    p = _Pair(**{**LADDER, **knobs})
    for _ in range(10):
        p.round()
    for k in range(24):
        p.round(x=2.0 if (k // 3) % 2 == 0 else 0.01)
    tg = p.check()
    assert tg.flaps_of(1) >= 1


def test_evict_on_first_suspicion_knob_kills_the_flap_victim():
    p = _Pair(**LADDER, evict_on_first_suspicion=True)
    for _ in range(10):
        p.round()
    p.round(x=2.0)
    p.round(x=2.0)
    assert p.state() == tgray.EVICTED
    assert p.grays[1].evictions == 1 and p.coords[1].revoked[0][0] == 1


def test_quarantine_parks_resumes_and_reenters_probation():
    p = _Pair(**LADDER)
    for _ in range(10):
        p.round()
    for _ in range(2):
        p.round(x=2.0)
    assert p.state() == tgray.PROBATION
    for _ in range(6):
        p.round(x=2.0)
    tc = p.coords[1]
    preempts = [s for s in tc.sent if s[1] == int(MessageCode.PreemptRequest)]
    assert preempts and preempts[0][0] == 1 and tc.manifests_written == 1
    gid = p.grays[1]._tracks[1].grant_id
    assert p.grays[1].owns_grant(gid) and gid >= tgray.GRAY_GRANT_BASE
    p.preempt_done(1, snap_id=7, lo=0, hi=8, apply_seq=5)
    assert p.state() == tgray.QUARANTINED and tc.parked[1]["gray"] is True
    p.now += 1.0  # the cooldown ends: the resume goes to the actuator
    p.tick()
    resumes = [s for s in tc.sent if s[1] == int(MessageCode.ResumeRequest)]
    assert resumes and resumes[0][0] == 9
    p.round()  # the resumed life renews: back on the ladder at probation
    assert p.state() == tgray.PROBATION and 1 not in tc.parked
    for _ in range(2):
        p.round()
    assert p.state() == tgray.OK and not tc.revoked
    s = p.grays[1].stats()
    assert s["quarantines"] == 1 and s["evictions"] == 0 and s["recoveries"] == 1


def test_a_reoffender_is_evicted_after_its_quarantine_cycles():
    """``evict_after_quarantines=1``: still suspect after one quarantine
    cycle, the member is revoked, in both planes alike."""
    p = _Pair(**LADDER, evict_after_quarantines=1)
    for _ in range(10):
        p.round()
    for _ in range(8):
        p.round(x=2.0)
    p.preempt_done(1, snap_id=7, lo=0, hi=8, apply_seq=5)
    p.now += 1.0
    p.tick()
    for _ in range(8):
        p.round(x=2.0)
    assert p.state() == tgray.EVICTED and p.coords[1].revoked


@pytest.mark.parametrize("asymmetric", [True, False])
def test_asymmetric_link_evidence_convicts_a_clean_tailed_suspect(asymmetric):
    p = _Pair(ranks=(1, 2, 3), raise_threshold=2.5, confirm_ticks=2, asymmetric=asymmetric)

    def round_(link_rate):
        p.now += 0.25
        p.renew(1)  # the suspect's own tail: calm
        for rep in (2, 3):
            p.renew(rep, links=((1, link_rate, 0.0),))
        p.tick()
        p.check()

    for _ in range(10):
        round_(0.01)
    for _ in range(4):
        round_(1.0)
    assert p.state(1) == (tgray.PROBATION if asymmetric else tgray.OK)


def test_a_silent_member_is_suspected_by_its_own_arrival_history():
    """The phi-accrual half: a member that stops renewing is scored by how
    surprising its silence is against its own gaps."""
    p = _Pair(**LADDER)
    for _ in range(12):
        p.round()
    for _ in range(6):
        p.now += 0.25
        p.tick()
        p.check()
    assert p.state() == tgray.PROBATION


def test_fleet_gray_penalty_routes_around_without_removal():
    from distributed_ml_pytorch_tpu.serving.fleet import FleetRouter as JRouter
    from distributed_ml_pytorch_tpu.serving.frontend import _Route as JRoute
    from distributed_ml_pytorch_tpu_torch.serving.fleet import FleetRouter
    from distributed_ml_pytorch_tpu_torch.serving.frontend import _Route

    class _M:
        def __init__(self, eid, slots):
            self.engine_id = eid
            self._slots = slots

        def pressure(self):
            return (0, self._slots, 0)

    def bare(cls, a, b):
        router = cls.__new__(cls)
        router.members = {0: a, 1: b}
        router._member_up = {0: True, 1: True}
        router._gray_penalized = set()
        router.session_affinity = False
        return router

    a, b = _M(0, 4), _M(1, 4)
    routers = [bare(FleetRouter, a, b), bare(JRouter, a, b)]
    routes = [_Route(rank=1, rid=1), JRoute(rank=1, rid=1)]

    def picks():
        got = [r._pick_engine(q) for r, q in zip(routers, routes)]
        assert got[0] is got[1]
        return got[0]

    assert picks() is a  # a tie goes to the lowest engine id
    for r in routers:
        r.note_gray(0)
    assert picks() is b  # the penalty bends the tie
    for r in routers:
        r._member_up[1] = False
    assert picks() is a  # degraded, not removed
    for r in routers:
        r._member_up[1] = True
        r.clear_gray(0)
    assert picks() is a  # the penalty is reversible


# --------------------------------------------------------------------- wire
class _Scripted:
    """A transport over an in-process endpoint that drops the sends whose
    index (over its reliable frames) is in ``drops``."""

    def __init__(self, inner, drops):
        self.inner = inner
        self.rank = inner.rank
        self.drops = set(drops)
        self.n = 0

    def send(self, code, payload, dst=0):
        if int(code) == int(MessageCode.ReliableFrame):
            self.n += 1
            if self.n - 1 in self.drops:
                return
        self.inner.send(code, payload, dst=dst)

    def sendv(self, code, parts, dst=0):
        self.send(code, np.concatenate([np.asarray(p, np.float32).ravel() for p in parts]),
                  dst=dst)

    def recv(self, timeout=None):
        return self.inner.recv(timeout=timeout)

    def close(self):
        self.inner.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_wire_evidence_reads_both_reliable_transports_alike(pkg):
    """Ten frames, the fourth's first copy dropped: one retransmission in
    ten sends, whichever package's ``ReliableTransport`` carried them (the
    native transport has no envelope of its own: its reliable layer is
    this wrapper, so the keys mean the same on it). A second sample sees
    only the new window."""
    if pkg == "jax":
        from distributed_ml_pytorch_tpu.utils import messaging as mod
    else:
        mod = tmsg
    boxes = {r: queue.Queue() for r in (0, 1)}
    sender = mod.ReliableTransport(_Scripted(mod.InProcessTransport(1, boxes), {3}),
                                   ack_timeout=1.0)
    receiver = mod.ReliableTransport(mod.InProcessTransport(0, boxes), ack_timeout=1.0)
    stop = threading.Event()

    def drain():
        while not stop.is_set():
            receiver.recv(timeout=0.05)

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    try:
        evidence = [tgray.WireEvidence(sender), jgray.WireEvidence(sender)]
        for k in range(10):
            sender.send(MessageCode.GradientUpdate, np.full(4, float(k), np.float32), dst=0)
        assert sender.flush(timeout=10.0)
        samples = [e.sample() for e in evidence]
        assert samples[0] == samples[1]
        assert samples[0][0] == pytest.approx(0.1) and samples[0][1] == 0.0
        sender.send(MessageCode.GradientUpdate, np.zeros(4, np.float32), dst=0)
        assert sender.flush(timeout=10.0)
        assert [e.sample() for e in evidence] == [(0.0, 0.0), (0.0, 0.0)]
    finally:
        stop.set()
        t.join(timeout=5)
        sender.close()
        receiver.close()
    assert tgray.WireEvidence(object()).sample() == (0.0, 0.0)


def _coord_rig(sched=None):
    world = tmsg.InProcessTransport.create_world(3)
    now = [100.0]
    coord = tco.Coordinator(world[0], 8, lease=8.0, speculation=False, clock=lambda: now[0])
    coord.sched = sched
    gray = tgray.GrayHealth(coord, raise_threshold=2.5)
    for r in (1, 2):
        coord.handle(r, MessageCode.CoordJoin, tco.encode_join(tco.KIND_SHARD, 0))
    return world, coord, gray, now


def _close(world):
    for t in world.values():
        t.close()


def test_renew_link_triples_decode_and_malformed_tails_are_gated():
    world, coord, gray, now = _coord_rig()
    try:
        assert coord.gray is gray
        now[0] += 1.0
        coord.handle(2, MessageCode.LeaseRenew, tco.encode_renew(0, links=((1, 0.5, 0.25),)))
        assert (1, 2) in gray._links and gray._links[(1, 2)].latest > 0
        seen = coord.members[2].last_seen
        now[0] += 1.0
        coord.handle(2, MessageCode.LeaseRenew, np.full(15, np.nan, np.float32))
        assert coord.members[2].last_seen == seen  # a nonfinite renewal is dropped whole
        before = len(gray._links)
        coord.handle(2, MessageCode.LeaseRenew,
                     np.concatenate([tco.encode_renew(0), np.asarray([1.0, 0.5], np.float32)]))
        assert len(gray._links) == before  # a truncated triple is no evidence
        coord.handle(2, MessageCode.LeaseRenew, tco.encode_renew(0, links=((2, 9.0, 9.0),)))
        assert (2, 2) not in gray._links  # a self-report is no indictment
    finally:
        _close(world)


def test_fleet_broadcast_carries_the_suspect_count():
    world, coord, gray, now = _coord_rig()
    try:
        assert coord.fleet_state()["fleet_metrics"][4] == 0.0
        gray._tracks[1] = tgray._Track()
        gray._tracks[1].state = tgray.PROBATION
        fs = coord.fleet_state()
        assert fs["fleet_metrics"][4] == 1.0
        frame = tco.encode_fleet(fs["version"], fs["n_workers"], fs["n_shards"],
                                 fs["n_engines"], fs["workers_done"], fs["engine_ranks"],
                                 fs["fleet_metrics"])
        assert tco.decode_fleet(frame)["fleet_metrics"]["gray_suspects"] == 1.0
    finally:
        _close(world)


@pytest.mark.parametrize("gray_grant", [True, False])
def test_preempt_done_is_routed_by_grant_id(gray_grant):
    """A grant at or above ``GRAY_GRANT_BASE`` reaches the gray plane and
    never the scheduler; any other reaches the scheduler alone."""
    calls = []
    sched = types.SimpleNamespace(
        on_preempt_done=lambda sender, **kw: calls.append(("sched", sender, kw)),
        tick=lambda now: None, parked_ranks=lambda: set())
    world, coord, gray, now = _coord_rig(sched)
    gray.on_preempt_done = lambda sender, **kw: calls.append(("gray", sender, kw))
    try:
        gid = tgray.GRAY_GRANT_BASE + 3 if gray_grant else 5
        coord.handle(1, MessageCode.PreemptDone, tco.encode_preempt_done(gid, 4, 0, 8, 11))
        assert [c[0] for c in calls] == ["gray" if gray_grant else "sched"]
        assert calls[0][1] == 1 and calls[0][2] == dict(grant_id=gid, snap_id=4, lo=0, hi=8,
                                                        apply_seq=11, now=now[0])
    finally:
        _close(world)


def test_a_gray_park_is_a_durable_ticket_and_survives_a_restart(tmp_path):
    """The gray plane parks through the durable park table: the ticket is
    logged, tagged ``gray``, keeps lease expiry off across a coordinator
    restart, and a scheduler attached to the new life synthesizes no slot
    for it (it borrowed no capacity)."""
    from distributed_ml_pytorch_tpu_torch.coord.sched import FleetScheduler

    now = [100.0]
    c1 = tco.Coordinator(None, 8, lease=1.0, speculation=False, clock=lambda: now[0],
                         durable_dir=str(tmp_path))
    g1 = tgray.GrayHealth(c1)
    c1.handle(1, MessageCode.CoordJoin, tco.encode_join(tco.KIND_SHARD, 3))
    g1._tracks[1] = tgray._Track()
    g1._pending_preempt = {"rank": 1, "grant_id": tgray.GRAY_GRANT_BASE, "started": now[0],
                           "sent": True}
    c1.handle(1, MessageCode.PreemptDone,
              tco.encode_preempt_done(tgray.GRAY_GRANT_BASE, 2, 0, 8, 9))
    assert g1.state_of(1) == tgray.QUARANTINED and 1 in c1.parked_ranks()
    c2 = tco.Coordinator(None, 8, lease=1.0, speculation=False, clock=lambda: now[0],
                         durable_dir=str(tmp_path))
    assert c2._parked_durable[1]["gray"] is True
    now[0] += 10.0
    c2.tick()
    assert 1 in c2.members  # parked: exempt from lease expiry
    sched = FleetScheduler(c2)
    assert all(s.rank != 1 for s in sched.ledger.slots.values())


# -------------------------------------------------------------------- drill
@pytest.fixture(scope="module")
def jax_gray_lines(tmp_path_factory):
    """The JAX drill's chaos log at seed 0 (a one-layer model: the log is a
    function of the partition window, not of the model)."""
    import jax
    import jax.numpy as jnp

    from distributed_ml_pytorch_tpu.coord.drill import gray_drill as jdrill
    from distributed_ml_pytorch_tpu.data import load_cifar10

    x, y, *_ = load_cifar10(n_train=256, n_test=32, synthetic=True)

    @jax.jit
    def grad_fn(p, bx, by, rng):
        def loss_fn(q):
            logits = bx.reshape(bx.shape[0], -1) @ q["w"] + q["b"]
            logp = jax.nn.log_softmax(logits)
            return -jnp.mean(jnp.take_along_axis(logp, by[:, None], 1))

        return jax.value_and_grad(loss_fn)(p)

    p0 = {"w": 1e-3 * jax.random.normal(jax.random.key(0), (3072, 10)), "b": jnp.zeros(10)}
    # a directory that outlives the drill: the JAX drill returns before its
    # serve threads' last checkpoints are written
    out = jdrill(base_dir=str(tmp_path_factory.mktemp("jax_gray")), seed=0,
                 fixture=(x, y, grad_fn, p0))
    assert out["ok"], (out["violations"], out["errors"])
    return out["chaos_lines"]


def test_gray_drill_contains_without_killing_and_logs_as_jax(tmp_path, jax_gray_lines):
    from distributed_ml_pytorch_tpu_torch.coord.drill import gray_drill

    t0 = time.monotonic()
    out = gray_drill(base_dir=str(tmp_path), seed=0, model="lenet", device="cpu")
    assert out["ok"], (out["violations"], out["errors"], out["events"][-8:])
    g = out["gray"]
    assert g["probations"] >= 1 and g["quarantines"] >= 1 and g["evictions"] == 0
    assert g["recoveries"] >= 1 and out["bit_identical"] is True
    assert out["detect_latency_s"] is not None and out["containment_mttr_s"] is not None
    assert not [e for e in out["events"] if "lease expired" in e and " 1 " in e]
    for i in out["acked"]:
        for j in out["acked"][i]:
            assert out["acked"][i][j] <= out["applied"][i][j]
    assert out["chaos_counts"] == {"gray-partition": 56}
    assert out["chaos_lines"] == jax_gray_lines
    assert set(out) >= {"ok", "violations", "errors", "stuck_workers", "losses", "acked",
                        "applied", "replayed_updates", "bit_identical", "gray",
                        "detect_latency_s", "containment_mttr_s", "events", "chaos_lines",
                        "chaos_counts", "wall_s", "fixed_wall_s", "servers"}
    assert out["wall_s"] <= time.monotonic() - t0


def test_unmanaged_gray_drill_puts_no_one_on_probation(tmp_path):
    from distributed_ml_pytorch_tpu_torch.coord.drill import gray_drill

    out = gray_drill(base_dir=str(tmp_path), seed=0, model="lenet", device="cpu",
                     contain=False)
    assert out["ok"], (out["violations"], out["errors"])
    assert out["gray"]["probations"] == 0 and out["gray"]["quarantines"] == 0
    assert out["detect_latency_s"] is None and out["bit_identical"] is None
    assert out["chaos_counts"] == {"gray-partition": 56}
    assert out["fixed_wall_s"] is not None

