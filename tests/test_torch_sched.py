"""The port's multi-tenant scheduler plane (``coord/tenants.py``,
``coord/sched.py``, the coordinator's park table and engine-scaling advice,
the member's callbacks, the shard's park mailbox and the workers' hold)
against the JAX package's.

- The ledger and the registry: the exclusive grant and ``audit``, the
  priority orders and the wire-exact tenant ids, as JAX's.
- The protocol, synchronously: both packages' ``Coordinator`` and
  ``FleetScheduler`` on one fake clock, driven by the same ``handle`` and
  ``tick`` calls, with a node agent at ``actuator_rank``: a free slot
  admitted without a preempt, a preempt that parks and then hands the slot
  over exclusively, a parked rank exempt from lease expiry, a resume a
  newer incarnation completes, a resume timeout that falls back to parked,
  the capped decision ring, ``require_manifest`` gating the preempt behind
  the barrier and a dropped exclusivity gate caught by ``audit``. Each
  sends the same frames (destination, code, bytes), logs the same
  decisions and events and ends on the same ledger.
- The engine-scaling advice: the same renewals give the same advice, events
  and ``on_scale`` calls, within the cooldown.
- The durable park table: a coordinator restarted over its directory, from
  the checkpoint or from the log alone, in either package's order, restores
  the park (no expiry, no grace wait, no second grant) with the files of
  the first life byte-equal to JAX's.
- The wire: codes 35-38 and the ``park``/``unpark`` records equal the JAX
  encoders' bytes; the member hands codes 35, 37 and 38 to its callbacks as
  the JAX member does.
- The shard's park mailbox and the workers' hold: a parked server commits,
  reports ``PreemptDone`` and stops without a leave or a checkpoint; a held
  shard gets nothing (the same frames as the JAX client's), also after a
  cutover rebuilt the transports.

Exact throughout: the scheduler's decisions are functions of the frames and
the clock.
"""

import json
import os

import numpy as np
import pytest
import torch

from distributed_ml_pytorch_tpu.coord import coordinator as jco
from distributed_ml_pytorch_tpu.coord import member as jmem
from distributed_ml_pytorch_tpu.coord import sched as jsched
from distributed_ml_pytorch_tpu.coord import shardmap as jsm
from distributed_ml_pytorch_tpu.coord import tenants as jten
from distributed_ml_pytorch_tpu.utils import messaging as jmsg
from distributed_ml_pytorch_tpu_torch.coord import coordinator as tco
from distributed_ml_pytorch_tpu_torch.coord import elastic as tel
from distributed_ml_pytorch_tpu_torch.coord import member as tmem
from distributed_ml_pytorch_tpu_torch.coord import sched as tsched
from distributed_ml_pytorch_tpu_torch.coord import tenants as tten
from distributed_ml_pytorch_tpu_torch.coord.shardmap import ShardEntry, ShardMap
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils.messaging import InProcessTransport
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode as MC

TRAIN, SERVE = 1, 2
AGENT = 9
PKGS = {"jax": (jco, jsched, jten), "port": (tco, tsched, tten)}
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


class _H:
    """One package's coordinator and scheduler on a fake clock; ranks 1 and
    2 are shard members, the training tenant's slots."""

    def __init__(self, pkg, *, require_manifest=False, enforce_exclusive=True, lease=60.0,
                 resume_timeout=30.0, register=True, coord_kw=None):
        self.co, self.sc, self.tn = PKGS[pkg]
        self.now = [0.0]
        self.rec = _Recorder()
        self.coord = self.co.Coordinator(self.rec, 8, lease=lease, speculation=False,
                                         clock=lambda: self.now[0], **(coord_kw or {}))
        self.reg = self.tn.TenantRegistry()
        self.reg.register(self.tn.Tenant(tenant_id=TRAIN, name="train", priority=1, demand=2,
                                         min_slots=1))
        self.reg.register(self.tn.Tenant(tenant_id=SERVE, name="serve",
                                         kind=self.tn.TENANT_SERVING, priority=5, demand=0))
        self.sched = self.sc.FleetScheduler(
            self.coord, registry=self.reg, require_manifest=require_manifest,
            enforce_exclusive=enforce_exclusive, resume_timeout=resume_timeout,
            actuator_rank=AGENT)
        self.grants, self.resumes = [], []
        self.sched.on_grant = lambda gid, tid, action, slot: self.grants.append(
            (gid, tid, action, slot.slot_id))
        self.sched.on_resume = lambda gid, parked: self.resumes.append((gid, dict(parked)))
        if register:
            for rank in (1, 2):
                self.handle(rank, "CoordJoin", self.co.encode_join(self.co.KIND_SHARD, rank))
                self.sched.register_member_slot(rank, TRAIN)

    def handle(self, sender, code, payload):
        self.coord.handle(sender, getattr(PKG_MSG[self.co], code), payload)

    def tick(self, dt=0.0, coord=False):
        self.now[0] += dt
        if coord:
            self.coord.tick()
        else:
            self.sched.tick(self.now[0])

    def park(self):
        """Demand spike, then the victim's PreemptDone: (victim, grant)."""
        self.reg.set_demand(SERVE, 1)
        self.tick()
        p = self.sched._pending
        victim, gid = p["slot"].rank, p["grant_id"]
        self.handle(victim, "PreemptDone", self.co.encode_preempt_done(gid, 0, 4, 8, 17))
        return victim, gid

    def view(self):
        """Everything the two packages must agree on."""
        return {
            "sent": list(self.rec.sent),
            "decisions": list(self.sched.decisions),
            "events": list(self.coord.events),
            "summary": self.sched.summary(),
            "grants": list(self.grants),
            "resumes": list(self.resumes),
            "parked": sorted(self.coord.parked_ranks()),
            "slots": {s.slot_id: (s.rank, list(s.owners), s.state, s.grant_id, s.parked)
                      for s in self.sched.ledger.slots.values()},
            "members": sorted(self.coord.members),
        }


PKG_MSG = {jco: jmsg.MessageCode, tco: MC}


def _both(script, **kw):
    """Run ``script(h)`` on both packages; the port's harness after the two
    views were held equal."""
    views = {}
    hs = {}
    for pkg in ("jax", "port"):
        hs[pkg] = _H(pkg, **kw)
        script(hs[pkg])
        views[pkg] = hs[pkg].view()
    assert views["port"] == views["jax"]
    return hs["port"]


# ------------------------------------------------------ ledger and registry

@pytest.mark.parametrize("enforce", [True, False])
def test_the_ledger_grants_exclusively_and_audits_as_jax(enforce):
    out = {}
    for name, sc in (("jax", jsched), ("port", tsched)):
        ledger = sc.CapacityLedger(enforce_exclusive=enforce)
        slot = ledger.add_slot(rank=3, tenant_id=TRAIN)
        spare = ledger.add_slot()
        steps = [slot.state, [s.slot_id for s in ledger.free_slots()],
                 ledger.grant(slot, SERVE, grant_id=1), list(slot.owners), ledger.audit()]
        ledger.release(slot, TRAIN)
        steps += [ledger.grant(slot, SERVE, grant_id=2), list(slot.owners), slot.grant_id,
                  ledger.audit(), [s.slot_id for s in ledger.owned(SERVE)], spare.state]
        out[name] = steps
    assert out["port"] == out["jax"]
    if enforce:
        assert out["port"][2] is False and out["port"][4] == []
    else:
        assert "double-granted" in out["port"][4][0] and f"[{TRAIN}, {SERVE}]" in out["port"][4][0]


@pytest.mark.parametrize("tenant_id", [0, 1, 2, 65535, 65536, -1])
def test_the_registry_orders_and_keeps_ids_wire_exact_as_jax(tenant_id):
    out = {}
    for name, tn in (("jax", jten), ("port", tten)):
        reg = tn.TenantRegistry()
        reg.register(tn.Tenant(tenant_id=7, name="train", priority=1))
        reg.register(tn.Tenant(tenant_id=3, name="serve", kind=tn.TENANT_SERVING, priority=5))
        reg.register(tn.Tenant(tenant_id=5, name="mpmd", kind=tn.TENANT_MPMD, priority=1))
        try:
            reg.register(tn.Tenant(tenant_id=tenant_id, name="x", priority=3))
            err = None
        except ValueError as e:
            err = str(e)
        reg.set_demand(3, 4)
        out[name] = ([t.tenant_id for t in reg.all()], [t.tenant_id for t in reg.by_priority_asc()],
                     err, reg.get(3).demand, len(reg), [t.kind_name for t in reg.all()])
    assert out["port"] == out["jax"]
    assert (out["port"][2] is None) == (0 <= tenant_id < 1 << 16)
    with pytest.raises(KeyError):
        tten.TenantRegistry().set_demand(1, 1)


def test_the_registry_is_bounded_as_jax():
    for tn in (jten, tten):
        reg = tn.TenantRegistry()
        for i in range(tn.TenantRegistry.MAX_TENANTS):
            reg.register(tn.Tenant(tenant_id=i, name=str(i)))
        reg.register(tn.Tenant(tenant_id=0, name="again"))  # a re-register fits
        with pytest.raises(ValueError, match="full"):
            reg.register(tn.Tenant(tenant_id=99, name="one too many"))


# ------------------------------------------------ the protocol, synchronously

def test_a_free_slot_is_admitted_without_a_preempt():
    def script(h):
        h.sched.ledger.add_slot(rank=None)  # spare capacity
        h.reg.set_demand(SERVE, 1)
        h.tick()
        h.tick(1.0)

    h = _both(script)
    assert [g[1:3] for g in h.grants] == [(SERVE, 1)]
    assert len(h.sched.ledger.owned(SERVE)) == 1 and h.sched.preempts_done == 0
    assert any(f"tenant {SERVE}: admit" in d for d in h.sched.decisions)
    assert [s for s in h.rec.sent if s[1] == int(MC.SlotGrant)]  # to the agent


def test_a_preempt_parks_then_hands_the_slot_over_exclusively():
    def script(h):
        h.park()
        h.reg.set_demand(SERVE, 2)  # the floor: no second victim
        h.tick(1.0)

    h = _both(script)
    (slot,) = h.sched.ledger.owned(SERVE)
    assert slot.rank == 2 and slot.state == tsched.PARKED and slot.owners == [SERVE]
    assert slot.parked == dict(rank=2, tenant=TRAIN, incarnation=2, snapshot_id=0, lo=4, hi=8,
                               apply_seq=17, slot_id=slot.slot_id, borrower=SERVE,
                               grant_id=slot.grant_id)
    # the grant went out only after PreemptDone freed the slot
    assert h.grants == [(slot.grant_id, SERVE, 1, slot.slot_id)]
    codes = [c for _dst, c, _p in h.rec.sent]
    assert codes.index(int(MC.PreemptRequest)) < codes.index(int(MC.SlotGrant))
    assert h.sched.preempts_done == 1 and h.sched.ledger.audit() == []
    assert h.coord.parked_ranks() == {2} and h.sched._pending is None


def test_a_stale_preempt_done_is_logged_and_ignored():
    def script(h):
        h.reg.set_demand(SERVE, 1)
        h.tick()
        gid = h.sched._pending["grant_id"]
        h.handle(1, "PreemptDone", h.co.encode_preempt_done(gid, 0, 0, 4, 3))  # wrong rank
        h.handle(2, "PreemptDone", h.co.encode_preempt_done(gid + 5, 0, 4, 8, 3))

    h = _both(script)
    assert h.sched.preempts_done == 0 and h.sched._pending is not None
    assert sum("stale PreemptDone" in d for d in h.sched.decisions) == 2


def test_a_parked_rank_is_exempt_from_lease_expiry():
    def script(h):
        h.park()
        h.tick(50.0, coord=True)  # past every lease

    h = _both(script, lease=2.0)
    assert 2 in h.coord.members and 1 not in h.coord.members


def test_a_parked_shard_defers_the_snapshot_barrier():
    def script(h):
        h.park()
        h.coord.trigger_snapshot()
        h.tick(0.1, coord=True)

    h = _both(script)
    assert any("snapshot request deferred" in e for e in h.coord.events)
    assert h.coord._snap is None


def test_a_resume_completes_when_the_rank_rejoins_newer():
    def script(h):
        h.park()
        h.reg.set_demand(SERVE, 0)  # off-peak
        h.tick(1.0)
        h.handle(2, "CoordJoin", h.co.encode_join(h.co.KIND_SHARD, 3))  # the new life
        h.tick(0.5)

    h = _both(script)
    (slot,) = [s for s in h.sched.ledger.slots.values() if s.rank == 2]
    assert slot.state == tsched.HELD and slot.owners == [TRAIN] and slot.parked is None
    assert h.resumes and h.resumes[0][1]["rank"] == 2
    assert h.grants[-1][1:3] == (SERVE, 0)  # the revoke before the restore
    assert [c for _d, c, _p in h.rec.sent].count(int(MC.ResumeRequest)) == 1
    assert h.sched.resumes_done == 1 and len(h.sched.resume_mttrs) == 1
    assert h.coord.parked_ranks() == set() and h.sched.ledger.audit() == []


def test_a_resume_timeout_falls_back_to_parked():
    def script(h):
        h.park()
        h.reg.set_demand(SERVE, 0)
        h.tick()
        h.tick(6.0)  # no rejoin arrives

    h = _both(script, resume_timeout=5.0)
    (slot,) = [s for s in h.sched.ledger.slots.values() if s.rank == 2]
    assert slot.state == tsched.PARKED and slot.parked["rank"] == 2
    assert h.sched.resumes_done == 0 and any("ABANDONED" in d for d in h.sched.decisions)


def test_a_preempt_never_answered_is_abandoned():
    def script(h):
        h.reg.set_demand(SERVE, 1)
        h.tick()
        h.tick(31.0)

    h = _both(script)
    assert h.sched.preempts_aborted >= 1 and h.sched.preempts_done == 0


def test_decisions_ride_a_capped_ring_with_tenant_ids():
    def script(h):
        for i in range(600):
            h.sched._log(SERVE, f"decision {i}")

    h = _both(script)
    assert (h.sched.decisions.total, len(h.sched.decisions), h.sched.decisions.dropped) == (
        600, 512, 88)
    assert all(d.startswith(f"tenant {SERVE}:") for d in h.sched.decisions)
    assert h.sched.summary()["decisions_dropped"] == 88


def test_require_manifest_gates_the_preempt_behind_the_barrier():
    def script(h):
        h.reg.set_demand(SERVE, 1)
        h.tick()
        assert h.sched._pending["snap_requested"] and not h.sched._pending["sent"]
        h.tick()
        assert not h.sched._pending["sent"]  # the barrier still in flight
        h.coord.manifests_written += 1
        h.coord.last_manifest = type("M", (), {"snapshot_id": 7})()
        h.tick()

    h = _both(script, require_manifest=True)
    assert h.sched._pending["sent"] and h.sched._pending["snap_id"] == 7
    assert any("snapshot 7" in d for d in h.sched.decisions)
    assert h.coord._snap_requested


def test_a_dropped_exclusivity_gate_double_grants_and_audit_says_so():
    def script(h):
        h.park()

    h = _both(script, enforce_exclusive=False)
    assert any("exclusivity off" in d for d in h.sched.decisions)
    assert len(h.grants) == 2


# ------------------------------------------------------- engine scaling

@pytest.mark.parametrize("occ,ttft,n_engines,expect", [
    (95, 40.0, 1, "up"), (10, 900.0, 1, "up"), (5, 10.0, 2, "down"), (5, 10.0, 1, None),
    (50, 40.0, 2, None)])
def test_engine_scaling_advice_fires_on_scale_within_its_cooldown(occ, ttft, n_engines, expect):
    out = {}
    for name, co, mc in (("jax", jco, jmsg.MessageCode), ("port", tco, MC)):
        now = [0.0]
        calls = []
        coord = co.Coordinator(_Recorder(), 8, lease=60.0, speculation=False,
                               engine_occ_high=0.85, engine_occ_low=0.2,
                               engine_slo_ttft_ms=500.0, scale_cooldown=1.0,
                               on_scale=lambda d, detail: calls.append((d, detail)),
                               clock=lambda: now[0])
        got = [coord.check_engine_scaling(now[0])]  # nobody reported
        for rank in range(1, 1 + n_engines):
            coord.handle(rank, mc.CoordJoin, co.encode_join(co.KIND_ENGINE, rank))
            coord.handle(rank, mc.LeaseRenew, co.encode_renew(rank, push_count=occ, step=4,
                                                              ewma_ms=ttft))
        got.append(coord.check_engine_scaling(now[0]))
        got.append(coord.check_engine_scaling(now[0]))  # inside the cooldown
        now[0] = 1.5
        coord.tick()
        out[name] = (got, calls, list(coord.scale_advice), list(coord.events))
    assert out["port"] == out["jax"]
    got, calls = out["port"][0], out["port"][1]
    assert got[:3] == [None, expect, None]
    assert [c[0] for c in calls] == ([expect, expect] if expect else [])


def test_engine_scaling_is_off_at_zero_thresholds():
    coord = tco.Coordinator(None, 8, on_scale=pytest.fail)
    coord.handle(1, MC.CoordJoin, tco.encode_join(tco.KIND_ENGINE, 1))
    coord.handle(1, MC.LeaseRenew, tco.encode_renew(1, push_count=100))
    assert coord.check_engine_scaling() is None and not coord.scale_advice


# ----------------------------------------------------- the durable park table

def _durable(pkg, d, lease=60.0, **kw):
    return _H(pkg, register=False, lease=lease, coord_kw=dict(durable_dir=str(d / "coord"), **kw))


def _first_life(pkg, d, checkpoint):
    """Joins, the scheduler's slots, a park; the park's checkpoint taken
    (``checkpoint``) or the life dying with the park in its log alone."""
    h = _durable(pkg, d)
    for rank in (1, 2):
        h.handle(rank, "CoordJoin", h.co.encode_join(h.co.KIND_SHARD, 100 + rank))
        h.sched.register_member_slot(rank, TRAIN)
    h.tick(0.1, coord=True)
    h.park()
    if checkpoint:
        h.tick(0.1, coord=True)  # the park asks for a checkpoint
    return h


@pytest.mark.parametrize("checkpoint", [True, False], ids=["ckpt", "wal_alone"])
def test_the_first_lifes_park_files_equal_jax_byte_for_byte(tmp_path, checkpoint):
    views = {}
    for pkg in ("jax", "port"):
        h = _first_life(pkg, tmp_path / pkg, checkpoint)
        views[pkg] = (h.view(), {f: (tmp_path / pkg / "coord" / f).read_bytes()
                                 for f in FILES if (tmp_path / pkg / "coord" / f).exists()})
    assert views["port"] == views["jax"]
    files = views["port"][1]
    if checkpoint:
        state = json.loads(files[tco.COORD_CKPT_NAME])
        assert list(state["parked"]) == ["2"] and state["sched"]["slots"]
    else:
        assert tco.COORD_CKPT_NAME not in files


@pytest.mark.parametrize("checkpoint", [True, False], ids=["ckpt", "wal_alone"])
@pytest.mark.parametrize("first,second", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_a_restart_neither_expires_nor_strands_the_parked_rank(tmp_path, checkpoint, first,
                                                               second):
    _first_life(first, tmp_path, checkpoint)
    views = {}
    for pkg in {second, "jax"}:
        # the same directory twice: copy it for the reference's own restart
        d = tmp_path / f"life2_{pkg}"
        os.makedirs(d / "coord")
        for f in FILES:
            src = tmp_path / "coord" / f
            if src.exists():
                (d / "coord" / f).write_bytes(src.read_bytes())
        h = _durable(pkg, d, lease=2.0)
        h.reg.set_demand(SERVE, 1)  # the borrower still wants its slot
        before = sorted(h.coord._grace_pending)
        h.tick(50.0, coord=True)  # the grace window and every lease pass
        views[pkg] = (before, h.view(), h.coord.restored_members)
    port = views[second]
    assert port == views["jax"]
    before, view, _restored = port
    assert before == [1]  # the parked rank is not awaited
    assert view["parked"] == [2] and 2 in view["members"] and 1 not in view["members"]
    (slot,) = [s for s in view["slots"].values() if s[0] == 2]
    assert slot[2] == tsched.PARKED and slot[1] == [SERVE] and slot[4]["rank"] == 2


def test_a_restart_resumes_the_parked_rank_without_a_second_grant(tmp_path):
    out = {}
    for pkg in ("jax", "port"):
        _first_life(pkg, tmp_path / pkg, checkpoint=False)
        h = _durable(pkg, tmp_path / pkg)
        h.reg.set_demand(SERVE, 1)
        h.tick(0.1)  # the restored borrower holds its slot: no second preempt
        h.reg.set_demand(SERVE, 0)
        h.tick(0.1)
        h.handle(2, "CoordJoin", h.co.encode_join(h.co.KIND_SHARD, 999))
        h.tick(0.1)
        out[pkg] = h.view()
    assert out["port"] == out["jax"]
    h_port = out["port"]
    assert h_port["parked"] == [] and h_port["summary"]["resumes_done"] == 1
    assert h_port["summary"]["preempts_done"] == 0 and h_port["summary"]["audit"] == []


def test_restore_parked_false_forgets_the_table(tmp_path):
    out = {}
    for pkg in ("jax", "port"):
        _first_life(pkg, tmp_path / pkg, checkpoint=True)
        h = _durable(pkg, tmp_path / pkg, lease=2.0, restore_parked=False)
        h.tick(50.0, coord=True)
        out[pkg] = h.view()
    assert out["port"] == out["jax"]
    assert out["port"]["parked"] == [] and 2 not in out["port"]["members"]


# ---------------------------------------------------------------- the wire

@pytest.mark.parametrize("name,args", [
    ("encode_preempt_request", (70000, 3)), ("encode_preempt_done", (70000, 3, 5, 131072, 9)),
    ("encode_slot_grant", (65537, 2, 1, 4)), ("encode_resume_request", (5, 2, 70001))])
def test_the_schedulers_frames_equal_jax(name, args):
    assert _b(getattr(tco, name)(*args)) == _b(getattr(jco, name)(*args))


@pytest.mark.parametrize("op", [
    {"op": "park", "rank": 2, "parked": {"rank": 2, "tenant": 1, "incarnation": 7,
                                         "snapshot_id": 3, "lo": 4, "hi": 8, "apply_seq": 17,
                                         "slot_id": 1, "borrower": 2, "grant_id": 5}},
    {"op": "unpark", "rank": 2}])
def test_the_park_records_equal_jax(op):
    assert _b(tco._op_to_f32(op)) == _b(jco._op_to_f32(op))
    assert tco._f32_to_op(jco._op_to_f32(op)) == op


def test_the_member_hands_the_schedulers_frames_to_its_callbacks_as_jax():
    frames = [
        ("PreemptRequest", jco.encode_preempt_request(70000, 3)),
        ("SlotGrant", jco.encode_slot_grant(65537, 2, 1, 4)),
        ("ResumeRequest", jco.encode_resume_request(5, 2, 70001)),
        ("PreemptRequest", np.asarray([np.nan, 0, 0, 0], np.float32)),  # dropped
        ("SlotGrant", np.zeros(3, np.float32)),  # too short
    ]
    out = {}
    for name, mod, mc in (("jax", jmem, jmsg.MessageCode), ("port", tmem, MC)):
        world = InProcessTransport.create_world(2)
        client = mod.CoordClient(world[1], "agent", renew_interval=60.0)
        seen = []
        client.on_preempt = lambda *a: seen.append(("preempt", a))
        client.on_slot_grant = lambda *a: seen.append(("grant", a))
        client.on_resume = lambda *a: seen.append(("resume", a))
        try:
            for code, payload in frames:
                client._handle(getattr(mc, code), tmsg.stamp_epoch(payload, 1))
        finally:
            client.stop()
            for t in world.values():
                t.close()
        out[name] = seen
    assert out["port"] == out["jax"]
    assert out["port"] == [("preempt", (70000, 3)), ("grant", (65537, 2, 1, 4)),
                           ("resume", (5, 2, 70001))]


def test_preempt_done_reaches_the_coordinator_as_jax():
    out = {}
    for name, mod in (("jax", jmem), ("port", tmem)):
        world = InProcessTransport.create_world(2)
        client = mod.CoordClient(world[1], "shard", renew_interval=60.0)
        try:
            client.preempt_done(70000, 3, 5, 131072, 9)
            msg = world[0].recv(timeout=2)
        finally:
            client.stop()
            for t in world.values():
                t.close()
        out[name] = (int(msg[1]), _b(msg[2]))
    assert out["port"] == out["jax"] == (int(MC.PreemptDone),
                                         _b(tco.encode_preempt_done(70000, 3, 5, 131072, 9)))


# --------------------------------------------- the park mailbox and the hold

class _Member:
    """Just enough member surface for a shard server's serve loop."""

    on_snapshot = on_rollback = on_preempt = None
    fleet = type("Fleet", (), {"workers_done": staticmethod(lambda: False)})()

    def __init__(self):
        self.dones, self.stopped, self.closed = [], False, False

    def join(self):
        return None

    def report(self, *a, **k):
        pass

    def report_gray_health(self, **k):
        pass

    def take_shard_map(self):
        return None

    def preempt_done(self, *a):
        self.dones.append(a)

    def stop(self):
        self.stopped = True

    def close(self):
        self.closed = True


def _push(lo, hi, v):
    head = [x for n in (1, lo, hi) for x in tmsg._split16(n)]
    return np.concatenate([np.asarray(head, np.float32), np.full(hi - lo, v, np.float32)])


def test_a_parked_server_commits_reports_and_stops_without_a_leave(tmp_path):
    world = InProcessTransport.create_world(2)
    member = _Member()
    srv = tel.ElasticShardServer(2, 10, world[0], member, init_params=np.zeros(10, np.float32),
                                 ckpt_dir=str(tmp_path / "s"), wal=True, wal_group_n=100)
    try:
        assert member.on_preempt == srv._note_preempt
        srv._apply_map(ShardMap(1, 10, [ShardEntry(2, 0, 10)]))
        srv.handle(1, MC.ShardPush, _push(0, 10, 1.0))
        srv.handle(1, MC.ShardPush, _push(0, 10, 2.0))
        assert srv.ps.wal.pending == 2  # the open group
        srv._note_preempt(4, 3)
        srv._note_preempt(5, 3)  # the newest grant wins
        world[1].send(MC.ShardPush, _push(0, 10, 7.0))  # left in the inbox
        srv.run(timeout=5)
        assert member.dones == [(5, 3, 0, 10, 2)] and srv.parked
        assert member.stopped and not member.closed  # no CoordLeave
        assert srv.ps.wal.pending == 0 and srv.ps._apply_seq == 2
        assert not os.path.exists(tmp_path / "s" / "ps_meta.json")  # no checkpoint
        assert world[0].recv(timeout=0.5) is not None  # unserved, for the next life
        srv._note_preempt(5, 3)  # a redelivery after the park
        assert srv._take_preempt_request() == (5, 3) and member.dones == [(5, 3, 0, 10, 2)]
    finally:
        for t in world.values():
            t.close()


def test_the_resume_compares_the_whole_range(tmp_path):
    """``resume_parked_shard`` holds the restored server to the parked one
    over the whole range: a difference in the second shard's last value is
    found, where the reference's ``central[lo:hi]`` of the range-local
    vector compares two empty slices."""
    from distributed_ml_pytorch_tpu_torch.coord.drill import resume_parked_shard
    from distributed_ml_pytorch_tpu_torch.coord.manifest import FleetManifest, ShardRecord

    path = str(tmp_path / "fleet_manifest.json")
    worlds = [InProcessTransport.create_world(2) for _ in range(3)]

    def server(k):
        srv = tel.ElasticShardServer(2, 10, worlds[k][0], _Member(),
                                     init_params=np.zeros(10, np.float32),
                                     ckpt_dir=str(tmp_path / "s"), wal=True)
        srv._apply_map(ShardMap(1, 10, [ShardEntry(1, 0, 5), ShardEntry(2, 5, 10)]))
        return srv

    try:
        old = server(0)
        for v in (1.0, 2.0):
            old.handle(1, MC.ShardPush, _push(5, 10, v))
        old.ps.commit()
        old.ps.save_checkpoint()
        FleetManifest(snapshot_id=1, map_version=1, n_params=10, shards=(
            ShardRecord(1, 0, 5, 1, 0, 0), ShardRecord(2, 5, 10, 1, 2, 2))).write(path)
        old.handle(1, MC.ShardPush, _push(5, 10, 4.0))  # only the WAL holds it
        old.ps.commit()
        new, identical = resume_parked_shard(old, lambda: server(1), path, 1)
        assert identical and new.ps.replayed_updates == 1 and new.ps._apply_seq == 3
        lo, hi = old.lo, old.hi
        assert old.ps.central[lo:hi].size == 0  # the reference's slice
        old.ps.central[-1] += 1.0
        _new, identical = resume_parked_shard(old, lambda: server(2), path, 1)
        assert not identical
        with pytest.raises(FileNotFoundError):
            resume_parked_shard(old, lambda: server(2), path, 0)
    finally:
        for w in worlds:
            for t in w.values():
                t.close()


class _FakeCoord:
    on_rollback = None

    def __init__(self):
        self.maps = []

    def report(self, *a, **k):
        pass

    def report_gray_health(self, *a, **k):
        pass

    def take_shard_map(self):
        return self.maps.pop(0) if self.maps else None


def _drain(world):
    out = []
    while (msg := world[0].recv(timeout=0.2)) is not None:
        out.append(int(msg[1]))
    return out


def _hold_script(make_opt, step, worlds):
    """Hold shard 2 for four steps, then release it: per step, the codes
    each shard got and the held pushes."""
    opt = make_opt()
    got = [[_drain(w) for w in worlds]]
    for k in range(6):
        if k == 1:
            opt.hold_shard(2)
        if k == 5:
            opt.release_shard(2)
        step(opt)
        opt._flusher.drain()
        got.append([_drain(w) for w in worlds])
    return opt, got


def test_a_held_shard_gets_nothing_as_from_the_jax_client():
    import jax
    import jax.numpy as jnp

    from distributed_ml_pytorch_tpu.parallel.sharded_ps import ShardedAsynchronous as JSA
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import ShardedAsynchronous

    net = get_model("lenet", seed=0, device="cpu")
    n = sum(p.numel() for p in net.parameters())
    m = ShardMap(1, n, [ShardEntry(1, 0, n // 2), ShardEntry(2, n // 2, n)])
    jm = jsm.ShardMap(1, n, [jsm.ShardEntry(1, 0, n // 2), jsm.ShardEntry(2, n // 2, n)])
    out = {}
    opts = []
    try:
        for name in ("jax", "port"):
            worlds = [InProcessTransport.create_world(2) if name == "port"
                      else jmsg.InProcessTransport.create_world(2) for _ in range(2)]
            if name == "port":
                def make(worlds=worlds):
                    return ShardedAsynchronous(
                        net, lr=0.05, n_push=1, n_pull=2, transports=[w[1] for w in worlds],
                        coord=_FakeCoord(), transport_factory=lambda e: worlds[e.server_id - 1][1],
                        shard_map=m)

                def step(opt):
                    for p in net.parameters():
                        p.grad = torch.full_like(p, 0.01)
                    opt.step()
            else:
                params = {"w": jnp.zeros((n,), jnp.float32)}

                def make(worlds=worlds):
                    return JSA(params, lr=0.05, n_push=1, n_pull=2,
                               transports=[w[1] for w in worlds], coord=_FakeCoord(),
                               transport_factory=lambda e: worlds[e.server_id - 1][1],
                               shard_map=jm)

                def step(opt, params=params):
                    opt.step(params, jax.tree.map(lambda p: jnp.full_like(p, 0.01), params))
            opt, got = _hold_script(make, step, worlds)
            opts.append((opt, worlds))
            out[name] = (got, opt.held_pushes, list(opt.shard_held))
    finally:
        for opt, worlds in opts:
            opt._flusher.stop()
            for listener in opt.listeners:
                listener.stop()
            for w in worlds:
                for t in w.values():
                    t.close()
    assert out["port"] == out["jax"]
    got, held, flags = out["port"]
    assert held == 4 and flags == [False, False]
    for k in range(2, 6):  # held steps: shard 2 gets nothing, shard 1 its push
        assert got[k][1] == [] and int(MC.ShardPush) in got[k][0]
    assert int(MC.ShardPush) in got[6][1]


def test_the_hold_survives_a_cutover_that_rebuilds_the_transports():
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import ShardedAsynchronous

    net = get_model("lenet", seed=0, device="cpu")
    n = sum(p.numel() for p in net.parameters())
    worlds = {sid: InProcessTransport.create_world(2) for sid in (1, 2, 3)}
    m1 = ShardMap(1, n, [ShardEntry(1, 0, n // 2), ShardEntry(2, n // 2, n)])
    coord = _FakeCoord()
    opt = ShardedAsynchronous(net, lr=0.05, n_push=1, n_pull=1,
                              transports=[worlds[1][1], worlds[2][1]], coord=coord,
                              transport_factory=lambda e: worlds[e.server_id][1], shard_map=m1)
    try:
        for w in worlds.values():
            _drain(w)
        opt.hold_shard(2)
        # a third shard joins: the cutover builds its transport, keeps the hold
        third = n - n // 3
        m2 = ShardMap(2, n, [ShardEntry(1, 0, n // 3), ShardEntry(3, n // 3, third, n // 3, n // 2),
                             ShardEntry(2, third, n)])
        coord.maps.append(m2)
        for p in net.parameters():
            p.grad = torch.full_like(p, 0.01)
        opt.step()
        opt.step()
        opt._flusher.drain()
        assert opt.server_ids == [1, 3, 2] and opt.shard_held == [False, False, True]
        assert _drain(worlds[2]) == []
        got1, got3 = _drain(worlds[1]), _drain(worlds[3])
        assert int(MC.ShardPush) in got1 and int(MC.RangeInstall) in got3
        assert opt.held_pushes >= 1
        opt.release_shard(2)
        opt.step()
        opt._flusher.drain()
        assert int(MC.ShardPush) in _drain(worlds[2]) and opt.shard_held == [False] * 3
    finally:
        opt._flusher.stop()
        for listener in opt.listeners:
            listener.stop()
        for w in worlds.values():
            for t in w.values():
                t.close()


def test_sched_plane_exports():
    from distributed_ml_pytorch_tpu_torch import coord

    for name in ("FleetScheduler", "CapacityLedger", "Slot"):
        assert getattr(coord, name) is getattr(tsched, name)
    for name in ("Tenant", "TenantRegistry"):
        assert getattr(coord, name) is getattr(tten, name)
    assert (coord.TENANT_TRAINING, coord.TENANT_SERVING, coord.TENANT_MPMD) == (
        jten.TENANT_TRAINING, jten.TENANT_SERVING, jten.TENANT_MPMD)
    for state in ("FREE", "HELD", "PARKING", "PARKED", "RESUMING"):
        assert getattr(tsched, state) == getattr(jsched, state)
