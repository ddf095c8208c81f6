"""The multi-tenant fleet scheduler (counterpart of the JAX
``coord/sched.py``).

DistBelief ran on a shared cluster, where training jobs, pipelines and
serving fleets competed for the same machines and the coordinator assigned
work to whatever capacity existed. Here tenants (``coord/tenants.py``)
register demands with priorities, and :class:`FleetScheduler` owns a
:class:`CapacityLedger` over the coordinator's members and places them:

- **admit / pack**: a free slot is granted directly (a ``SlotGrant`` to the
  node agent, which spawns the tenant's member kind).
- **preempt**: when a higher-priority tenant's demand is unmet, the
  scheduler parks a lower-priority training member. It first drives a fleet
  snapshot barrier (the ``FleetManifest`` the park restores from, gated by
  ``require_manifest``), then sends ``PreemptRequest``; the victim commits
  its WAL group, reports ``PreemptDone`` and stops serving without a
  ``CoordLeave``. A parked life is not a dead one: its lease is exempt from
  expiry, its shard-map range stays, so the workers hold their pushes to
  it, and a resume rejoins the same range.
- **resume**: off-peak the grant is revoked (the agent retires the
  borrowed member) and a ``ResumeRequest`` tells the agent to restore the
  parked member bit for bit: a fresh ``ElasticShardServer`` over the
  manifest's checkpoint and exactly-once WAL replay
  (``restore_from_manifest``), rejoining as a newer incarnation of the
  same rank.

The ledger is exclusive by construction: the waiting tenant gets the slot
only after the victim's ``PreemptDone`` frees it (``enforce_exclusive``;
:meth:`CapacityLedger.audit` is the runtime detector of a double grant).

Like every coordinator decision, scheduling is synchronous and takes the
clock as an argument: ``tick(now)`` runs on the coordinator's serve thread
(``Coordinator.tick`` drives it, ``Coordinator.handle`` routes
``PreemptDone`` to it), so tests drive the whole protocol with ``handle``
and ``tick`` calls and a fake clock. Decisions go to a capped
:class:`~..utils.obs.BoundedEvents` ring, each carrying its tenant id.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

from distributed_ml_pytorch_tpu_torch.coord.coordinator import (
    encode_preempt_request,
    encode_resume_request,
    encode_slot_grant,
)
from distributed_ml_pytorch_tpu_torch.coord.tenants import Tenant, TenantRegistry
from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode
from distributed_ml_pytorch_tpu_torch.utils.obs import BoundedEvents

_LOGGER = logging.getLogger(__name__)

#: slot states
FREE = "free"          # unowned capacity
HELD = "held"          # a tenant's member runs here
PARKING = "parking"    # preempt in flight: snapshot barrier / PreemptRequest
PARKED = "parked"      # victim parked under a manifest; slot re-granted
RESUMING = "resuming"  # ResumeRequest sent; awaiting the rank's new life


@dataclasses.dataclass
class Slot:
    """One schedulable unit of fleet capacity.

    ``owners`` is a list, so the ledger can represent the illegal state of
    two tenants owning one slot instead of collapsing it: a detector that
    cannot represent the bug detects nothing. ``parked`` is the parked
    member's restore ticket (rank, old incarnation, snapshot id, its
    ``[lo, hi)`` range and apply seq at the park, and the borrowing side of
    the hand-over)."""

    slot_id: int
    rank: Optional[int] = None  # coordinator rank of the occupying member
    owners: List[int] = dataclasses.field(default_factory=list)
    state: str = FREE
    grant_id: int = 0
    parked: Optional[dict] = None


class CapacityLedger:
    """Who owns which slot: the scheduler's one source of truth.

    With ``enforce_exclusive`` a grant over a slot another tenant still owns
    is refused until the preempt protocol frees it; without it,
    :meth:`audit` reports every slot the missing gate corrupted."""

    def __init__(self, *, enforce_exclusive: bool = True) -> None:
        self.enforce_exclusive = bool(enforce_exclusive)
        self.slots: Dict[int, Slot] = {}
        self._next_slot = 0

    def add_slot(self, *, rank: Optional[int] = None,
                 tenant_id: Optional[int] = None) -> Slot:
        slot = Slot(slot_id=self._next_slot, rank=rank)
        self._next_slot += 1
        if tenant_id is not None:
            slot.owners.append(int(tenant_id))
            slot.state = HELD
        self.slots[slot.slot_id] = slot
        return slot

    def owned(self, tenant_id: int) -> List[Slot]:
        return [s for s in self.slots.values() if tenant_id in s.owners]

    def free_slots(self) -> List[Slot]:
        return [s for s in self.slots.values() if not s.owners and s.state == FREE]

    def grant(self, slot: Slot, tenant_id: int, grant_id: int) -> bool:
        """Grant ``slot`` to ``tenant_id``; False when exclusivity refuses."""
        others = [o for o in slot.owners if o != tenant_id]
        if others and self.enforce_exclusive:
            return False
        if tenant_id not in slot.owners:
            slot.owners.append(int(tenant_id))
        slot.grant_id = int(grant_id)
        return True

    def release(self, slot: Slot, tenant_id: int) -> None:
        if tenant_id in slot.owners:
            slot.owners.remove(tenant_id)

    def audit(self) -> List[str]:
        """Every slot with more than one owner, as a violation."""
        return [f"slot {s.slot_id} double-granted: owned by tenants {sorted(set(s.owners))}"
                for s in self.slots.values() if len(set(s.owners)) > 1]


class FleetScheduler:
    """Placement decisions over the coordinator's members.

    The constructor attaches it (``coord.sched = self``); a durable
    coordinator restarted over a directory with scheduler or park records
    re-seeds the ledger from them here. Actuation goes to the node agent at
    ``actuator_rank`` over the wire (``SlotGrant`` / ``ResumeRequest``)
    and/or to the in-process ``on_grant(grant_id, tenant_id, action, slot)``
    and ``on_resume(grant_id, parked)`` callbacks a colocated harness sets.
    A preempt or a resume not done within ``preempt_timeout`` or
    ``resume_timeout`` seconds is abandoned (the slot goes back to held, or
    stays parked)."""

    def __init__(self, coord, *, registry: Optional[TenantRegistry] = None,
                 require_manifest: bool = True, enforce_exclusive: bool = True,
                 actuator_rank: Optional[int] = None, preempt_timeout: float = 30.0,
                 resume_timeout: float = 30.0) -> None:
        self.coord = coord
        self.registry = registry if registry is not None else TenantRegistry()
        self.ledger = CapacityLedger(enforce_exclusive=enforce_exclusive)
        #: park only under a durable manifest: without it, the parked state
        #: may be unrestorable (acked deltas lost)
        self.require_manifest = bool(require_manifest)
        self.actuator_rank = actuator_rank
        self.preempt_timeout = float(preempt_timeout)
        self.resume_timeout = float(resume_timeout)
        #: the capped decision ring; the scheduler holds no unbounded maps
        self.decisions = BoundedEvents(maxlen=512)
        self.on_grant = None
        self.on_resume = None
        self._next_grant = 1
        self._pending: Optional[dict] = None    # one preempt in flight
        self._resuming: Optional[dict] = None   # one resume in flight
        self.preempts_done = 0
        self.preempts_aborted = 0
        self.resumes_done = 0
        self.preempt_mttrs: List[float] = []
        self.resume_mttrs: List[float] = []
        coord.sched = self
        if getattr(coord, "_sched_restore", None) is not None \
                or getattr(coord, "_parked_durable", None):
            coord._restore_sched_state(self)

    # ---------------------------------------------------------- bookkeeping
    def _log(self, tenant_id: int, msg: str) -> None:
        line = f"tenant {tenant_id}: {msg}"
        self.decisions.append(line)
        # mirrored onto the coordinator's decision log
        self.coord.events.append(f"sched {line}")
        _LOGGER.info("sched: %s", line)

    def parked_ranks(self) -> set:
        """Ranks whose silence is a park, not a death: the coordinator's
        lease expiry and snapshot barrier exempt them."""
        return {s.parked["rank"] for s in self.ledger.slots.values()
                if s.parked is not None and s.state in (PARKED, RESUMING)}

    def register_member_slot(self, rank: int, tenant_id: int) -> Slot:
        """Record an existing member as a tenant-held slot."""
        return self.ledger.add_slot(rank=rank, tenant_id=tenant_id)

    def summary(self) -> dict:
        return {
            "preempts_done": self.preempts_done,
            "preempts_aborted": self.preempts_aborted,
            "resumes_done": self.resumes_done,
            "preempt_mttr_s": list(self.preempt_mttrs),
            "resume_mttr_s": list(self.resume_mttrs),
            "decisions_total": self.decisions.total,
            "decisions_dropped": self.decisions.dropped,
            "audit": self.ledger.audit(),
            "slots": {s.slot_id: {"state": s.state, "owners": sorted(set(s.owners)),
                                  "rank": s.rank}
                      for s in self.ledger.slots.values()},
        }

    # ----------------------------------------------------------------- tick
    def tick(self, now: float) -> None:
        """One scheduling pass (the coordinator's serve thread)."""
        self._drive_pending(now)
        self._drive_resuming(now)
        self._evaluate(now)

    def _evaluate(self, now: float) -> None:
        for tenant in self.registry.all():  # priority-descending
            have = len(self.ledger.owned(tenant.tenant_id))
            if self._pending is not None and self._pending["for"] == tenant.tenant_id:
                have += 1  # a preempt already in flight counts as packed
            shortfall = tenant.demand - have
            if shortfall > 0:
                self._pack(tenant, shortfall, now)
            elif shortfall < 0:
                self._shrink(tenant, -shortfall, now)

    def _pack(self, tenant: Tenant, shortfall: int, now: float) -> None:
        for slot in self.ledger.free_slots():
            if shortfall <= 0:
                return
            gid = self._next_grant
            self._next_grant += 1
            self.ledger.grant(slot, tenant.tenant_id, gid)
            slot.state = HELD
            shortfall -= 1
            self._log(tenant.tenant_id, f"admit: free slot {slot.slot_id} granted (grant {gid})")
            self._actuate_grant(gid, tenant.tenant_id, 1, slot)
        if shortfall <= 0 or self._pending is not None:
            return
        victim = self._pick_victim(tenant)
        if victim is None:
            return
        slot, victim_tenant = victim
        if not self.ledger.enforce_exclusive:
            # capacity handed over before the victim's park completes: the
            # ledger shows two owners, and audit() flags it
            gid = self._next_grant
            self._next_grant += 1
            self.ledger.grant(slot, tenant.tenant_id, gid)
            self._log(tenant.tenant_id,
                      f"grant of slot {slot.slot_id} issued while tenant "
                      f"{victim_tenant.tenant_id} still holds it (exclusivity off)")
            self._actuate_grant(gid, tenant.tenant_id, 1, slot)
        self._start_preempt(slot, victim_tenant, tenant, now)

    def _pick_victim(self, tenant: Tenant):
        """The lowest-priority held slot: never a peer's or a superior's,
        never below its owner's ``min_slots``."""
        for victim in self.registry.by_priority_asc():
            if victim.priority >= tenant.priority:
                return None
            owned = [s for s in self.ledger.owned(victim.tenant_id)
                     if s.state == HELD and s.rank is not None]
            if len(owned) <= victim.min_slots or not owned:
                continue
            return owned[-1], victim
        return None

    def _shrink(self, tenant: Tenant, surplus: int, now: float) -> None:
        if self._resuming is not None:
            return
        # parked-backed slots first: releasing one both retires the
        # borrowed member and resumes the parked victim
        owned = sorted(self.ledger.owned(tenant.tenant_id), key=lambda s: s.parked is None)
        for slot in owned[:surplus]:
            if slot.state not in (HELD, PARKED):
                continue
            self.ledger.release(slot, tenant.tenant_id)
            self._log(tenant.tenant_id,
                      f"release: slot {slot.slot_id} revoked (grant {slot.grant_id})")
            self._actuate_grant(slot.grant_id, tenant.tenant_id, 0, slot)
            if slot.parked is not None:
                self._start_resume(slot, now)
                return  # one resume in flight at a time
            slot.state = FREE

    # -------------------------------------------------------------- preempt
    def _start_preempt(self, slot: Slot, victim: Tenant, for_tenant: Tenant,
                       now: float) -> None:
        slot.state = PARKING
        gid = self._next_grant
        self._next_grant += 1
        self._pending = {
            "slot": slot, "victim": victim.tenant_id, "for": for_tenant.tenant_id,
            "grant_id": gid, "started": now,
            "manifest_baseline": self.coord.manifests_written,
            "snap_requested": False, "sent": False,
        }
        self._log(for_tenant.tenant_id,
                  f"preempt: parking tenant {victim.tenant_id}'s member rank {slot.rank} "
                  f"(slot {slot.slot_id}, grant {gid}, manifest "
                  f"{'required' if self.require_manifest else 'SKIPPED'})")
        self._drive_pending(now)

    def _drive_pending(self, now: float) -> None:
        p = self._pending
        if p is None:
            return
        slot = p["slot"]
        if now - p["started"] > self.preempt_timeout:
            slot.state = HELD
            self.preempts_aborted += 1
            self._pending = None
            self._log(p["for"], f"preempt of slot {slot.slot_id} ABANDONED after "
                                f"{self.preempt_timeout:.0f}s (grant {p['grant_id']})")
            return
        if p["sent"]:
            return
        if self.require_manifest:
            if not p["snap_requested"]:
                p["snap_requested"] = True
                self.coord.trigger_snapshot()
                return
            if self.coord.manifests_written <= p["manifest_baseline"]:
                return  # the barrier is still in flight; the next tick looks again
            snap_id = int(self.coord.last_manifest.snapshot_id)
        else:
            lm = self.coord.last_manifest
            snap_id = int(lm.snapshot_id) if lm is not None else 0
        p["sent"] = True
        p["snap_id"] = snap_id
        self.coord._send(slot.rank, MessageCode.PreemptRequest,
                         encode_preempt_request(p["grant_id"], snap_id))
        self._log(p["for"], f"preempt: PreemptRequest grant {p['grant_id']} snapshot "
                            f"{snap_id} -> rank {slot.rank}")

    def on_preempt_done(self, sender: int, *, grant_id: int, snap_id: int, lo: int, hi: int,
                        apply_seq: int, now: float) -> None:
        """A victim's ``PreemptDone`` (routed by ``Coordinator.handle``)."""
        p = self._pending
        if p is None or grant_id != p["grant_id"] or p["slot"].rank != sender:
            self._log(-1, f"stale PreemptDone from rank {sender} (grant {grant_id})")
            return
        slot = p["slot"]
        member = self.coord.members.get(sender)
        parked = {
            "rank": sender,
            "tenant": p["victim"],
            "incarnation": member.incarnation if member is not None else 0,
            "snapshot_id": snap_id,
            "lo": lo,
            "hi": hi,
            "apply_seq": apply_seq,
            # the borrowing side of the hand-over: a coordinator that dies
            # between this park and its next checkpoint rebuilds the slot
            # (owner, grant and all) from the logged ticket alone
            "slot_id": slot.slot_id,
            "borrower": p["for"],
            "grant_id": grant_id,
        }
        # log the park before the ledger changes: a restart right after this
        # line restores the member as parked, never under a re-armed lease
        # and never with its slot handed out twice
        self.coord.note_parked(sender, parked)
        slot.parked = parked
        self.ledger.release(slot, p["victim"])
        slot.state = PARKED
        mttr = now - p["started"]
        self.preempts_done += 1
        self.preempt_mttrs.append(mttr)
        self._log(p["victim"], f"parked: rank {sender} [{lo},{hi}) at apply seq {apply_seq} "
                               f"under snapshot {snap_id} ({mttr * 1e3:.0f} ms)")
        # only now is the slot free for the waiting tenant
        self.ledger.grant(slot, p["for"], grant_id)
        self._log(p["for"], f"grant: slot {slot.slot_id} -> tenant {p['for']} "
                            f"(grant {grant_id})")
        self._actuate_grant(grant_id, p["for"], 1, slot)
        self._pending = None

    # --------------------------------------------------------------- resume
    def _start_resume(self, slot: Slot, now: float) -> None:
        slot.state = RESUMING
        gid = self._next_grant
        self._next_grant += 1
        self._resuming = {"slot": slot, "grant_id": gid, "started": now,
                          "incarnation": slot.parked["incarnation"]}
        self._log(slot.parked["tenant"],
                  f"resume: restoring rank {slot.parked['rank']} from snapshot "
                  f"{slot.parked['snapshot_id']} (grant {gid})")
        if self.actuator_rank is not None:
            self.coord._send(self.actuator_rank, MessageCode.ResumeRequest,
                             encode_resume_request(gid, slot.parked["rank"],
                                                   slot.parked["snapshot_id"]))
        if self.on_resume is not None:
            self.on_resume(gid, dict(slot.parked))

    def _drive_resuming(self, now: float) -> None:
        r = self._resuming
        if r is None:
            return
        slot = r["slot"]
        parked = slot.parked
        member = self.coord.members.get(parked["rank"])
        if member is not None and member.incarnation > r["incarnation"]:
            # the rank's new life joined: log the unpark first
            self.coord.note_unparked(parked["rank"])
            tenant_id = parked["tenant"]
            slot.parked = None
            slot.owners = [tenant_id]
            slot.state = HELD
            mttr = now - r["started"]
            self.resumes_done += 1
            self.resume_mttrs.append(mttr)
            self._resuming = None
            self._log(tenant_id, f"resumed: rank {parked['rank']} rejoined as inc "
                                 f"{member.incarnation} ({mttr * 1e3:.0f} ms) — slot "
                                 f"{slot.slot_id} back to tenant {tenant_id}")
            return
        if now - r["started"] > self.resume_timeout:
            slot.state = PARKED
            self._resuming = None
            self._log(parked["tenant"], f"resume of rank {parked['rank']} ABANDONED after "
                                        f"{self.resume_timeout:.0f}s — still parked")

    # ------------------------------------------------------------- actuation
    def _actuate_grant(self, grant_id: int, tenant_id: int, action: int, slot: Slot) -> None:
        if self.actuator_rank is not None:
            self.coord._send(self.actuator_rank, MessageCode.SlotGrant,
                             encode_slot_grant(grant_id, tenant_id, action, slot.slot_id))
        if self.on_grant is not None:
            self.on_grant(grant_id, tenant_id, action, slot)
