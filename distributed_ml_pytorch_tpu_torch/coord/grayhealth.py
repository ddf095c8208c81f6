"""The gray-failure plane (counterpart of the JAX ``coord/grayhealth.py``):
adaptive suspicion and a containment ladder that degrades instead of
killing.

Every failure the coordinator could see before this module is fail-stop: a
member dies, its lease expires, drills restore it. The production
pathology DistBelief actually fights is the GRAY member — it renews its
lease on time while its data plane rots (lossy NIC driving retransmit
storms, a one-way partition, fsync stalls), silently dragging fleet
goodput. The evidence already exists on every plane (ReliableTransport
retransmit/nack/blocked-send stats, WAL fsync spans, serve-loop busy
ratios); it ships on the LeaseRenew tail (``encode_renew``'s gray-health
fields and per-link triples) and this module consumes it as a failure
signal.

Detection — :class:`GrayHealth` keeps, per member AND per directed link:

- a phi-accrual-style inter-arrival history of lease renewals (adaptive:
  the suspicion grows with how surprising the current silence is against
  THAT member's own arrival distribution, not a fixed timeout), and
- an adaptive baseline (EW mean/std) of the reported data-plane evidence,
  FROZEN while the member is under suspicion so the anomaly cannot train
  its own baseline. The suspicion score is the evidence z-score against
  that baseline.

Per-link evidence is the asymmetry detector: a one-way partition's victim
reports a clean tail (its inbound works; it may not even see the loss),
but every peer whose pulls die reports a suspect link NAMING it — the
coordinator indicts the member from third-party link reports its own
report cannot launder. ``asymmetric=False`` removes exactly this and
misses one-way partitions.

Hysteresis — raising takes ``confirm_ticks`` consecutive over-threshold
ticks; clearing takes ``clear_ticks`` consecutive ticks BELOW a separate,
lower ``clear_threshold``. A slow-but-honest member hovers without
flapping; ``hysteresis=False`` (equal thresholds, one-tick confirm and
clear) is a flap machine.

Containment ladder (probation -> quarantine -> evict), reusing existing
actuators instead of inventing new ones:

- PROBATION routes around the suspect: the ``on_probation`` callback feeds
  the FleetRouter's pressure penalty / MPMD standby speculation / PS pull
  retarget, and the decision log announces it. Traffic bends; nobody dies.
- QUARANTINE checkpoint-parks the suspect through the scheduler's
  park/resume machinery: a ``PreemptRequest`` whose grant id lives in the
  gray plane's RESERVED space (``GRAY_GRANT_BASE``), the member's own
  ``_do_park`` path, a WAL'd ``note_parked`` ticket so lease expiry stays
  disarmed, and a ``ResumeRequest`` to the node agent after the cooldown.
- EVICT fires ONLY on confirmed gray (a member that re-offends after
  ``evict_after_quarantines`` quarantine cycles), through the reputation
  revoke machinery (``Coordinator.revoke_member``): cooldown, refused
  joins, fresh-params rejoin. ``evict_on_first_suspicion=True`` collapses
  the whole ladder onto this rung and evicts live members on transient
  weather.

This is host logic on Python floats: the same renewals, link triples and
clock readings give the JAX class's states, scores and ``stats()``
exactly.

A recovered member earns its way back DOWN the same ladder: quarantine
resumes into probation, probation clears into OK — never straight to
trusted.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Dict, Optional, Tuple

#: gray-plane PreemptRequest grant ids live at and above this base so the
#: coordinator's PreemptDone dispatch can route them here and never to the
#: multi-tenant scheduler's grant bookkeeping (coord/sched.py starts at 1
#: and counts up; 2^24 leaves it ~16M grants of headroom)
GRAY_GRANT_BASE = 1 << 24

#: ladder states
OK = "ok"
PROBATION = "probation"
QUARANTINED = "quarantined"
EVICTED = "evicted"


def member_evidence(retrans_rate: float, nack_rate: float, blocked_s: float,
                    fsync_p95_ms: float, busy_ratio: float) -> float:
    """Collapse a member's gray-health tail into one evidence scalar.
    Weights put every source on a roughly common scale (a 10% retransmit
    rate ~ 0.5s of blocked sends ~ a 50ms fsync p95 ~ one unit); the
    ADAPTIVE part is the per-member baseline, not these constants. A
    busy_ratio of 0 means "not reported" (neutral), below 1 means the
    serve loop spent wall-clock NOT serving — the stall signature."""
    stall = (1.0 - busy_ratio) if busy_ratio > 0.0 else 0.0
    return (10.0 * retrans_rate + 10.0 * nack_rate + 2.0 * blocked_s
            + fsync_p95_ms / 50.0 + stall)


def link_evidence(retrans_rate: float, blocked_s: float) -> float:
    return 10.0 * retrans_rate + 2.0 * blocked_s


class _Baseline:
    """Exponentially-weighted mean/std with a floor — the adaptive 'normal'
    a member's evidence is judged against. Updated only while the member
    is unsuspected (the caller gates), so an anomaly cannot train itself
    into the baseline.

    The first ``warmup`` samples always train and never score: a fresh
    baseline sits at mu=0, so the very first honest report would z-spike,
    freeze the baseline (the anti-self-training gate), and leave it
    frozen at a 'normal' it never actually learned — permanent suspicion
    from startup noise. Abstaining until the baseline has seen enough of
    THIS member's weather breaks that deadlock."""

    __slots__ = ("mu", "var", "alpha", "floor", "latest", "seen", "warmup")

    def __init__(self, alpha: float = 0.1, floor: float = 0.25,
                 warmup: int = 8):
        self.mu = 0.0
        self.var = 0.0
        self.alpha = alpha
        self.floor = floor
        self.latest = 0.0
        self.seen = 0
        self.warmup = int(warmup)

    def update(self, x: float) -> None:
        d = x - self.mu
        self.mu += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.seen += 1

    def z(self) -> float:
        if self.seen < self.warmup:
            return 0.0
        sd = max(math.sqrt(self.var), self.floor)
        return (self.latest - self.mu) / sd


class _Track:
    """Per-member suspicion state."""

    __slots__ = ("gaps", "last_at", "base", "state", "raise_streak",
                 "clear_streak", "probation_ticks", "flaps", "quarantines",
                 "grant_id", "parked", "quarantined_at", "resume_sent",
                 "first_suspect_at", "score")

    def __init__(self):
        self.gaps = collections.deque(maxlen=64)
        self.last_at: Optional[float] = None
        self.base = _Baseline()
        self.state = OK
        self.raise_streak = 0
        self.clear_streak = 0
        self.probation_ticks = 0
        self.flaps = 0
        self.quarantines = 0
        self.grant_id = 0
        self.parked: Optional[dict] = None
        self.quarantined_at = 0.0
        self.resume_sent = False
        self.first_suspect_at: Optional[float] = None
        self.score = 0.0


class GrayHealth:
    """The coordinator-side gray-failure plane; attach with
    ``GrayHealth(coord)`` (mirrors ``FleetScheduler``'s ``coord.sched``
    hook — the coordinator feeds :meth:`on_renew` from its LeaseRenew
    dispatch, drives :meth:`tick` from its serve-thread tick, and routes
    gray-granted PreemptDone frames to :meth:`on_preempt_done`).

    Three knobs switch the ladder's defences off:

    - ``hysteresis=False`` -> confirm/clear collapse to one tick at one
      shared threshold (the ``no_hysteresis`` flap machine),
    - ``asymmetric=False`` -> per-link evidence is ignored (the
      ``symmetric_probe_only`` one-way-partition blind spot),
    - ``evict_on_first_suspicion=True`` -> the first confirmed raise
      revokes instead of entering probation.
    """

    def __init__(
        self,
        coord,
        *,
        raise_threshold: float = 3.0,
        clear_threshold: float = 1.0,
        confirm_ticks: int = 2,
        clear_ticks: int = 4,
        quarantine_after: int = 6,
        quarantine_cooldown: float = 3.0,
        evict_after_quarantines: int = 2,
        evict_cooldown: float = 10.0,
        actuator_rank: Optional[int] = None,
        link_weight: float = 2.0,
        hysteresis: bool = True,
        asymmetric: bool = True,
        evict_on_first_suspicion: bool = False,
        on_probation: Optional[Callable[[int], None]] = None,
        on_clear: Optional[Callable[[int], None]] = None,
        on_quarantine: Optional[Callable[[int], None]] = None,
    ):
        self.coord = coord
        self.raise_threshold = float(raise_threshold)
        self.clear_threshold = float(clear_threshold)
        self.confirm_ticks = max(1, int(confirm_ticks))
        self.clear_ticks = max(1, int(clear_ticks))
        self.quarantine_after = max(1, int(quarantine_after))
        self.quarantine_cooldown = float(quarantine_cooldown)
        self.evict_after_quarantines = int(evict_after_quarantines)
        self.evict_cooldown = float(evict_cooldown)
        self.actuator_rank = actuator_rank
        self.link_weight = float(link_weight)
        self.hysteresis = bool(hysteresis)
        self.asymmetric = bool(asymmetric)
        self.evict_on_first_suspicion = bool(evict_on_first_suspicion)
        self.on_probation = on_probation
        self.on_clear = on_clear
        self.on_quarantine = on_quarantine
        self._tracks: Dict[int, _Track] = {}
        #: (suspect_rank, reporter_rank) -> evidence baseline for the
        #: DIRECTED link suspect->reporter as the reporter experiences it
        self._links: Dict[Tuple[int, int], _Baseline] = {}
        self._next_grant = GRAY_GRANT_BASE
        self._pending_preempt: Optional[dict] = None
        # measured outcomes (rings: the plane outlives every episode)
        self.detection_latencies = collections.deque(maxlen=256)
        self.containment_mttrs = collections.deque(maxlen=256)
        self.probations = 0
        self.quarantines = 0
        self.evictions = 0
        self.recoveries = 0
        coord.gray = self

    # ------------------------------------------------------------- evidence
    def on_renew(self, member, now: float, links=()) -> None:
        """One lease renewal arrived (coordinator serve thread): record the
        inter-arrival gap, the member's own evidence, and any per-link
        evidence triples it reported about its peers."""
        t = self._tracks.setdefault(member.rank, _Track())
        if t.last_at is not None:
            t.gaps.append(now - t.last_at)
        t.last_at = now
        x = member_evidence(member.retrans_rate, member.nack_rate,
                            member.blocked_s, member.fsync_p95_ms,
                            member.busy_ratio)
        t.base.latest = x
        if (t.base.seen < t.base.warmup
                or (t.state == OK and t.raise_streak == 0)):
            # adaptive baseline, frozen the moment suspicion starts — the
            # anomaly must not train itself into "normal" (warm-up always
            # trains; see _Baseline)
            t.base.update(x)
        for peer, l_retrans, l_blocked in links:
            if peer == member.rank:
                continue
            # wider floor than the member baseline: link evidence is
            # quantized by small request windows, so one transiently late
            # reply must not z-spike into an indictment
            lb = self._links.setdefault((int(peer), member.rank),
                                        _Baseline(floor=1.0))
            lx = link_evidence(l_retrans, l_blocked)
            lb.latest = lx
            pt = self._tracks.get(int(peer))
            peer_ok = pt is None or (pt.state == OK and pt.raise_streak == 0)
            anomalous = lb.z() >= self.raise_threshold
            if lb.seen < lb.warmup or (peer_ok and not anomalous):
                # same freeze rule as the member baseline, judged on the
                # link's OWN z: an anomalous report must not train itself
                # into "normal" during the ticks before the member-level
                # streak starts (warm-up always trains)
                lb.update(lx)
        if t.state == QUARANTINED and t.resume_sent:
            # the resumed life is renewing again: unpark, and re-enter the
            # ladder at PROBATION — a recovered member earns trust back
            # through the same rungs it fell down
            self.coord.note_unparked(member.rank)
            t.parked = None
            t.resume_sent = False
            t.state = PROBATION
            t.probation_ticks = 0
            t.clear_streak = 0
            self.recoveries += 1
            self.coord._log(
                f"gray: rank {member.rank} resumed from quarantine — "
                "re-entering at probation (earns its way back)")

    # -------------------------------------------------------------- scoring
    def _phi(self, t: _Track, now: float) -> float:
        """Phi-accrual-style surprise of the CURRENT renewal gap against
        the member's own inter-arrival history (z-score form): adaptive,
        so a member that always renews every 2s is suspected at 4s while
        one that renews every 50ms is suspected at 150ms."""
        if t.last_at is None or len(t.gaps) < 4:
            return 0.0
        m = sum(t.gaps) / len(t.gaps)
        var = sum((g - m) ** 2 for g in t.gaps) / len(t.gaps)
        sd = max(math.sqrt(var), 0.25 * m, 1e-3)
        return max(0.0, ((now - t.last_at) - m) / sd)

    def _link_component(self, rank: int) -> float:
        """Third-party indictments: how many DISTINCT reporters currently
        see a suspect link from ``rank`` toward them."""
        if not self.asymmetric:
            return 0.0
        reporters = 0
        for (suspect, _reporter), lb in self._links.items():
            if suspect != rank or lb.seen == 0:
                continue
            if lb.z() >= self.raise_threshold and lb.latest > 0.05:
                reporters += 1
        return self.link_weight * min(reporters, 3)

    def score(self, rank: int, now: float) -> float:
        t = self._tracks.get(rank)
        if t is None:
            return 0.0
        own = max(t.base.z(), self._phi(t, now))
        return own + self._link_component(rank)

    # ---------------------------------------------------------------- tick
    def tick(self, now: float) -> None:
        """Drive the suspicion ladder (coordinator serve thread only, like
        ``FleetScheduler.tick``)."""
        raise_thr = self.raise_threshold
        clear_thr = (self.raise_threshold if not self.hysteresis
                     else self.clear_threshold)
        confirm = 1 if not self.hysteresis else self.confirm_ticks
        clear_n = 1 if not self.hysteresis else self.clear_ticks
        p = self._pending_preempt
        if p is not None and p.get("sent") and now - p["started"] > 30.0:
            self.coord._log(
                f"gray: park of rank {p['rank']} ABANDONED after 30s "
                f"(grant {p['grant_id']} never reported done)")
            self._pending_preempt = None
        for rank in list(self._tracks):
            t = self._tracks[rank]
            member = self.coord.members.get(rank)
            if member is None and t.state not in (QUARANTINED, EVICTED):
                continue  # lease-expired or left; nothing to contain
            if t.state == QUARANTINED:
                self._drive_quarantine(rank, t, now)
                continue
            if t.state == EVICTED:
                continue
            s = self.score(rank, now)
            t.score = s
            if t.state == OK:
                if s >= raise_thr:
                    t.raise_streak += 1
                    if t.first_suspect_at is None:
                        t.first_suspect_at = now
                    if t.raise_streak >= confirm:
                        if self.evict_on_first_suspicion:
                            self._evict(rank, t, now,
                                        "first confirmed suspicion "
                                        "(ladder disabled)")
                        else:
                            self._enter_probation(rank, t, now, s)
                else:
                    t.raise_streak = 0
                    if t.flaps == 0:
                        t.first_suspect_at = None
            elif t.state == PROBATION:
                if s <= clear_thr:
                    t.clear_streak += 1
                    if t.clear_streak >= clear_n:
                        self._clear(rank, t)
                else:
                    t.clear_streak = 0
                    t.probation_ticks += 1
                    if (t.probation_ticks >= self.quarantine_after
                            and s >= raise_thr):
                        if (self.evict_after_quarantines > 0
                                and t.quarantines
                                >= self.evict_after_quarantines):
                            self._evict(
                                rank, t, now,
                                f"confirmed gray: still suspect after "
                                f"{t.quarantines} quarantine cycle(s)")
                        else:
                            self._start_quarantine(rank, t, now)

    # -------------------------------------------------------------- ladder
    def _enter_probation(self, rank: int, t: _Track, now: float,
                         s: float) -> None:
        t.state = PROBATION
        t.raise_streak = 0
        t.clear_streak = 0
        t.probation_ticks = 0
        t.flaps += 1
        self.probations += 1
        if t.first_suspect_at is not None:
            self.detection_latencies.append(now - t.first_suspect_at)
        self.coord._log(
            f"gray: rank {rank} on PROBATION (suspicion {s:.1f} >= "
            f"{self.raise_threshold:.1f}) — routing around it, nobody "
            "dies")
        member = self.coord.members.get(rank)
        if member is not None and self.coord.speculation:
            from distributed_ml_pytorch_tpu_torch.coord.coordinator import KIND_WORKER

            if member.kind == KIND_WORKER:
                # MPMD/worker route-around: standby speculation on the
                # suspect, reusing the Sandblaster backup-task actuator
                self.coord.speculate_victim(rank)
        if self.on_probation is not None:
            self.on_probation(rank)

    def _clear(self, rank: int, t: _Track) -> None:
        t.state = OK
        t.raise_streak = 0
        t.clear_streak = 0
        t.probation_ticks = 0
        self.coord._log(f"gray: rank {rank} cleared probation — suspicion "
                        "below the clear threshold, trust restored")
        if self.on_clear is not None:
            self.on_clear(rank)

    def _start_quarantine(self, rank: int, t: _Track, now: float) -> None:
        p = self._pending_preempt
        if p is not None and p["rank"] != rank:
            return  # one park in flight at a time (mirrors the scheduler)
        if p is None:
            # checkpoint-park discipline (the scheduler's require_manifest
            # gate, reused): drive a snapshot barrier FIRST so the resume
            # restores checkpoint + exact WAL replay, never a cold start
            self._pending_preempt = {
                "rank": rank, "grant_id": 0, "started": now, "sent": False,
                "manifest_baseline":
                    int(getattr(self.coord, "manifests_written", 0))}
            trigger = getattr(self.coord, "trigger_snapshot", None)
            if trigger is not None:
                trigger()
            return
        if p["sent"]:
            return
        barrier_done = (int(getattr(self.coord, "manifests_written", 0))
                        > p["manifest_baseline"])
        if not barrier_done and now - p["started"] < 5.0:
            return  # barrier still in flight; next tick re-checks
        gid = self._next_grant
        self._next_grant += 1
        t.grant_id = gid
        p["grant_id"] = gid
        p["sent"] = True
        lm = self.coord.last_manifest
        snap_id = int(lm.snapshot_id) if lm is not None else 0
        from distributed_ml_pytorch_tpu_torch.coord.coordinator import encode_preempt_request
        from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

        self.coord._log(
            f"gray: rank {rank} QUARANTINE — checkpoint-park under gray "
            f"grant {gid} (snapshot {snap_id}); its lease is exempt, its "
            "range restores on resume")
        self.coord._send(rank, MessageCode.PreemptRequest,
                         encode_preempt_request(gid, snap_id))
        if self.on_quarantine is not None:
            self.on_quarantine(rank)

    def on_preempt_done(self, sender: int, *, grant_id: int, snap_id: int,
                        lo: int, hi: int, apply_seq: int,
                        now: float) -> None:
        """Wired from ``Coordinator.handle`` for grant ids this plane owns
        (:meth:`owns_grant`)."""
        p = self._pending_preempt
        if p is None or p["grant_id"] != grant_id or p["rank"] != sender:
            self.coord._log(f"gray: stale PreemptDone from rank {sender} "
                            f"(grant {grant_id})")
            return
        t = self._tracks.setdefault(sender, _Track())
        member = self.coord.members.get(sender)
        parked = {
            "rank": sender,
            "incarnation": member.incarnation if member is not None else 0,
            "snapshot_id": snap_id,
            "lo": lo,
            "hi": hi,
            "apply_seq": apply_seq,
            "grant_id": grant_id,
            # tags the ticket as the gray plane's, so a restored
            # coordinator never resynthesizes a scheduler slot for it
            "gray": True,
        }
        self.coord.note_parked(sender, parked)
        t.parked = parked
        t.state = QUARANTINED
        t.quarantined_at = now
        t.quarantines += 1
        t.resume_sent = False
        self.quarantines += 1
        if t.first_suspect_at is not None:
            self.containment_mttrs.append(now - t.first_suspect_at)
        self.coord._log(
            f"gray: rank {sender} parked [{lo},{hi}) at apply seq "
            f"{apply_seq} under snapshot {snap_id} (grant {grant_id}) — "
            f"contained, cooldown {self.quarantine_cooldown:.1f}s")
        self._pending_preempt = None

    def _drive_quarantine(self, rank: int, t: _Track, now: float) -> None:
        if t.parked is None or t.resume_sent:
            return
        if now - t.quarantined_at < self.quarantine_cooldown:
            return
        from distributed_ml_pytorch_tpu_torch.coord.coordinator import encode_resume_request
        from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

        t.resume_sent = True
        self.coord._log(
            f"gray: quarantine cooldown over — resuming rank {rank} from "
            f"snapshot {t.parked['snapshot_id']} (grant "
            f"{t.parked['grant_id']})")
        if self.actuator_rank is not None:
            self.coord._send(
                self.actuator_rank, MessageCode.ResumeRequest,
                encode_resume_request(t.parked["grant_id"], rank,
                                      t.parked["snapshot_id"]))

    def _evict(self, rank: int, t: _Track, now: float, why: str) -> None:
        t.state = EVICTED
        self.evictions += 1
        self.coord.revoke_member(rank, f"gray: {why}",
                                 cooldown=self.evict_cooldown)

    # ----------------------------------------------------------------- api
    def owns_grant(self, grant_id: int) -> bool:
        return grant_id >= GRAY_GRANT_BASE

    def state_of(self, rank: int) -> str:
        t = self._tracks.get(rank)
        return t.state if t is not None else OK

    def suspects(self) -> Dict[int, str]:
        return {r: t.state for r, t in self._tracks.items()
                if t.state in (PROBATION, QUARANTINED)}

    def suspect_count(self) -> int:
        return len(self.suspects())

    def flaps_of(self, rank: int) -> int:
        t = self._tracks.get(rank)
        return t.flaps if t is not None else 0

    def stats(self) -> dict:
        return {
            "probations": self.probations,
            "quarantines": self.quarantines,
            "evictions": self.evictions,
            "recoveries": self.recoveries,
            "suspects": dict(self.suspects()),
            "detection_latencies": list(self.detection_latencies),
            "containment_mttrs": list(self.containment_mttrs),
        }


class WireEvidence:
    """Turn a :class:`ReliableTransport`-style ``stats`` dict into the
    per-window deltas the renew tail wants. Workers (and the drills) hold
    one per transport: ``sample()`` returns ``(retrans_rate, blocked_s)``
    SINCE the previous sample, so a long-healed history never dilutes
    current weather. Tolerant of any object without a stats dict — it
    just reports zeros."""

    __slots__ = ("_transport", "_base")

    def __init__(self, transport) -> None:
        self._transport = transport
        self._base = (0, 0, 0.0)
        self.sample()  # swallow pre-construction history

    def sample(self) -> tuple:
        st = getattr(self._transport, "stats", None)
        if not isinstance(st, dict):
            return (0.0, 0.0)
        sent = int(st.get("sent", 0))
        retries = int(st.get("retries", 0))
        blk = float(st.get("window_blocked_s", 0.0))
        b_sent, b_retries, b_blk = self._base
        self._base = (sent, retries, blk)
        return (
            (retries - b_retries) / max(1, sent - b_sent),
            max(0.0, blk - b_blk),
        )
