"""The coordinator's membership plane (counterpart of the membership part of
the JAX ``coord/coordinator.py``): leases, shard rebalancing, straggler
speculation and the fleet-state broadcast.

DistBelief's Sandblaster puts a coordinator above the parameter-server
fleet: it owns no parameters, only the assignment of work to machines, and
schedules backup copies of straggling tasks. Over the same tagged-float32
transports as everything else:

- **Membership.** Members join with a kind (worker, shard server, serving
  engine) and an incarnation stamp; liveness is a lease, renewed by
  ``LeaseRenew`` frames. A member silent past its lease is removed. A stale
  life's ``CoordLeave`` or ``LeaseRenew`` cannot evict or refresh the
  rank's newer life.
- **Shard rebalancing.** When a shard server joins or dies, the next
  :class:`~.shardmap.ShardMap` version goes to every member; workers drain
  their pushes and cut over at a step boundary.
- **Straggler speculation.** Workers report progress (push count, step,
  step-latency EWMA) in their renewals. A worker whose EWMA exceeds
  ``straggler_factor`` times the fleet's lower median gets a backup: the
  fastest worker and the victim both receive a ``SpeculateTask``, and the
  shard servers apply the first result per task id.
- **Fleet state.** A compact ``FleetState`` broadcast (worker, shard and
  engine counts, live engine ranks, done flag, a metrics tail).

Every frame the coordinator sends carries its epoch fence trailer
(``messaging.stamp_epoch``; this coordinator's epoch is 1), which the
member strips in one place. The decisions are functions of the frame and
clock history (``handle`` and ``tick`` with an injectable clock), so tests
drive them synchronously; :meth:`Coordinator.run` feeds them a transport
and wall time.

Not in this package yet, and refused rather than ignored: the durability
and health barriers (snapshots, manifests, rollback, reputation, a durable
coordinator with its grace window), the engine-scaling advisory, and an
attached scheduler or gray-failure policy. Their frames (any code outside
this package's ``WIRE_SCHEMAS``) reaching the coordinator are dropped and
counted in ``later_plane_dropped``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from distributed_ml_pytorch_tpu_torch.coord.shardmap import ShardMap, rebalance
from distributed_ml_pytorch_tpu_torch.utils.health import clamp_finite32
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    WIRE_SCHEMAS,
    MessageCode,
    Transport,
    _join16,
    _split16,
    stamp_epoch,
)
from distributed_ml_pytorch_tpu_torch.utils.obs import BoundedEvents

_LOGGER = logging.getLogger(__name__)

#: member kinds on the wire (``CoordJoin`` payload[0]), the JAX values
KIND_WORKER = 0
KIND_SHARD = 1
KIND_ENGINE = 2
KIND_STAGE = 3
KIND_AGENT = 4
_KIND_NAMES = {KIND_WORKER: "worker", KIND_SHARD: "shard", KIND_ENGINE: "engine",
               KIND_STAGE: "stage", KIND_AGENT: "agent"}


def later_plane(code) -> bool:
    """A code outside this package's ``WIRE_SCHEMAS``: a frame of a plane
    this package does not have yet (snapshots, rollback, the scheduler, the
    MPMD stages), dropped and counted, never half-handled."""
    return code not in WIRE_SCHEMAS


#: the JAX constructor's options of the later planes, with their defaults
#: and the plane each belongs to: any other value raises
_LATER_OPTIONS = {
    "manifest_dir": (None, "the snapshot barrier"),
    "snapshot_interval": (0.0, "the snapshot barrier"),
    "snapshot_timeout": (30.0, "the snapshot barrier"),
    "restore_manifest": (None, "the snapshot barrier"),
    "auto_rollback": (False, "the rollback barrier"),
    "rollback_loss_factor": (2.0, "the rollback barrier"),
    "rollback_cooldown": (10.0, "the rollback barrier"),
    "rollback_timeout": (30.0, "the rollback barrier"),
    "reputation_nacks": (0, "worker reputation"),
    "reputation_cooldown": (10.0, "worker reputation"),
    "durable_dir": (None, "the durable coordinator"),
    "grace": (None, "the durable coordinator"),
    "restore_parked": (True, "the durable coordinator"),
    "ckpt_every": (16, "the durable coordinator"),
    "engine_occ_high": (0.0, "engine scaling"),
    "engine_occ_low": (0.0, "engine scaling"),
    "engine_slo_ttft_ms": (0.0, "engine scaling"),
    "scale_cooldown": (5.0, "engine scaling"),
    "on_scale": (None, "engine scaling"),
}


def refuse_later_options(owner: str, options: dict, table: dict) -> None:
    """Raise ``ValueError`` naming the plane for an option of ``table`` set
    to anything but its default, ``TypeError`` for an unknown one."""
    for name, value in options.items():
        if name not in table:
            raise TypeError(f"{owner}() got an unexpected keyword argument {name!r}")
        default, plane = table[name]
        if value is not default and value != default:
            raise ValueError(f"{owner}({name}=...): {plane} is not in this package yet")


def encode_join(kind: int, incarnation: int) -> np.ndarray:
    return np.asarray([float(kind), *_split16(incarnation)], np.float32)


def encode_leave(incarnation: int) -> np.ndarray:
    return np.asarray([*_split16(incarnation)], np.float32)


def encode_renew(incarnation: int, push_count: int = 0, step: int = 0, ewma_ms: float = 0.0,
                 wire_open: int = 0, nacks: int = 0, bad_loss: int = 0,
                 loss_ewma: float = 0.0, gnorm_ewma: float = 0.0, retrans_rate: float = 0.0,
                 nack_rate: float = 0.0, blocked_s: float = 0.0, fsync_p95_ms: float = 0.0,
                 busy_ratio: float = 0.0, links=()) -> np.ndarray:
    """The lease renewal: incarnation, progress (push count, step,
    step-latency EWMA), open circuit breakers, the numerical-health tail
    (nacks received, nonfinite losses, loss and grad-norm EWMAs) and the
    gray-health tail (retransmit rate, nack rate, blocked-send seconds,
    fsync p95, busy ratio), then ``(peer, link_retrans_rate,
    link_blocked_s)`` triples. The floats are clamped finite: receivers drop
    a renewal with a nonfinite field."""
    tail = []
    for peer, l_retrans, l_blocked in links:
        tail += [float(peer), clamp_finite32(l_retrans), clamp_finite32(l_blocked)]
    return np.asarray(
        [*_split16(incarnation), float(push_count), float(step), float(ewma_ms),
         float(wire_open), float(nacks), float(bad_loss), clamp_finite32(loss_ewma),
         clamp_finite32(gnorm_ewma), clamp_finite32(retrans_rate), clamp_finite32(nack_rate),
         clamp_finite32(blocked_s), clamp_finite32(fsync_p95_ms), clamp_finite32(busy_ratio),
         *tail], np.float32)


#: the FleetState tail's section separator (engine ranks are non-negative)
FLEET_TAIL_SEPARATOR = -1.0

#: the floats behind the separator, in wire order
FLEET_METRICS_FIELDS = (
    "events_total",    # decisions ever logged
    "mean_ewma_ms",    # fleet-mean member step latency EWMA
    "wire_open",       # summed open circuit breakers across members
    "nacks",           # summed admission nacks across members
    "gray_suspects",   # members under gray suspicion (0 without that plane)
)


def encode_fleet(version: int, n_workers: int, n_shards: int, n_engines: int,
                 workers_done: bool, engine_ranks=(), fleet_metrics=()) -> np.ndarray:
    """The fleet broadcast: map version, counts, done flag, then the live
    engine ranks and, behind :data:`FLEET_TAIL_SEPARATOR`, the metrics."""
    tail = [float(r) for r in engine_ranks]
    metrics = [float(m) for m in fleet_metrics]
    if metrics:
        tail += [FLEET_TAIL_SEPARATOR] + metrics
    return np.asarray([*_split16(version), float(n_workers), float(n_shards),
                       float(n_engines), 1.0 if workers_done else 0.0, *tail], np.float32)


def decode_fleet(payload: np.ndarray) -> dict:
    if payload.size < 6 or not np.isfinite(payload[:6]).all():
        raise ValueError(f"malformed FleetState frame (size {payload.size})")
    tail = payload[6:]
    tail = tail[np.isfinite(tail)]
    neg = np.nonzero(tail < 0)[0]
    if neg.size:
        ranks, metrics = tail[:neg[0]], tail[neg[0] + 1:]
    else:
        ranks, metrics = tail, tail[:0]
    return {
        "version": _join16(payload[0], payload[1]),
        "n_workers": int(payload[2]),
        "n_shards": int(payload[3]),
        "n_engines": int(payload[4]),
        "workers_done": bool(payload[5]),
        "engine_ranks": [int(r) for r in ranks],
        "fleet_metrics": dict(zip(FLEET_METRICS_FIELDS, (float(m) for m in metrics))),
    }


@dataclasses.dataclass
class MemberInfo:
    """One live member: identity, lease and its latest progress report."""

    rank: int
    kind: int
    incarnation: int
    last_seen: float
    push_count: int = 0
    step: int = 0
    ewma_ms: float = 0.0
    #: open circuit breakers on the member's own wire: alive but cut off
    wire_open: int = 0
    #: at least one renewal carried this member's metrics
    reported: bool = False
    nacks: int = 0
    nack_base: int = -1
    bad_loss: int = 0
    loss_ewma: float = 0.0
    gnorm_ewma: float = 0.0
    retrans_rate: float = 0.0
    nack_rate: float = 0.0
    blocked_s: float = 0.0
    fsync_p95_ms: float = 0.0
    busy_ratio: float = 0.0

    @property
    def kind_name(self) -> str:
        return _KIND_NAMES.get(self.kind, str(self.kind))


class Coordinator:
    """Rank 0 of the coordination star (see the module docstring).

    ``lease`` is the seconds of silence after which a member is removed;
    ``straggler_factor`` and ``straggler_after_steps`` arm the straggler
    detector, ``speculation`` turns it on; ``clock`` is the time source."""

    def __init__(self, transport: Optional[Transport], n_params: int, *, lease: float = 2.0,
                 straggler_factor: float = 3.0, straggler_after_steps: int = 4,
                 speculation: bool = True, clock: Callable[[], float] = time.monotonic,
                 **later):
        refuse_later_options("Coordinator", later, _LATER_OPTIONS)
        self.transport = transport
        self.lease = float(lease)
        self.straggler_factor = float(straggler_factor)
        self.straggler_after_steps = int(straggler_after_steps)
        self.speculation = bool(speculation)
        self._clock = clock
        self.members: Dict[int, MemberInfo] = {}
        self.shard_map = ShardMap(0, int(n_params), ())
        self.done_workers: set = set()
        self.speculated: Dict[int, int] = {}  # victim rank -> task id
        self._next_task = 1
        self._stop = threading.Event()
        #: the decision log, a capped ring
        self.events = BoundedEvents(maxlen=1024)
        #: a memory-only coordinator's epoch (a durable one bumps it per life)
        self.epoch = 1
        self.later_plane_dropped = 0

    @property
    def sched(self):
        return None

    @sched.setter
    def sched(self, value) -> None:
        if value is not None:
            raise ValueError("Coordinator.sched: the multi-tenant scheduler is not in this "
                             "package yet")

    @property
    def gray(self):
        return None

    @gray.setter
    def gray(self, value) -> None:
        if value is not None:
            raise ValueError("Coordinator.gray: the gray-failure plane is not in this "
                             "package yet")

    def _log(self, msg: str) -> None:
        self.events.append(msg)
        _LOGGER.info("coordinator: %s", msg)

    def _live(self, kind: Optional[int] = None) -> List[MemberInfo]:
        out = [m for m in self.members.values() if kind is None or m.kind == kind]
        return sorted(out, key=lambda m: m.rank)

    def fleet_state(self) -> dict:
        workers = self._live(KIND_WORKER)
        engines = self._live(KIND_ENGINE)
        live = self._live()
        reported = [m for m in live if m.reported]
        fleet_metrics = [
            float(self.events.total),
            (sum(m.ewma_ms for m in reported) / len(reported) if reported else 0.0),
            float(sum(m.wire_open for m in live)),
            float(sum(m.nacks for m in live)),
            0.0,
        ]
        return {
            "fleet_metrics": fleet_metrics,
            "version": self.shard_map.version,
            "n_workers": len(workers),
            "n_shards": len(self._live(KIND_SHARD)),
            "n_engines": len(engines),
            "engine_ranks": [m.rank for m in engines],
            # done needs a clean leave: every worker's lease expiring at once
            # is an outage, and the shard servers must not exit under it
            "workers_done": bool(self.done_workers) and not workers,
            "members": {
                m.rank: {"kind": m.kind_name, "incarnation": m.incarnation, "step": m.step,
                         "push_count": m.push_count, "ewma_ms": m.ewma_ms,
                         "wire_open": m.wire_open, "nacks": m.nacks,
                         "bad_loss": m.bad_loss, "loss_ewma": m.loss_ewma}
                for m in self._live()
            },
        }

    def wire_health(self) -> Dict[int, int]:
        """Rank -> open circuit breakers, from the lease view."""
        return {m.rank: m.wire_open for m in self._live()}

    def engine_up(self) -> bool:
        return bool(self._live(KIND_ENGINE))

    def live_engine_ranks(self):
        return {m.rank for m in self._live(KIND_ENGINE)}

    # --------------------------------------------------------------- sends
    def _send(self, rank: int, code: MessageCode, payload: np.ndarray) -> None:
        """One guarded send, stamped with this coordinator's epoch (the one
        stamping point): a dead member never takes the hub down."""
        if self.transport is None:
            return
        try:
            self.transport.send(code, stamp_epoch(payload, self.epoch), dst=rank)
        except (OSError, ConnectionError, KeyError):
            pass  # its lease expires; tick cleans up

    def _broadcast(self, code: MessageCode, payload: np.ndarray) -> None:
        for m in self._live():
            self._send(m.rank, code, payload)

    def _fleet_frame(self) -> np.ndarray:
        fs = self.fleet_state()
        return encode_fleet(fs["version"], fs["n_workers"], fs["n_shards"], fs["n_engines"],
                            fs["workers_done"], fs["engine_ranks"], fs["fleet_metrics"])

    def _announce(self) -> None:
        """The current map and fleet state to everyone."""
        self._broadcast(MessageCode.ShardMapUpdate, self.shard_map.encode())
        self._broadcast(MessageCode.FleetState, self._fleet_frame())

    # -------------------------------------------------------------- handle
    def handle(self, sender: int, code: MessageCode, payload: np.ndarray) -> None:
        """Process one member frame, synchronously (tests call it directly)."""
        now = self._clock()
        member = self.members.get(sender)
        if later_plane(code):
            self.later_plane_dropped += 1
            return
        if code == MessageCode.CoordJoin and payload.size >= 3:
            if not np.isfinite(payload[:3]).all():
                return
            kind = int(payload[0])
            inc = _join16(payload[1], payload[2])
            if member is not None and inc < member.incarnation:
                # a delayed join of an older life must not demote the newer one
                self._log(f"ignored stale join of rank {sender} "
                          f"(inc {inc} < {member.incarnation})")
                return
            is_new = member is None or member.incarnation != inc
            rebirth = member is not None and inc > member.incarnation
            if is_new:
                self.members[sender] = MemberInfo(sender, kind, inc, now)
            else:
                # the same life re-joining (members do, as insurance against
                # a lease lost in a stall): refresh it, keep its telemetry
                member.last_seen = now
            if kind == KIND_WORKER:
                self.done_workers.discard(sender)
            if is_new:
                self._log(f"{_KIND_NAMES.get(kind, kind)} {sender} "
                          f"{'rejoined' if rebirth else 'joined'} (inc {inc})")
                if kind == KIND_SHARD:
                    self._rebalance("join of shard server %d" % sender)
                else:
                    self._announce()
            else:
                # an idempotent re-join: answer the joiner alone
                self._send(sender, MessageCode.ShardMapUpdate, self.shard_map.encode())
                self._send(sender, MessageCode.FleetState, self._fleet_frame())
            return
        if member is None:
            return  # before a join or after an expiry: the join retry fixes it
        if code == MessageCode.CoordLeave and payload.size >= 2:
            inc = _join16(payload[0], payload[1])
            if inc != member.incarnation:
                # an old life's parting leave must not evict the new life
                self._log(f"ignored stale leave of rank {sender} "
                          f"(inc {inc} != {member.incarnation})")
                return
            del self.members[sender]
            if member.kind == KIND_WORKER:
                self.done_workers.add(sender)
            self.speculated.pop(sender, None)
            self._log(f"{member.kind_name} {sender} left")
            if member.kind == KIND_SHARD:
                self._rebalance("leave of shard server %d" % sender)
            else:
                self._announce()
            return
        # the 5-, 6- and 10-field renewals are full renewals too: an absent
        # tail leaves the last report standing
        if code == MessageCode.LeaseRenew and payload.size >= 5:
            n = min(int(payload.size), 15)
            if not np.isfinite(payload[:n]).all():
                return
            inc = _join16(payload[0], payload[1])
            if inc < member.incarnation:
                return  # an older life's heartbeat
            member.incarnation = max(member.incarnation, inc)
            member.last_seen = now
            member.push_count = int(payload[2])
            member.step = int(payload[3])
            member.ewma_ms = float(payload[4])
            member.reported = True
            if n >= 6:
                wire_open = int(payload[5])
                if wire_open != member.wire_open:
                    if wire_open > 0:
                        self._log(f"{member.kind_name} {sender} reports {wire_open} open "
                                  "circuit(s) on its wire (degraded links)")
                    elif member.wire_open > 0:
                        self._log(f"{member.kind_name} {sender} wire healthy again (all "
                                  "circuits closed)")
                member.wire_open = wire_open
            if n >= 10:
                member.nacks = int(payload[6])
                if member.nack_base < 0:
                    member.nack_base = member.nacks
                member.bad_loss = int(payload[7])
                member.loss_ewma = float(payload[8])
                member.gnorm_ewma = float(payload[9])
            if n >= 15:
                member.retrans_rate = float(payload[10])
                member.nack_rate = float(payload[11])
                member.blocked_s = float(payload[12])
                member.fsync_p95_ms = float(payload[13])
                member.busy_ratio = float(payload[14])
            return
        # any other frame from a known member is evidence of life
        member.last_seen = now

    # ---------------------------------------------------------------- tick
    def tick(self) -> bool:
        """Expire leases, rebalance, and maybe speculate; True when the
        membership changed. :meth:`run` calls it every ``lease / 4``."""
        now = self._clock()
        expired = [m for m in self.members.values() if now - m.last_seen > self.lease]
        shard_died = False
        for m in expired:
            del self.members[m.rank]
            self.speculated.pop(m.rank, None)
            self._log(f"{m.kind_name} {m.rank} lease expired "
                      f"({now - m.last_seen:.1f}s silent)")
            shard_died |= m.kind == KIND_SHARD
        if shard_died:
            self._rebalance("lease expiry")
        elif expired:
            self._announce()
        if self.speculation:
            self.check_stragglers()
        return bool(expired)

    def _rebalance(self, why: str) -> None:
        live = [m.rank for m in self._live(KIND_SHARD)]
        self.shard_map = rebalance(self.shard_map, live)
        self._log(f"shard map v{self.shard_map.version} on {why}: "
                  + (", ".join(f"s{e.server_id}=[{e.lo},{e.hi})"
                               for e in self.shard_map.entries) or "EMPTY"))
        self._announce()

    # ---------------------------------------------------------- speculation
    def _speculate(self, victim: MemberInfo, backup: MemberInfo) -> int:
        task_id = self._next_task
        self._next_task += 1
        self.speculated[victim.rank] = task_id
        frame = np.asarray([float(task_id), float(victim.rank), float(victim.step)],
                           np.float32)
        # both get the task: the backup races the tail, the victim tags its
        # own late result with the same id, and the shard servers keep the
        # first result per id
        self._send(backup.rank, MessageCode.SpeculateTask, frame)
        self._send(victim.rank, MessageCode.SpeculateTask, frame)
        return task_id

    def check_stragglers(self) -> Optional[int]:
        """When the slowest reporting worker's step-latency EWMA exceeds
        ``straggler_factor`` times the lower median, replicate its remaining
        work on the fastest worker; the task id when one fired."""
        workers = [m for m in self._live(KIND_WORKER)
                   if m.ewma_ms > 0 and m.step >= self.straggler_after_steps
                   and m.rank not in self.speculated]
        if len(workers) < 2:
            return None
        by_speed = sorted(workers, key=lambda m: m.ewma_ms)
        victim = by_speed[-1]
        # the lower median: with two workers it is the other one
        median = by_speed[(len(by_speed) - 1) // 2].ewma_ms
        if median <= 0 or victim.ewma_ms < self.straggler_factor * median:
            return None
        backup = by_speed[0]
        self._log(f"straggler: worker {victim.rank} at {victim.ewma_ms:.1f} ms/step "
                  f"(median {median:.1f}) — speculating its tail on worker "
                  f"{backup.rank} as task {self._next_task}")
        return self._speculate(victim, backup)

    def speculate_victim(self, victim_rank: int) -> Optional[int]:
        """Replicate a named worker's remaining work on the fastest other
        worker, whatever its latency (the route-around a gray-failure
        policy takes); the task id, or None."""
        victim = self.members.get(victim_rank)
        if victim is None or victim.kind != KIND_WORKER or victim_rank in self.speculated:
            return None
        candidates = [m for m in self._live(KIND_WORKER) if m.rank != victim_rank]
        if not candidates:
            return None
        backup = min(candidates, key=lambda m: (m.ewma_ms, m.rank))
        self._log(f"gray probation: speculating worker {victim_rank}'s tail on worker "
                  f"{backup.rank} as task {self._next_task}")
        return self._speculate(victim, backup)

    # ----------------------------------------------------------------- run
    def stop(self) -> None:
        self._stop.set()

    def run(self, timeout: Optional[float] = None) -> None:
        """Serve until :meth:`stop` (or ``timeout``): pump frames, tick."""
        if self.transport is None:
            raise ValueError("Coordinator.run needs a transport")
        deadline = None if timeout is None else self._clock() + timeout
        next_tick = self._clock()
        while not self._stop.is_set():
            now = self._clock()
            if deadline is not None and now >= deadline:
                break
            if now >= next_tick:
                self.tick()
                next_tick = now + max(0.05, self.lease / 4)
            msg = self.transport.recv(timeout=0.1)
            if msg is None:
                continue
            try:
                self.handle(*msg)
            except (ValueError, IndexError, OverflowError):
                continue  # a malformed member frame: drop it, never die
