"""The member's side of the coordinator (counterpart of the JAX
``coord/member.py``): :class:`CoordClient` and :class:`FleetView`.

A member (a training worker, a shard server or a serving engine) holds one
transport into the coordination star and a :class:`CoordClient` over it,
which

- **joins** with its kind and an incarnation stamp, resending the join
  until the coordinator answers with a shard map (a join is idempotent, so
  a lost one heals itself);
- **renews its lease** from a thread every ``renew_interval`` seconds,
  carrying the member's latest progress report (the straggler detector's
  input) and re-joining every fourth renewal, so a member whose lease
  expired in a stall is taken back;
- **receives** ``ShardMapUpdate``, ``FleetState``, ``SpeculateTask``,
  ``SnapshotRequest``, ``RollbackRequest`` and the scheduler's
  ``PreemptRequest``, ``SlotGrant`` and ``ResumeRequest`` frames on a
  listener thread:
  the newest map waits in a mailbox for the consumer's next step boundary;
  callbacks are optional (``on_snapshot(snapshot_id, map_version)`` and
  ``on_rollback(rollback_id, phase)`` are public and assignable: a shard
  server or a worker wires its mailbox in after construction), and a
  rollback's phase also holds :class:`FleetView` (``rollback_active``) for
  at most ``rollback_hold_ttl`` seconds, so a lost end frame fails open;
  ``on_preempt(grant_id, snapshot_id)`` is a shard server's park mailbox,
  and a node agent wires ``on_slot_grant(grant_id, tenant_id, action,
  slot_id)`` and ``on_resume(grant_id, rank, snapshot_id)``;
- **reports** into the barriers (:meth:`CoordClient.snapshot_done`,
  :meth:`CoordClient.rollback_done`) and the park
  (:meth:`CoordClient.preempt_done`);
- **leaves** on :meth:`CoordClient.close`, carrying its incarnation, so a
  parting leave racing a newer life's join of the rank cannot evict it;
- **learns of its revocation**: the coordinator answers a revoked life
  (and each of its renewals during the cooldown) with a ``CoordLeave`` of
  that life's incarnation, which sets ``revoked`` until a fleet broadcast
  shows the rank readmitted. A revoked worker's ``finish`` then does not
  wait out its ack timeouts on shards that no longer count it.

Every coordinator frame passes the epoch fence in one place
(:meth:`CoordClient._handle`): a frame stamped with an epoch below the
highest seen comes from an older coordinator life and is dropped, counted
in ``stale_epoch_dropped``.

A stage member (``parallel/mpmd.MpmdStage``) **announces its stage**
(:meth:`CoordClient.stage_ready`) and takes the coordinator's versioned
``StagePlacement`` (``StageAssign``) through ``on_stage_assign``; a stale
placement never rolls it back.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from distributed_ml_pytorch_tpu_torch.coord.coordinator import (
    KIND_AGENT,
    KIND_ENGINE,
    KIND_SHARD,
    KIND_STAGE,
    KIND_WORKER,
    decode_fleet,
    encode_join,
    encode_leave,
    encode_preempt_done,
    encode_renew,
    encode_rollback_done,
    encode_snapshot_done,
)
from distributed_ml_pytorch_tpu_torch.coord.shardmap import ShardMap
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    MessageCode,
    Transport,
    _join16,
    _next_incarnation,
    strip_epoch,
)

_KINDS = {"worker": KIND_WORKER, "shard": KIND_SHARD, "engine": KIND_ENGINE,
          "stage": KIND_STAGE, "agent": KIND_AGENT}

class FleetView:
    """The latest fleet broadcast, read from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state: Optional[dict] = None
        #: the monotonic instant a rollback barrier holds until: set on its
        #: phase 0, cleared on phase 1, bounded by a TTL either way
        self._rollback_until = 0.0

    def update(self, state: dict) -> None:
        with self._lock:
            self._state = dict(state)

    @property
    def state(self) -> Optional[dict]:
        with self._lock:
            return None if self._state is None else dict(self._state)

    def engine_up(self) -> bool:
        """False only when a report exists and shows no live engine: with no
        coordinator, or before its first report, serving keeps admitting."""
        s = self.state
        return s is None or s["n_engines"] > 0

    def live_engine_ranks(self):
        """The live engine ranks of the latest report, or None before one."""
        s = self.state
        if s is None:
            return None
        ranks = s.get("engine_ranks")
        return None if ranks is None else set(ranks)

    def workers_done(self) -> bool:
        s = self.state
        return s is not None and s["workers_done"]

    def fleet_metrics(self) -> dict:
        """The latest report's metrics tail, ``{}`` before one."""
        s = self.state
        return {} if s is None else dict(s.get("fleet_metrics") or {})

    def note_rollback(self, active: bool, ttl: float = 15.0) -> None:
        """A rollback barrier's phase: ``active`` holds for at most ``ttl``
        seconds, so an end frame that never arrives fails open."""
        with self._lock:
            self._rollback_until = time.monotonic() + float(ttl) if active else 0.0

    def rollback_active(self) -> bool:
        """True while a rollback barrier is in flight (a serving frontend
        holds its submits through it)."""
        with self._lock:
            return time.monotonic() < self._rollback_until


class CoordClient:
    """One member's connection to the coordinator (see the module
    docstring). ``on_shard_map(map)``, ``on_snapshot(snapshot_id,
    map_version)`` and ``on_rollback(rollback_id, phase)`` (all assignable
    after construction: a shard server or a worker wires itself in) and
    ``on_speculate(task_id, victim, from_step)`` are called on the listener
    thread, and so are the scheduler's ``on_preempt``, ``on_slot_grant`` and
    ``on_resume`` (assignable, None by default) and a stage member's
    ``on_stage_assign(placement)``."""

    def __init__(self, transport: Transport, kind: str, *, renew_interval: float = 0.5,
                 incarnation: Optional[int] = None,
                 on_shard_map: Optional[Callable[[ShardMap], None]] = None,
                 on_speculate: Optional[Callable[[int, int, int], None]] = None,
                 on_snapshot: Optional[Callable[[int, int], None]] = None,
                 on_rollback: Optional[Callable[[int, int], None]] = None,
                 on_stage_assign: Optional[Callable[[object], None]] = None,
                 rollback_hold_ttl: float = 15.0):
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {sorted(_KINDS)}, got {kind!r}")
        self.transport = transport
        self.kind = kind
        self.renew_interval = float(renew_interval)
        #: strictly increasing within the process, so a replacement client
        #: of the same rank reads as the newer life
        self.incarnation = (int(incarnation) if incarnation is not None
                            else _next_incarnation())
        self.fleet = FleetView()
        self.coord_down = False
        #: the coordinator revoked this life's lease (set by its
        #: ``CoordLeave``, cleared by the next fleet broadcast)
        self.revoked = False
        self.on_shard_map = on_shard_map
        self._on_speculate = on_speculate
        self.on_snapshot = on_snapshot
        self.on_rollback = on_rollback
        #: a stage member's placement mailbox, called with the decoded
        #: ``coord/stages.StagePlacement``
        self.on_stage_assign = on_stage_assign
        #: a shard server's park mailbox: ``(grant_id, snapshot_id)``; the
        #: member commits, reports ``preempt_done`` and stops serving
        self.on_preempt = None
        #: a node agent's actuators: ``on_slot_grant(grant_id, tenant_id,
        #: action, slot_id)`` spawns or retires the tenant's member,
        #: ``on_resume(grant_id, rank, snapshot_id)`` restores a parked one
        self.on_slot_grant = None
        self.on_resume = None
        self.rollback_hold_ttl = float(rollback_hold_ttl)
        #: the highest coordinator epoch seen; frames below it are dropped
        self.coord_epoch = -1
        self.stale_epoch_dropped = 0
        self._lock = threading.Lock()
        self._latest_map: Optional[ShardMap] = None
        self._current_version = -1
        self._latest_placement = None
        self._placement_version = -1
        self._got_map = threading.Event()
        #: (push_count, step, ewma_ms, wire_open, nacks, bad_loss, loss_ewma,
        #: gnorm_ewma), shipped on every renewal
        self._progress = (0, 0, 0.0, 0, 0, 0, 0.0, 0.0)
        #: (retrans_rate, nack_rate, blocked_s, fsync_p95_ms, busy_ratio) and
        #: the per-link triples behind them
        self._gray_health = (0.0, 0.0, 0.0, 0.0, 0.0)
        self._gray_links: tuple = ()
        self._stop = threading.Event()
        self._listener = threading.Thread(target=self._pump, name="coord-listener",
                                          daemon=True)
        self._listener.start()
        self._renewer = threading.Thread(target=self._renew_loop, name="coord-renew",
                                         daemon=True)
        self._renewer.start()

    # ----------------------------------------------------------------- wire
    def _send(self, code: MessageCode, payload: np.ndarray) -> None:
        try:
            self.transport.send(code, payload)
            self.coord_down = False
        except (OSError, ConnectionError, KeyError):
            # a dead coordinator never takes the member down: it goes on
            # under the last map it adopted
            self.coord_down = True

    def _pump(self) -> None:
        while not self._stop.is_set():
            msg = self.transport.recv(timeout=0.1)
            if msg is None:
                continue
            _sender, code, payload = msg
            try:
                self._handle(code, payload)
            except (ValueError, IndexError, OverflowError):
                continue  # a malformed frame: drop it, never die

    def _handle(self, code: MessageCode, payload: np.ndarray) -> None:
        # the one strip point of the epoch fence: every coordinator command
        # passes here before any decode
        payload, epoch = strip_epoch(payload)
        if epoch is not None:
            if epoch < self.coord_epoch:
                self.stale_epoch_dropped += 1
                return
            self.coord_epoch = max(self.coord_epoch, epoch)
        if code == MessageCode.ShardMapUpdate:
            m = ShardMap.decode(payload)
            with self._lock:
                if m.version <= self._current_version:
                    return  # a stale rebroadcast never rolls a consumer back
                self._current_version = m.version
                self._latest_map = m
            self._got_map.set()
            if self.on_shard_map is not None:
                self.on_shard_map(m)
        elif code == MessageCode.FleetState:
            self.fleet.update(decode_fleet(payload))
            # broadcasts go to live members only: this life is one again
            self.revoked = False
        elif code == MessageCode.CoordLeave and payload.size >= 2:
            if np.isfinite(payload[:2]).all() \
                    and _join16(payload[0], payload[1]) == self.incarnation:
                self.revoked = True
        elif code == MessageCode.SpeculateTask and payload.size >= 3:
            if self._on_speculate is not None and np.isfinite(payload[:3]).all():
                self._on_speculate(int(payload[0]), int(payload[1]), int(payload[2]))
        elif code == MessageCode.SnapshotRequest and payload.size >= 4:
            if self.on_snapshot is not None and np.isfinite(payload[:4]).all():
                self.on_snapshot(_join16(payload[0], payload[1]),
                                 _join16(payload[2], payload[3]))
        elif code == MessageCode.RollbackRequest and payload.size >= 7:
            if not np.isfinite(payload[:7]).all():
                return
            rollback_id = _join16(payload[0], payload[1])
            phase = int(payload[6])
            # the fleet view holds serving frontends; a data-plane member
            # reacts through its own mailbox
            self.fleet.note_rollback(phase == 0, ttl=self.rollback_hold_ttl)
            if self.on_rollback is not None:
                self.on_rollback(rollback_id, phase)
        elif code == MessageCode.PreemptRequest and payload.size >= 4:
            if self.on_preempt is not None and np.isfinite(payload[:4]).all():
                self.on_preempt(_join16(payload[0], payload[1]), _join16(payload[2], payload[3]))
        elif code == MessageCode.SlotGrant and payload.size >= 5:
            if self.on_slot_grant is not None and np.isfinite(payload[:5]).all():
                self.on_slot_grant(_join16(payload[0], payload[1]), int(payload[2]),
                                   int(payload[3]), int(payload[4]))
        elif code == MessageCode.ResumeRequest and payload.size >= 5:
            if self.on_resume is not None and np.isfinite(payload[:5]).all():
                self.on_resume(_join16(payload[0], payload[1]), int(payload[2]),
                               _join16(payload[3], payload[4]))
        elif code == MessageCode.StageAssign and payload.size >= 5:
            from distributed_ml_pytorch_tpu_torch.coord.stages import StagePlacement

            p = StagePlacement.decode(payload)
            with self._lock:
                if p.version <= self._placement_version:
                    return  # a stale rebroadcast never rolls a consumer back
                self._placement_version = p.version
                self._latest_placement = p
            if self.on_stage_assign is not None:
                self.on_stage_assign(p)

    def _renew_loop(self) -> None:
        tick = 0
        while not self._stop.wait(self.renew_interval):
            with self._lock:
                progress = self._progress
                gray_health = self._gray_health
                gray_links = self._gray_links
            self._send(MessageCode.LeaseRenew,
                       encode_renew(self.incarnation, *progress, *gray_health,
                                    links=gray_links))
            tick += 1
            if tick % 4 == 0:
                # the coordinator ignores an unknown rank's renewals: the
                # idempotent re-join takes back a member whose lease expired
                self._send(MessageCode.CoordJoin,
                           encode_join(_KINDS[self.kind], self.incarnation))

    # ------------------------------------------------------------------ api
    def join(self, timeout: float = 10.0) -> Optional[ShardMap]:
        """Announce membership and wait for the coordinator's map, resending
        the join; the map, or None on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._send(MessageCode.CoordJoin, encode_join(_KINDS[self.kind], self.incarnation))
            if self._got_map.wait(min(0.25, self.renew_interval)):
                return self.current_map()
        return self.current_map()

    def report(self, push_count: int, step: int, ewma_ms: float, wire_open: int = 0,
               nacks: int = 0, bad_loss: int = 0, loss_ewma: float = 0.0,
               gnorm_ewma: float = 0.0) -> None:
        """Keep this member's latest progress for the next renewal."""
        with self._lock:
            self._progress = (int(push_count), int(step), float(ewma_ms), int(wire_open),
                              int(nacks), int(bad_loss), float(loss_ewma), float(gnorm_ewma))

    def report_gray_health(self, retrans_rate: float = 0.0, nack_rate: float = 0.0,
                           blocked_s: float = 0.0, fsync_p95_ms: float = 0.0,
                           busy_ratio: float = 0.0, links=()) -> None:
        """Keep this member's data-plane weather for the next renewal;
        ``links`` are ``(peer, link_retrans_rate, link_blocked_s)``."""
        with self._lock:
            self._gray_health = (float(retrans_rate), float(nack_rate), float(blocked_s),
                                 float(fsync_p95_ms), float(busy_ratio))
            self._gray_links = tuple((int(p), float(r), float(b)) for p, r, b in links)

    def current_map(self) -> Optional[ShardMap]:
        with self._lock:
            return self._latest_map

    def take_shard_map(self) -> Optional[ShardMap]:
        """The newest map not taken yet, once (None until a newer lands)."""
        with self._lock:
            m, self._latest_map = self._latest_map, None
            return m

    def snapshot_done(self, snapshot_id: int, map_version: int, lo: int, hi: int,
                      apply_seq: int, push_count: int) -> None:
        """Report this shard's checkpoint into the snapshot barrier."""
        self._send(MessageCode.SnapshotDone, encode_snapshot_done(
            snapshot_id, map_version, lo, hi, apply_seq, push_count))

    def rollback_done(self, rollback_id: int, map_version: int, lo: int, hi: int,
                      apply_seq: int) -> None:
        """Report this shard's in-place rollback into the barrier."""
        self._send(MessageCode.RollbackDone, encode_rollback_done(
            rollback_id, map_version, lo, hi, apply_seq))

    def preempt_done(self, grant_id: int, snapshot_id: int, lo: int, hi: int,
                     apply_seq: int) -> None:
        """Report this member parked under ``grant_id``: ``[lo, hi)`` durable
        at ``apply_seq`` under the named snapshot. Only now may the
        scheduler grant the slot again."""
        self._send(MessageCode.PreemptDone, encode_preempt_done(
            grant_id, snapshot_id, lo, hi, apply_seq))

    def stage_ready(self, stage: int, watermark: int) -> None:
        """Announce that this member serves pipeline stage ``stage`` at the
        microbatch ``watermark``; the coordinator assigns it into the
        ``StagePlacement`` and broadcasts ``StageAssign``."""
        from distributed_ml_pytorch_tpu_torch.coord.stages import encode_stage_ready

        self._send(MessageCode.StageReady,
                   encode_stage_ready(stage, self.incarnation, watermark))

    def current_placement(self):
        """The newest ``StagePlacement`` seen (None before the first)."""
        with self._lock:
            return self._latest_placement

    def leave(self) -> None:
        self._send(MessageCode.CoordLeave, encode_leave(self.incarnation))

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self.leave()
        self.stop()
