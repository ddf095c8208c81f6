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

- **The snapshot barrier.** :meth:`Coordinator.trigger_snapshot` (or
  ``snapshot_interval``) sends every live shard a ``SnapshotRequest``; each
  checkpoints at its next version boundary and answers ``SnapshotDone``,
  and the reports become one :class:`~.manifest.FleetManifest` under
  ``manifest_dir``. A report under another map version, or a rebalance
  mid-barrier, aborts it.
- **Reputation and the rollback barrier.** A worker whose renewals report
  ``reputation_nacks`` admission nacks in one life has its lease revoked
  (``revoke_member``; its joins are refused for ``reputation_cooldown``
  s). The watchdog (``_check_numerical_health``) tracks the best fleet-mean
  loss EWMA on every tick and, when ``auto_rollback`` arms it, fires a
  ``RollbackRequest`` barrier on a nonfinite loss or a mean past
  ``rollback_loss_factor`` times the best: shards restore the last good
  manifest in place and answer ``RollbackDone``, workers drop their
  accumulators and pull; ``rollback_mttrs`` keeps trigger to all-reported.
- **The durable coordinator.** With ``durable_dir`` every transition is
  logged (``coord.wal``, log before mutate) before it is broadcast, a JSON
  checkpoint (``coord_ckpt.json``) compacts the log every ``ckpt_every``
  records, and a new life replays both. A persisted epoch
  (``coord_epoch``, written before the life's first frame) stamps every
  frame this coordinator sends (``messaging.stamp_epoch``), so a member
  drops the frames of an older life; a restart opens a ``grace`` window
  (one lease by default) in which no lease expires and no speculation
  fires while the members' join retries re-attach them. The files' bytes
  are the JAX package's for the same frame history.
- **The scheduler's park table.** An attached ``coord/sched.FleetScheduler``
  is driven by :meth:`Coordinator.tick` and takes ``PreemptDone`` frames
  from :meth:`Coordinator.handle`. Every park and unpark it makes is logged
  (``park``/``unpark`` records) into a durable table before the ledger
  changes, and the checkpoint carries the table and the ledger, so a
  restarted life neither expires a parked rank (parked ranks are exempt
  from lease expiry and from the grace window) nor grants its slot twice
  (:meth:`Coordinator._restore_sched_state` rebuilds a slot from the logged
  ticket when no checkpoint covered the park). ``restore_parked=False``
  forgets the table on a restart.
- **Engine scaling advice.** Engine members renew with (occupancy %, queue
  depth, TTFT ms) in the renewal's progress fields; past
  ``engine_occ_high`` mean occupancy or the ``engine_slo_ttft_ms`` SLO the
  coordinator advises scaling up, below ``engine_occ_low`` with more than
  one engine scaling down: an event, an entry in ``scale_advice`` and the
  ``on_scale(direction, detail)`` callback, at most once a
  ``scale_cooldown``.

The decisions are functions of the frame and clock history (``handle`` and
``tick`` with an injectable clock), so tests drive them synchronously;
:meth:`Coordinator.run` feeds them a transport and wall time.

- **The gray-failure plane.** An attached ``coord/grayhealth.GrayHealth``
  (``coord.gray``) is fed every renewal with its per-link triples, driven
  by :meth:`Coordinator.tick`, and takes the ``PreemptDone`` frames whose
  grant ids lie at or above ``GRAY_GRANT_BASE``; the others go to the
  scheduler. Its suspects ride the fleet broadcast (``gray_suspects``).
- **Revocation notices.** A revoked life is told so: a ``CoordLeave`` of
  its incarnation at the revocation and in answer to each renewal of its
  cooldown (the member's ``revoked``).

- **The flight recorder.** ``recorder`` (a ``utils/obs.SpanRecorder``,
  attached after construction) takes every decision-log line as a
  ``coord`` event, and with ``obs_dir`` a rollback, done or abandoned,
  dumps it there (``flight_dump``), so that its MTTR ships with the window
  that explains it.

The MPMD stage plane's frames (``StageReady``; ``StageAssign`` goes out) are the
``coord/stages.StageCoordinator``'s; this base class takes them as
evidence of life, as any other frame of a known member.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from distributed_ml_pytorch_tpu_torch.coord.manifest import (
    MANIFEST_NAME,
    FleetManifest,
    ManifestError,
    ShardRecord,
)
from distributed_ml_pytorch_tpu_torch.coord.shardmap import ShardEntry, ShardMap, rebalance
from distributed_ml_pytorch_tpu_torch.utils.durability import atomic_write
from distributed_ml_pytorch_tpu_torch.utils.health import clamp_finite32
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    MessageCode,
    Transport,
    _join16,
    _split16,
    stamp_epoch,
)
from distributed_ml_pytorch_tpu_torch.utils.obs import BoundedEvents, flight_dump
from distributed_ml_pytorch_tpu_torch.utils.wal import WriteAheadLog

_LOGGER = logging.getLogger(__name__)

#: member kinds on the wire (``CoordJoin`` payload[0]), the JAX values
KIND_WORKER = 0
KIND_SHARD = 1
KIND_ENGINE = 2
KIND_STAGE = 3
KIND_AGENT = 4
_KIND_NAMES = {KIND_WORKER: "worker", KIND_SHARD: "shard", KIND_ENGINE: "engine",
               KIND_STAGE: "stage", KIND_AGENT: "agent"}

#: the files of a coordinator's ``durable_dir``, the JAX names
COORD_EPOCH_NAME = "coord_epoch"
COORD_CKPT_NAME = "coord_ckpt.json"
COORD_WAL_NAME = "coord.wal"


def _op_to_f32(op: dict) -> np.ndarray:
    """One coordinator log record: the JSON transition, padded with spaces
    to whole float32 words, so it rides ``utils/wal.py``'s float32 record
    format byte for byte (replay hands the same bytes back)."""
    raw = json.dumps(op, sort_keys=True).encode("utf-8")
    raw += b" " * (-len(raw) % 4)
    return np.frombuffer(raw, np.float32)


def _f32_to_op(payload: np.ndarray) -> dict:
    return json.loads(payload.tobytes().decode("utf-8"))


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


def encode_snapshot_request(snapshot_id: int, map_version: int) -> np.ndarray:
    return np.asarray([*_split16(snapshot_id), *_split16(map_version)], np.float32)


def encode_snapshot_done(snapshot_id: int, map_version: int, lo: int, hi: int,
                         apply_seq: int, push_count: int) -> np.ndarray:
    return np.asarray([*_split16(snapshot_id), *_split16(map_version), *_split16(lo),
                       *_split16(hi), *_split16(apply_seq), *_split16(push_count)],
                      np.float32)


def encode_rollback_request(rollback_id: int, snapshot_id: int, map_version: int,
                            phase: int) -> np.ndarray:
    """Phase 0 starts the barrier (shards restore, workers drop their
    accumulators and pull, frontends hold submits); phase 1 ends it,
    completed or abandoned."""
    return np.asarray([*_split16(rollback_id), *_split16(snapshot_id),
                       *_split16(map_version), float(phase)], np.float32)


def encode_rollback_done(rollback_id: int, map_version: int, lo: int, hi: int,
                         apply_seq: int) -> np.ndarray:
    return np.asarray([*_split16(rollback_id), *_split16(map_version), *_split16(lo),
                       *_split16(hi), *_split16(apply_seq)], np.float32)


def encode_preempt_request(grant_id: int, snapshot_id: int) -> np.ndarray:
    """Scheduler to victim member: park yourself under ``grant_id``;
    ``snapshot_id`` names the manifest the park restores from."""
    return np.asarray([*_split16(grant_id), *_split16(snapshot_id)], np.float32)


def encode_preempt_done(grant_id: int, snapshot_id: int, lo: int, hi: int,
                        apply_seq: int) -> np.ndarray:
    return np.asarray([*_split16(grant_id), *_split16(snapshot_id), *_split16(lo),
                       *_split16(hi), *_split16(apply_seq)], np.float32)


def encode_slot_grant(grant_id: int, tenant_id: int, action: int, slot_id: int) -> np.ndarray:
    """Scheduler to node agent: action 1 grants ``slot_id`` to ``tenant_id``
    (spawn that tenant's member kind), action 0 revokes it."""
    return np.asarray([*_split16(grant_id), float(tenant_id), float(action), float(slot_id)],
                      np.float32)


def encode_resume_request(grant_id: int, rank: int, snapshot_id: int) -> np.ndarray:
    """Scheduler to node agent: resume the member parked as ``rank``,
    restoring ``snapshot_id`` bit for bit (manifest and WAL replay)."""
    return np.asarray([*_split16(grant_id), float(rank), *_split16(snapshot_id)], np.float32)


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
    detector, ``speculation`` turns it on; ``clock`` is the time source.
    ``manifest_dir``, ``snapshot_interval``, ``snapshot_timeout`` and
    ``restore_manifest`` (a :class:`~.manifest.FleetManifest` whose map and
    snapshot clock a disaster recovery adopts) drive the snapshot barrier;
    ``auto_rollback``, ``rollback_loss_factor``, ``rollback_cooldown`` and
    ``rollback_timeout`` the rollback barrier; ``reputation_nacks`` and
    ``reputation_cooldown`` worker reputation; ``durable_dir``, ``grace``,
    ``restore_parked`` and ``ckpt_every`` the durable coordinator;
    ``engine_occ_high``, ``engine_occ_low``, ``engine_slo_ttft_ms``,
    ``scale_cooldown`` and ``on_scale`` the engine-scaling advice."""

    def __init__(self, transport: Optional[Transport], n_params: int, *, lease: float = 2.0,
                 straggler_factor: float = 3.0, straggler_after_steps: int = 4,
                 speculation: bool = True, clock: Callable[[], float] = time.monotonic,
                 manifest_dir: Optional[str] = None, snapshot_interval: float = 0.0,
                 snapshot_timeout: float = 30.0, restore_manifest=None,
                 engine_occ_high: float = 0.0, engine_occ_low: float = 0.0,
                 engine_slo_ttft_ms: float = 0.0, scale_cooldown: float = 5.0,
                 on_scale: Optional[Callable[[str, dict], None]] = None,
                 auto_rollback: bool = False, rollback_loss_factor: float = 2.0,
                 rollback_cooldown: float = 10.0, rollback_timeout: float = 30.0,
                 reputation_nacks: int = 0, reputation_cooldown: float = 10.0,
                 durable_dir: Optional[str] = None, grace: Optional[float] = None,
                 restore_parked: bool = True, ckpt_every: int = 16):
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
        #: the optional flight recorder and the directory its dumps go to
        self.recorder = None
        self.obs_dir: Optional[str] = None
        #: the attached ``coord/sched.FleetScheduler`` (it sets this)
        self.sched = None
        #: the attached ``coord/grayhealth.GrayHealth`` (it sets this)
        self.gray = None
        # --- the snapshot barrier
        self.manifest_dir = manifest_dir
        self.snapshot_interval = float(snapshot_interval)
        self.snapshot_timeout = float(snapshot_timeout)
        self._snap_seq = 0
        self._snap: Optional[dict] = None  # the barrier in flight
        #: set by trigger_snapshot() from any thread, taken by tick()
        self._snap_requested = False
        self._next_snap_at = (self._clock() + self.snapshot_interval
                              if self.snapshot_interval > 0 else None)
        self.manifests_written = 0
        self.last_manifest: Optional[FleetManifest] = None
        # --- engine scaling advice (a threshold at 0 turns its direction off)
        self.engine_occ_high = float(engine_occ_high)
        self.engine_occ_low = float(engine_occ_low)
        self.engine_slo_ttft_ms = float(engine_slo_ttft_ms)
        self.scale_cooldown = float(scale_cooldown)
        self.on_scale = on_scale
        self._next_scale_at = 0.0
        self.scale_advice = collections.deque(maxlen=256)
        # --- reputation and the rollback barrier
        self.auto_rollback = bool(auto_rollback)
        self.rollback_loss_factor = float(rollback_loss_factor)
        self.rollback_cooldown = float(rollback_cooldown)
        self.rollback_timeout = float(rollback_timeout)
        self.reputation_nacks = int(reputation_nacks)
        self.reputation_cooldown = float(reputation_cooldown)
        self._roll: Optional[dict] = None  # the barrier in flight
        self._roll_seq = 0
        #: set by trigger_rollback() from any thread, taken by tick()
        self._rollback_requested = False
        self._next_rollback_at = 0.0
        self.rollbacks_done = 0
        self.rollbacks_abandoned = 0
        self.rollback_mttrs = collections.deque(maxlen=256)
        self._fleet_best_loss: Optional[float] = None
        #: rank -> the nonfinite-loss count a barrier already consumed
        self._bad_loss_seen: Dict[int, int] = {}
        self._reputation_block: Dict[int, float] = {}  # rank -> until
        self._block_logged: set = set()
        self.revoked_workers = 0
        # --- the durable coordinator
        self.durable_dir = durable_dir
        self.grace = grace
        self.restore_parked = bool(restore_parked)
        #: a memory-only coordinator's epoch; a durable one bumps it per life
        self.epoch = 1
        self._wal: Optional[WriteAheadLog] = None
        self._wal_seq = 0
        self._ckpt_seq = 0
        self._ckpt_every = max(1, int(ckpt_every))
        #: a park or unpark asks for a checkpoint at the next tick
        self._ckpt_due = False
        self._ckpt_path: Optional[str] = None
        #: rank -> restore ticket of every member the scheduler parked,
        #: kept through logged park and unpark records: the durable twin of
        #: ``FleetScheduler.parked_ranks()``
        self._parked_durable: Dict[int, dict] = {}
        #: the previous life's checkpointed ledger, until a scheduler
        #: attaches and takes it
        self._sched_restore: Optional[dict] = None
        self._grace_until = 0.0
        self._grace_pending: set = set()
        self.restored_members = 0
        if restore_manifest is not None:
            # disaster recovery: the manifest's map and snapshot clock, so
            # rebalances and snapshot ids continue instead of restarting
            restore_manifest.validate()
            self.shard_map = restore_manifest.shard_map
            self._snap_seq = int(restore_manifest.snapshot_id)
            self.last_manifest = restore_manifest
            self._log(f"restored from manifest: snapshot {self._snap_seq}, "
                      f"shard map v{self.shard_map.version}")
        if durable_dir is not None:
            self._init_durable()

    def _log(self, msg: str) -> None:
        self.events.append(msg)
        if self.recorder is not None:
            # the log line, structured, on the recorder every plane writes to
            self.recorder.event("coord", corr=0, msg=msg)
        _LOGGER.info("coordinator: %s", msg)

    def _flight_dump(self, reason: str) -> None:
        """With a recorder and an ``obs_dir``, write the decision timeline
        that covers a fault window there."""
        if self.recorder is not None and self.obs_dir:
            flight_dump(self.recorder, self.obs_dir, reason)

    # ----------------------------------------------------------- durability
    def _init_durable(self) -> None:
        """Open the epoch file, the checkpoint and the log, and rebuild the
        previous life's state (in the constructor, before any frame)."""
        os.makedirs(self.durable_dir, exist_ok=True)
        epoch_path = os.path.join(self.durable_dir, COORD_EPOCH_NAME)
        try:
            with open(epoch_path, "r", encoding="utf-8") as f:
                prev_epoch = int(f.read().strip() or 0)
        except (OSError, ValueError):
            prev_epoch = 0
        # the fence: strictly monotonic across lives and durable before this
        # life's first frame, so two lives over one directory are ordered
        self.epoch = prev_epoch + 1
        atomic_write(epoch_path, str(self.epoch).encode("utf-8"))
        self._ckpt_path = os.path.join(self.durable_dir, COORD_CKPT_NAME)
        try:
            with open(self._ckpt_path, "rb") as f:
                state = json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError):
            state = None
        self._wal = WriteAheadLog(os.path.join(self.durable_dir, COORD_WAL_NAME),
                                  incarnation=self.epoch)
        records, wal_stats = self._wal.replay()
        self._restore_durable(state, records)
        if prev_epoch and wal_stats.get("torn_tail"):
            self._log("durable restart: dropped one torn WAL tail record (the crash "
                      "artifact)")

    def _restore_durable(self, state: Optional[dict], records) -> None:
        now = self._clock()
        base_seq = 0
        if state is not None:
            base_seq = int(state.get("wal_seq", 0))
            for rank, kind, inc in state.get("members", ()):
                self.members[int(rank)] = MemberInfo(int(rank), int(kind), int(inc), now)
            m = state.get("map")
            if m is not None:
                self.shard_map = ShardMap(int(m["version"]), int(m["n_params"]),
                                          [ShardEntry(*(int(v) for v in e))
                                           for e in m.get("entries", ())])
            self._snap_seq = int(state.get("snap_seq", self._snap_seq))
            self._roll_seq = int(state.get("roll_seq", self._roll_seq))
            self._next_task = int(state.get("next_task", self._next_task))
            for rank, parked in (state.get("parked") or {}).items():
                self._parked_durable[int(rank)] = dict(parked)
            self._sched_restore = state.get("sched") or None
        for rec in records:
            if rec.seq <= base_seq:
                continue  # the checkpoint covers it
            self._wal_seq = max(self._wal_seq, int(rec.seq))
            try:
                op = _f32_to_op(rec.payload)
            except (ValueError, UnicodeDecodeError):
                continue  # an unreadable record: the state before it stands
            self._apply_wal_op(op, now)
        self._wal_seq = max(self._wal_seq, base_seq)
        self._ckpt_seq = self._wal_seq
        if not self.restore_parked:
            # a restart that forgets the park table: lease expiry re-arms on
            # every parked member
            self._parked_durable.clear()
            if self._sched_restore:
                for slot in self._sched_restore.get("slots", ()):
                    slot[5] = None
        if not (self.members or self._parked_durable or self.shard_map.version):
            return  # a first life over an empty directory
        self.restored_members = len(self.members)
        grace = self.lease if self.grace is None else float(self.grace)
        # a parked rank stays silent by design: the window does not wait on it
        self._grace_pending = set(self.members) - set(self._parked_durable)
        if grace > 0 and self._grace_pending:
            self._grace_until = now + grace
        if self.last_manifest is None and self.manifest_dir:
            # adopt the previous life's published manifest, if one survives
            try:
                self.last_manifest = FleetManifest.load(self.manifest_path())
            except ManifestError:
                pass
        self._log(f"restarted as epoch {self.epoch}: restored {len(self.members)} member(s), "
                  f"map v{self.shard_map.version}, snapshot clock {self._snap_seq}, "
                  f"{len(self._parked_durable)} parked rank(s)"
                  + (f"; grace window {grace:.1f}s awaiting {sorted(self._grace_pending)}"
                     if self._grace_until else ""))

    def _apply_wal_op(self, op: dict, now: float) -> None:
        """Replay one logged transition: the mutation the live path applies
        after logging it."""
        kind = op.get("op")
        if kind == "join":
            self.members[int(op["rank"])] = MemberInfo(int(op["rank"]), int(op["kind"]),
                                                       int(op["inc"]), now)
        elif kind in ("leave", "expire", "revoke"):
            self.members.pop(int(op["rank"]), None)
        elif kind == "map":
            self.shard_map = ShardMap(int(op["version"]), int(op["n_params"]),
                                      [ShardEntry(*(int(v) for v in e))
                                       for e in op.get("entries", ())])
        elif kind == "snap":
            self._snap_seq = max(self._snap_seq, int(op["id"]))
        elif kind == "roll":
            self._roll_seq = max(self._roll_seq, int(op["id"]))
        elif kind == "park":
            self._parked_durable[int(op["rank"])] = dict(op["parked"])
        elif kind == "unpark":
            self._parked_durable.pop(int(op["rank"]), None)
        # "manifest" carries nothing beyond the snapshot clock: the manifest
        # file is the durable artifact

    def _wal_record(self, **op) -> None:
        """Log one control-plane transition before it is applied (log, then
        mutate); a memory-only coordinator logs nothing."""
        if self._wal is None:
            return
        self._wal_seq += 1
        self._wal.append(self._wal_seq, _op_to_f32(op))
        self._wal.sync()

    def checkpoint(self) -> None:
        """Write the JSON checkpoint and truncate the log it covers."""
        if self._wal is None or self._ckpt_path is None:
            return
        sched_state = None
        if self.sched is not None:
            sched_state = {
                "next_grant": int(self.sched._next_grant),
                "next_slot": int(self.sched.ledger._next_slot),
                "slots": [[int(s.slot_id), None if s.rank is None else int(s.rank),
                           [int(o) for o in s.owners], s.state, int(s.grant_id), s.parked]
                          for s in self.sched.ledger.slots.values()],
            }
        state = {
            "epoch": int(self.epoch),
            "wal_seq": int(self._wal_seq),
            "members": [[m.rank, m.kind, m.incarnation] for m in self._live()],
            "map": {
                "version": int(self.shard_map.version),
                "n_params": int(self.shard_map.n_params),
                "entries": [[e.server_id, e.lo, e.hi, e.fresh_lo, e.fresh_hi]
                            for e in self.shard_map.entries],
            },
            "snap_seq": int(self._snap_seq),
            "roll_seq": int(self._roll_seq),
            "next_task": int(self._next_task),
            "parked": {str(r): p for r, p in self._parked_durable.items()},
            "sched": sched_state,
        }
        atomic_write(self._ckpt_path, json.dumps(state, sort_keys=True).encode("utf-8"))
        self._ckpt_seq = self._wal_seq
        self._wal.truncate(self._wal_seq)

    def parked_ranks(self) -> set:
        """Ranks whose silence is a park, not a death: the durable park
        table together with the scheduler's own view, so a restart cannot
        re-arm lease expiry on a parked member."""
        parked = set(self._parked_durable)
        if self.sched is not None:
            parked |= self.sched.parked_ranks()
        return parked

    def note_parked(self, rank: int, parked: dict) -> None:
        """The scheduler's hook, before its ledger changes: log the park,
        then keep its ticket in the durable table."""
        self._wal_record(op="park", rank=int(rank), parked=dict(parked))
        self._parked_durable[int(rank)] = dict(parked)
        self._ckpt_due = True

    def note_unparked(self, rank: int) -> None:
        """The scheduler's hook when a parked rank's new life rejoined: log
        the unpark and drop the rank from the durable table."""
        self._wal_record(op="unpark", rank=int(rank))
        self._parked_durable.pop(int(rank), None)
        self._ckpt_due = True

    def _restore_sched_state(self, sched) -> None:
        """Seed a newly attached scheduler with the previous life's
        checkpointed ledger, then reconcile its slots with the durable park
        table: a slot whose rank the table holds is parked, and a parked
        rank with no slot (a park after the last checkpoint) gets its slot
        back from the logged ticket, owned by the borrower under the
        original grant, so releasing it drives the resume."""
        from distributed_ml_pytorch_tpu_torch.coord.sched import PARKED, Slot

        restore = self._sched_restore
        if restore is not None:
            sched._next_grant = int(restore.get("next_grant", 1))
            sched.ledger._next_slot = int(restore.get("next_slot", 0))
            for sid, rank, owners, state, grant_id, parked in restore.get("slots", ()):
                slot = Slot(slot_id=int(sid), rank=None if rank is None else int(rank),
                            owners=[int(o) for o in owners], state=str(state),
                            grant_id=int(grant_id),
                            parked=None if parked is None else dict(parked))
                sched.ledger.slots[slot.slot_id] = slot
            self._sched_restore = None
        for slot in sched.ledger.slots.values():
            durable = self._parked_durable.get(slot.rank)
            if durable is not None and slot.parked is None:
                slot.parked = dict(durable)
                slot.state = PARKED
                self._log(f"restore: slot {slot.slot_id} reconciled to PARKED from the durable "
                          f"park table (rank {slot.rank})")
        known = {s.rank for s in sched.ledger.slots.values()}
        for rank, durable in sorted(self._parked_durable.items()):
            if rank in known or durable.get("gray"):
                # a gray-failure quarantine ticket borrowed no capacity
                continue
            sid = int(durable.get("slot_id", sched.ledger._next_slot))
            gid = int(durable.get("grant_id", 0))
            borrower = durable.get("borrower")
            sched.ledger.slots[sid] = Slot(
                slot_id=sid, rank=int(rank),
                owners=[] if borrower is None else [int(borrower)], state=PARKED,
                grant_id=gid, parked=dict(durable))
            sched.ledger._next_slot = max(sched.ledger._next_slot, sid + 1)
            sched._next_grant = max(sched._next_grant, gid + 1)
            self._log(f"restore: slot {sid} RESYNTHESIZED from the WAL'd park ticket (rank "
                      f"{rank}, borrower {borrower}, grant {gid}) — no checkpoint covered this "
                      "preemption")

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
            float(self.gray.suspect_count()) if self.gray is not None else 0.0,
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


    def _broadcast_rollback(self, payload: np.ndarray) -> None:
        """Rollback frames go to the live fleet and to the revoked ranks
        still cooling down: a revoked worker keeps running (its pushes are
        nacked at the gate) and holds an accumulator computed on the state
        being discarded, which it must drop like everyone else."""
        self._broadcast(MessageCode.RollbackRequest, payload)
        live = {m.rank for m in self._live()}
        for rank in self._reputation_block:
            if rank not in live:
                self._send(rank, MessageCode.RollbackRequest, payload)

    # -------------------------------------------------------------- handle
    def handle(self, sender: int, code: MessageCode, payload: np.ndarray) -> None:
        """Process one member frame, synchronously (tests call it directly)."""
        now = self._clock()
        # any frame of a restored member re-attaches it: the grace window
        # closes early once everyone is back
        self._grace_pending.discard(sender)
        member = self.members.get(sender)
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
            blocked_until = self._reputation_block.get(sender)
            if blocked_until is not None:
                if now < blocked_until:
                    # a revoked worker's join retries wait out its cooldown,
                    # logged once
                    if sender not in self._block_logged:
                        self._block_logged.add(sender)
                        self._log(f"join of worker {sender} refused: reputation cooldown "
                                  f"({blocked_until - now:.1f}s left)")
                    return
                del self._reputation_block[sender]
                self._block_logged.discard(sender)
                self._log(f"worker {sender} reputation cooldown over — rejoin admitted "
                          "(fresh params via its pull)")
            is_new = member is None or member.incarnation != inc
            rebirth = member is not None and inc > member.incarnation
            if is_new:
                self._wal_record(op="join", rank=sender, kind=kind, inc=inc)
                self.members[sender] = MemberInfo(sender, kind, inc, now)
                # a new life counts nonfinite losses from 0: the watchdog's
                # consumed-evidence mark starts over with it
                self._bad_loss_seen.pop(sender, None)
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
            if code == MessageCode.LeaseRenew and payload.size >= 2 \
                    and now < self._reputation_block.get(sender, now):
                # a revoked life still renewing in its cooldown: tell it again
                # (the notice at the revocation may have been lost)
                self._send(sender, MessageCode.CoordLeave, np.asarray(payload[:2], np.float32))
            return  # before a join or after an expiry: the join retry fixes it
        if code == MessageCode.CoordLeave and payload.size >= 2:
            inc = _join16(payload[0], payload[1])
            if inc != member.incarnation:
                # an old life's parting leave must not evict the new life
                self._log(f"ignored stale leave of rank {sender} "
                          f"(inc {inc} != {member.incarnation})")
                return
            self._wal_record(op="leave", rank=sender)
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
        if code == MessageCode.SnapshotDone and payload.size >= 12:
            if not np.isfinite(payload[:12]).all():
                return
            member.last_seen = now
            self._on_snapshot_done(
                sender, snapshot_id=_join16(payload[0], payload[1]),
                map_version=_join16(payload[2], payload[3]), lo=_join16(payload[4], payload[5]),
                hi=_join16(payload[6], payload[7]), apply_seq=_join16(payload[8], payload[9]),
                push_count=_join16(payload[10], payload[11]))
            return
        if code == MessageCode.RollbackDone and payload.size >= 10:
            if not np.isfinite(payload[:10]).all():
                return
            member.last_seen = now
            self._on_rollback_done(
                sender, rollback_id=_join16(payload[0], payload[1]),
                map_version=_join16(payload[2], payload[3]), lo=_join16(payload[4], payload[5]),
                hi=_join16(payload[6], payload[7]), apply_seq=_join16(payload[8], payload[9]))
            return
        if code == MessageCode.PreemptDone and payload.size >= 10:
            if not np.isfinite(payload[:10]).all():
                return
            member.last_seen = now
            grant_id = _join16(payload[0], payload[1])
            # the gray plane's quarantine parks use a reserved grant-id space,
            # so their reports never reach the scheduler's bookkeeping
            owner = (self.gray if self.gray is not None and self.gray.owns_grant(grant_id)
                     else self.sched)
            if owner is not None:
                owner.on_preempt_done(
                    sender, grant_id=grant_id, snap_id=_join16(payload[2], payload[3]),
                    lo=_join16(payload[4], payload[5]), hi=_join16(payload[6], payload[7]),
                    apply_seq=_join16(payload[8], payload[9]), now=now)
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
                # nacks drive reputation; bad_loss and loss_ewma the watchdog
                member.nacks = int(payload[6])
                if member.nack_base < 0:
                    member.nack_base = member.nacks
                member.bad_loss = int(payload[7])
                member.loss_ewma = float(payload[8])
                member.gnorm_ewma = float(payload[9])
                self._check_reputation(member, now)
            links = ()
            if n >= 15:
                member.retrans_rate = float(payload[10])
                member.nack_rate = float(payload[11])
                member.blocked_s = float(payload[12])
                member.fsync_p95_ms = float(payload[13])
                member.busy_ratio = float(payload[14])
                # the per-link (peer, retrans, blocked_s) triples behind them
                rest = payload[15:]
                rest = rest[np.isfinite(rest)]
                links = tuple((int(rest[k]), float(rest[k + 1]), float(rest[k + 2]))
                              for k in range(0, (rest.size // 3) * 3, 3))
            if self.gray is not None:
                self.gray.on_renew(member, now, links)
            return
        # any other frame from a known member is evidence of life
        member.last_seen = now

    # ---------------------------------------------------------------- tick
    def tick(self) -> bool:
        """Expire leases, rebalance, maybe speculate, and drive the barriers
        and the checkpoint cadence; True when the membership changed.
        :meth:`run` calls it every ``lease / 4``."""
        now = self._clock()
        # a restart's grace window: restored members are presumed alive, so
        # a control-plane blip does not turn into mass eviction
        in_grace = bool(self._grace_until)
        if in_grace:
            if not self._grace_pending:
                self._log("grace window closed early: every restored member re-attached")
                self._grace_until = 0.0
                in_grace = False
            elif now >= self._grace_until:
                self._log(f"grace window over; still silent: {sorted(self._grace_pending)} "
                          "— lease expiry re-armed")
                self._grace_until = 0.0
                self._grace_pending.clear()
                in_grace = False
        # a parked member stops renewing by design: expiring it would move
        # its range away and make the resume impossible
        parked = self.parked_ranks()
        expired = [] if in_grace else [m for m in self.members.values()
                                       if now - m.last_seen > self.lease
                                       and m.rank not in parked]
        shard_died = False
        for m in expired:
            self._wal_record(op="expire", rank=m.rank)
            del self.members[m.rank]
            self.speculated.pop(m.rank, None)
            self._log(f"{m.kind_name} {m.rank} lease expired "
                      f"({now - m.last_seen:.1f}s silent)")
            shard_died |= m.kind == KIND_SHARD
        if shard_died:
            self._rebalance("lease expiry")
        elif expired:
            self._announce()
        if self.speculation and not in_grace:
            self.check_stragglers()
        self.check_engine_scaling(now)
        if self.sched is not None:
            self.sched.tick(now)
        if self.gray is not None:
            self.gray.tick(now)
        # --- the snapshot barrier
        due = self._next_snap_at is not None and now >= self._next_snap_at
        if self._snap_requested or due:
            self._snap_requested = False
            if self._next_snap_at is not None:
                self._next_snap_at = now + self.snapshot_interval
            self._start_snapshot(now)
        if self._snap is not None and now - self._snap["started"] > self.snapshot_timeout:
            self._log(f"snapshot {self._snap['id']} abandoned: shards "
                      f"{sorted(self._snap['expected'] - set(self._snap['got']))} never "
                      f"reported within {self.snapshot_timeout:.0f}s")
            self._snap = None
        # --- the watchdog and the rollback barrier
        self._check_numerical_health(now)
        if self._rollback_requested:
            self._rollback_requested = False
            self._start_rollback(now, "explicit trigger")
        if self._roll is not None and now - self._roll["started"] > self.rollback_timeout:
            missing = sorted(self._roll["expected"] - set(self._roll["got"]))
            self._log(f"rollback {self._roll['id']} ABANDONED: shards {missing} never "
                      f"reported within {self.rollback_timeout:.0f}s")
            # the end goes out all the same: the members' holds must release
            self._broadcast_rollback(encode_rollback_request(
                self._roll["id"], self._roll["snapshot_id"], self._roll["map_version"], 1))
            self.rollbacks_abandoned += 1
            self._flight_dump(f"rollback{self._roll['id']}-abandoned")
            self._roll = None
        # --- the checkpoint cadence (every logged transition is applied now)
        if self._wal is not None and (self._ckpt_due
                                      or self._wal_seq - self._ckpt_seq >= self._ckpt_every):
            self._ckpt_due = False
            self.checkpoint()
        return bool(expired)

    def _rebalance(self, why: str) -> None:
        new_map = rebalance(self.shard_map, [m.rank for m in self._live(KIND_SHARD)])
        # the version bump is durable before it is installed and sent: a
        # restart never hands out a version older than one on the wire
        self._wal_record(op="map", version=new_map.version, n_params=new_map.n_params,
                         entries=[[e.server_id, e.lo, e.hi, e.fresh_lo, e.fresh_hi]
                                  for e in new_map.entries])
        self.shard_map = new_map
        self._log(f"shard map v{self.shard_map.version} on {why}: "
                  + (", ".join(f"s{e.server_id}=[{e.lo},{e.hi})"
                               for e in self.shard_map.entries) or "EMPTY"))
        if self._snap is not None:
            # a barrier frozen at an older map can never complete consistently
            self._log(f"snapshot {self._snap['id']} aborted: shard map moved to "
                      f"v{self.shard_map.version} mid-barrier")
            self._snap = None
        self._announce()

    # ------------------------------------------------------ snapshot barrier
    def trigger_snapshot(self) -> None:
        """Ask for a fleet snapshot; the serve loop's next tick starts the
        barrier. Safe from any thread."""
        self._snap_requested = True

    def manifest_path(self) -> Optional[str]:
        if not self.manifest_dir:
            return None
        return os.path.join(self.manifest_dir, MANIFEST_NAME)

    def _start_snapshot(self, now: float) -> None:
        if self._snap is not None:
            self._log(f"snapshot request ignored: snapshot {self._snap['id']} still in flight")
            return
        shards = self._live(KIND_SHARD)
        if not shards:
            self._log("snapshot request ignored: no live shard servers")
            return
        parked = self.parked_ranks()
        if any(m.rank in parked for m in shards):
            # a parked shard cannot answer, and a manifest without its range
            # is no fleet snapshot: wait for the resume
            self._log("snapshot request deferred: shard(s) "
                      f"{sorted(r for r in parked)} parked by the scheduler")
            return
        self._wal_record(op="snap", id=self._snap_seq + 1)
        self._snap_seq += 1
        self._snap = {"id": self._snap_seq, "map_version": self.shard_map.version,
                      "expected": {m.rank for m in shards}, "got": {}, "started": now}
        self._log(f"snapshot {self._snap_seq} started: map v{self.shard_map.version}, "
                  f"awaiting {sorted(self._snap['expected'])}")
        frame = encode_snapshot_request(self._snap_seq, self.shard_map.version)
        for m in shards:
            self._send(m.rank, MessageCode.SnapshotRequest, frame)

    def _on_snapshot_done(self, sender: int, *, snapshot_id: int, map_version: int, lo: int,
                          hi: int, apply_seq: int, push_count: int) -> None:
        snap = self._snap
        if snap is None or snapshot_id != snap["id"]:
            self._log(f"stale SnapshotDone from shard {sender} (snapshot {snapshot_id})")
            return
        if map_version != snap["map_version"]:
            # a shard checkpointed under another map: no manifest from a
            # mixed barrier
            self._log(f"snapshot {snap['id']} aborted: shard {sender} reported map "
                      f"v{map_version}, barrier is at v{snap['map_version']}")
            self._snap = None
            return
        entry = self.shard_map.entry_for(sender)
        if entry is None or (entry.lo, entry.hi) != (lo, hi):
            self._log(f"snapshot {snap['id']} aborted: shard {sender} reported range "
                      f"[{lo},{hi}) but the map assigns "
                      f"{None if entry is None else (entry.lo, entry.hi)}")
            self._snap = None
            return
        snap["got"][sender] = ShardRecord(server_id=sender, lo=lo, hi=hi,
                                          map_version=map_version, apply_seq=apply_seq,
                                          push_count=push_count)
        if set(snap["got"]) >= snap["expected"]:
            self._finalize_snapshot(snap)
            self._snap = None

    def _finalize_snapshot(self, snap: dict) -> None:
        manifest = FleetManifest(snapshot_id=snap["id"], map_version=snap["map_version"],
                                 n_params=self.shard_map.n_params,
                                 shards=tuple(snap["got"][r] for r in sorted(snap["got"])),
                                 complete=True)
        path = self.manifest_path()
        if path is not None:
            os.makedirs(self.manifest_dir, exist_ok=True)
            manifest.write(path)
        self._wal_record(op="manifest", snap_id=int(manifest.snapshot_id),
                         map_version=int(manifest.map_version))
        self.last_manifest = manifest
        self.manifests_written += 1
        self._log(f"snapshot {snap['id']} complete: map v{snap['map_version']}, "
                  + ", ".join(f"s{r.server_id}=[{r.lo},{r.hi})@{r.apply_seq}"
                              for r in manifest.shards)
                  + (f" -> {path}" if path else " (in-memory only)"))

    # --------------------------------------------------- reputation, rollback
    def revoke_member(self, rank: int, why: str, cooldown: Optional[float] = None) -> None:
        """Revoke a member's lease with a cooldown: its join retries are
        refused until the cooldown ends, then it rejoins as a new life and
        pulls fresh params; a revoked shard's range rebalances away."""
        member = self.members.get(rank)
        if member is None:
            return
        cd = self.reputation_cooldown if cooldown is None else float(cooldown)
        self._wal_record(op="revoke", rank=rank)
        del self.members[rank]
        self.speculated.pop(rank, None)
        self._reputation_block[rank] = self._clock() + cd
        self.revoked_workers += 1
        # the revoked life learns it (its finish must not wait on shards that
        # no longer count it); its renewals in the cooldown are answered too
        self._send(rank, MessageCode.CoordLeave, encode_leave(member.incarnation))
        self._log(f"{member.kind_name} {rank} lease REVOKED: {why} — cooldown {cd:.1f}s, "
                  "then it rejoins and pulls fresh params")
        if member.kind == KIND_SHARD:
            self._rebalance(f"revocation of shard server {rank}")
        else:
            self._announce()

    def _check_reputation(self, member: MemberInfo, now: float) -> None:
        """Revoke a worker whose admission nacks since it (re)joined reached
        ``reputation_nacks``."""
        if self.reputation_nacks <= 0 or member.kind != KIND_WORKER or member.nack_base < 0:
            return
        offenses = member.nacks - member.nack_base
        if offenses < self.reputation_nacks:
            return
        self.revoke_member(member.rank, f"reputation: {offenses} quarantined update(s) "
                                        "this life")

    def trigger_rollback(self) -> None:
        """Ask for a fleet rollback to the last good manifest; the serve
        loop's next tick starts the barrier. Safe from any thread."""
        self._rollback_requested = True

    def _check_numerical_health(self, now: float) -> None:
        """The watchdog: a worker reporting a new nonfinite loss, or the
        fleet-mean loss EWMA past ``rollback_loss_factor`` times the best
        fleet mean seen. It runs every tick, so the best loss tracks the
        whole run; ``auto_rollback`` gates only the firing, so a watchdog
        armed mid-run judges against the healthy baseline."""
        if now < self._next_rollback_at or self._roll is not None:
            return
        workers = [m for m in self._live(KIND_WORKER) if m.reported]
        if not workers:
            return
        why = None
        bad = [m.rank for m in workers if m.bad_loss > self._bad_loss_seen.get(m.rank, 0)]
        if bad:
            why = f"worker(s) {bad} report nonfinite losses"
        else:
            cur = [m.loss_ewma for m in workers if m.loss_ewma > 0]
            if cur:
                mean_loss = sum(cur) / len(cur)
                if self._fleet_best_loss is None or mean_loss < self._fleet_best_loss:
                    self._fleet_best_loss = mean_loss
                elif (self.rollback_loss_factor > 0
                      and mean_loss > self.rollback_loss_factor * self._fleet_best_loss):
                    why = (f"fleet loss EWMA {mean_loss:.4g} diverged past "
                           f"{self.rollback_loss_factor:.2f}x best "
                           f"{self._fleet_best_loss:.4g}")
        if why is not None and self.auto_rollback:
            self._start_rollback(now, why)

    def _start_rollback(self, now: float, why: str) -> None:
        if self._roll is not None:
            self._log(f"rollback request ignored: rollback {self._roll['id']} still in flight")
            return
        manifest = self.last_manifest
        if manifest is None:
            self._log(f"rollback wanted ({why}) but no FleetManifest exists yet — nothing "
                      "good to restore")
            self._next_rollback_at = now + self.rollback_cooldown
            return
        if manifest.map_version != self.shard_map.version:
            self._log(f"rollback wanted ({why}) but the manifest is for map "
                      f"v{manifest.map_version}, fleet is at v{self.shard_map.version} — "
                      "take a fresh snapshot first")
            self._next_rollback_at = now + self.rollback_cooldown
            return
        shards = self._live(KIND_SHARD)
        if not shards:
            self._log(f"rollback wanted ({why}) but no live shard servers")
            return
        if self._snap is not None:
            # a snapshot mid-rollback would capture the state being discarded
            self._log(f"snapshot {self._snap['id']} aborted: rollback supersedes")
            self._snap = None
        self._wal_record(op="roll", id=self._roll_seq + 1)
        self._roll_seq += 1
        self._roll = {"id": self._roll_seq, "snapshot_id": int(manifest.snapshot_id),
                      "map_version": int(manifest.map_version),
                      "expected": {m.rank for m in shards}, "got": set(), "started": now}
        self._next_rollback_at = now + self.rollback_cooldown
        # the evidence that fired this barrier is spent: divergence must be
        # shown again on telemetry from after the restore
        for m in self.members.values():
            self._bad_loss_seen[m.rank] = m.bad_loss
            m.loss_ewma = 0.0
        self._fleet_best_loss = None
        self._log(f"ROLLBACK {self._roll_seq} started ({why}): restoring snapshot "
                  f"{manifest.snapshot_id} / map v{manifest.map_version}, awaiting shards "
                  f"{sorted(self._roll['expected'])}")
        self._broadcast_rollback(encode_rollback_request(
            self._roll_seq, manifest.snapshot_id, manifest.map_version, 0))

    def _on_rollback_done(self, sender: int, *, rollback_id: int, map_version: int, lo: int,
                          hi: int, apply_seq: int) -> None:
        roll = self._roll
        if roll is None or rollback_id != roll["id"]:
            self._log(f"stale RollbackDone from shard {sender} (rollback {rollback_id})")
            return
        if map_version != roll["map_version"]:
            self._log(f"rollback {roll['id']}: shard {sender} reported map v{map_version}, "
                      f"barrier is at v{roll['map_version']} — ignoring (the timeout "
                      "abandons a barrier that cannot complete)")
            return
        entry = self.shard_map.entry_for(sender)
        if entry is None or (entry.lo, entry.hi) != (lo, hi):
            self._log(f"rollback {roll['id']}: shard {sender} reported range [{lo},{hi}) but "
                      f"the map assigns {None if entry is None else (entry.lo, entry.hi)} — "
                      "ignoring")
            return
        roll["got"].add(sender)
        self._log(f"rollback {roll['id']}: shard {sender} restored [{lo},{hi}) at apply seq "
                  f"{apply_seq}")
        if roll["expected"] <= roll["got"]:
            mttr = self._clock() - roll["started"]
            self.rollbacks_done += 1
            self.rollback_mttrs.append(mttr)
            self._log(f"ROLLBACK {roll['id']} complete in {mttr * 1e3:.0f} ms: fleet restored "
                      f"to snapshot {roll['snapshot_id']} — workers resync by pull, frontends "
                      "re-admit")
            self._broadcast_rollback(encode_rollback_request(
                roll["id"], roll["snapshot_id"], roll["map_version"], 1))
            self._roll = None
            self._flight_dump(f"rollback{roll['id']}")

    # ------------------------------------------------------- engine scaling
    def check_engine_scaling(self, now: Optional[float] = None) -> Optional[str]:
        """Advise replica scaling from the engines' own reports: ``"up"`` or
        ``"down"`` when advice fired this call, else None; at most once a
        ``scale_cooldown``. Engines renew with occupancy %, queue depth and
        TTFT ms in the (push count, step, EWMA) fields; an engine that never
        renewed is left out of the mean, an idle one (all zeros) counts."""
        if self.engine_occ_high <= 0 and self.engine_occ_low <= 0 \
                and self.engine_slo_ttft_ms <= 0:
            return None
        now = self._clock() if now is None else now
        if now < self._next_scale_at:
            return None
        engines = self._live(KIND_ENGINE)
        reported = [m for m in engines if m.reported]
        if not reported:
            return None
        mean_occ = sum(m.push_count for m in reported) / (100.0 * len(reported))
        mean_ttft = sum(m.ewma_ms for m in reported) / len(reported)
        detail = {
            "n_engines": len(engines), "mean_occupancy": round(mean_occ, 3),
            "mean_ttft_ms": round(mean_ttft, 2),
            "per_engine": {m.rank: {"occupancy": m.push_count / 100.0, "queued": m.step,
                                    "ttft_ms": m.ewma_ms} for m in reported},
        }
        direction = None
        if (self.engine_occ_high > 0 and mean_occ >= self.engine_occ_high) \
                or (self.engine_slo_ttft_ms > 0 and mean_ttft > self.engine_slo_ttft_ms):
            direction = "up"
        elif self.engine_occ_low > 0 and mean_occ <= self.engine_occ_low and len(engines) > 1:
            direction = "down"
        if direction is None:
            return None
        self._next_scale_at = now + self.scale_cooldown
        self.scale_advice.append((direction, detail))
        self._log(f"engine scale-{direction} advised: mean occupancy {mean_occ:.0%}, mean TTFT "
                  f"{mean_ttft:.1f} ms over {len(reported)} reporting engine(s)")
        if self.on_scale is not None:
            self.on_scale(direction, detail)
        return direction

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
            if now >= next_tick or self._snap_requested:
                # a requested barrier starts at the next pass, not the next
                # lease tick: the drills time their recovery in wall time
                self.tick()
                next_tick = now + max(0.05, self.lease / 4)
            msg = self.transport.recv(timeout=0.1)
            if msg is None:
                continue
            try:
                self.handle(*msg)
            except (ValueError, IndexError, OverflowError):
                continue  # a malformed member frame: drop it, never die
