"""Tagged-tensor messaging for the DownPour control plane (counterpart of the
JAX ``utils/messaging.py``; numpy, sockets and threads only).

- :class:`MessageCode` — the whole tag enum, with the JAX package's integer
  values, so a frame means the same thing to either package; and
  :data:`WIRE_SCHEMAS`, the declarative layout and protocol contract (dedup
  key, durability, delivery) of every code this package sends or
  dispatches on, the JAX table's entries for them: the server reads
  ``durability`` to hold a push's ack behind the WAL, and
  :class:`ReliableTransport` takes its best-effort codes from ``delivery``;
- :class:`InProcessTransport` — queue-based, a whole world in one process;
- :class:`TCPTransport` — a star of sockets between processes (rank 0 is the
  server), with the JAX package's wire format: a little-endian header
  ``(sender:i32, code:i32, nbytes:i64)`` followed by a float32 payload. The
  server keeps accepting after the rendezvous, so a restarted worker of the
  same rank replaces its dead socket; ``sendv`` writes one frame from
  several parts without joining them;
- :class:`ReliableTransport` — wraps any transport with per-peer sequence
  numbers, a frame checksum, acks and retransmission and receiver-side
  dedup: at-least-once on the wire, exactly-once application at the
  receiver. The envelope rides the float32 wire (every header field below
  2^16, exact in float32), so Python, TCP and native endpoints of either
  package carry it. Per peer: an RTT-estimated retransmission timeout
  (Jacobson/Karels, Karn's rule), a sliding window bounded by the
  receiver's advertised credit, cumulative acks with SACK-style acks for
  out-of-order frames, and a circuit breaker; deferred acks
  (``ack_on_delivery=False``) hold a frame's ack until the receiver calls
  ``ack_delivered`` (the WAL's group commit);
- :func:`make_transport` / :func:`make_world` — the factories (the world
  optionally under a ``utils/chaos.ChaosPlan``);
- :func:`stamp_epoch` / :func:`strip_epoch` — the coordinator's epoch fence
  trailer;
- ``send_message`` / :class:`MessageListener` — the reference's API
  (``Asynchronous.py:5,9-18``), on an explicit or a default transport.

Payloads on the wire are host float32 arrays. ``send_message`` accepts a
torch tensor on any device and copies it to the host.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import logging
import os
import queue
import random
import socket
import struct
import threading
import time
import weakref
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from distributed_ml_pytorch_tpu_torch.utils import obs as _obs
from distributed_ml_pytorch_tpu_torch.utils.backoff import Backoff

_LOGGER = logging.getLogger(__name__)

_HEADER = struct.Struct("<iiq")

#: upper bound on a declared frame payload: a malformed header must not make
#: the reader allocate unbounded memory (256M float32 parameters)
MAX_FRAME_BYTES = 1 << 30

#: frames of at most this many payload bytes leave in one ``sendall``
_SMALL_FRAME_BYTES = 1 << 16

SERVER_RANK = 0  # reference convention: rank 0 is the parameter server


class MessageCode(enum.IntEnum):
    """Message tags, value for value the JAX package's. This package speaks
    codes 0-4 (the DownPour path), 9, 10 and 26 (the reliability envelope
    and its acks), 13-20, 24 and 25 (the coordinator, its shard maps and the
    stamped shard traffic), 27 (``UpdateNack``, the admission gate's
    reject), 34 (``CompressedUpdate``) and 39 (``DeltaParams``); the rest
    are defined so that frames from the JAX package's other planes decode
    to their names."""

    ParameterUpdate = 0
    ParameterRequest = 1
    GradientUpdate = 2
    WorkerDone = 3
    Heartbeat = 4
    SubmitRequest = 5
    StreamTokens = 6
    ServeReject = 7
    CancelRequest = 8
    ReliableFrame = 9
    ReliableAck = 10
    StreamAck = 11
    ResumeStream = 12
    CoordJoin = 13
    CoordLeave = 14
    LeaseRenew = 15
    ShardMapUpdate = 16
    FleetState = 17
    SpeculateTask = 18
    SpeculativeUpdate = 19
    RangeInstall = 20
    SnapshotRequest = 21
    SnapshotDone = 22
    SubmitRequestV2 = 23
    ShardPush = 24
    ShardParams = 25
    CumAck = 26
    UpdateNack = 27
    RollbackRequest = 28
    RollbackDone = 29
    ActivationShip = 30
    ActivationGrad = 31
    StageReady = 32
    StageAssign = 33
    CompressedUpdate = 34
    PreemptRequest = 35
    PreemptDone = 36
    SlotGrant = 37
    ResumeRequest = 38
    DeltaParams = 39
    KvMigrate = 40


#: dedup-key vocabulary: WHICH receiver-side guard makes an at-least-once
#: redelivery of a code safe to apply.
#:
#: - ``env_seq``      — the reliability envelope's per-peer (incarnation,
#:   seq) dedup window, re-seeded across receiver restarts from the WAL /
#:   checkpoint meta (``ReliableTransport.seed_dedup``);
#: - ``step_mb``      — application-level ``(step, microbatch)`` dedup;
#: - ``request_id``   — an explicit id in the payload head: first-wins or
#:   offset-resumable per id;
#: - ``incarnation``  — lives of a rank are ordered by incarnation; stale
#:   lives' frames are ignored or merely re-acked;
#: - ``version``      — versioned last-write-wins install: an older version
#:   never rolls a consumer back, a duplicate of the current one is a no-op;
#: - ``idempotent``   — re-applying is harmless by construction (reads,
#:   whole-state installs, set-adds).
DEDUP_KEYS = ("env_seq", "step_mb", "request_id", "incarnation",
              "version", "idempotent")

#: durability vocabulary: ``wal_before_ack`` marks a code whose applied
#: state mutation must be logged before its delivery ack is released
#: (log-before-ack). Everything else is "none".
DURABILITY = ("none", "wal_before_ack")

#: delivery vocabulary: ``reliable`` rides the ReliableTransport envelope
#: (retry until acked), ``best_effort`` is deliberately un-enveloped
#: (periodic and self-healing: the ``unreliable_codes`` set), ``envelope``
#: is the reliability layer's own wire (the mechanism, not a user).
DELIVERY = ("reliable", "best_effort", "envelope")


@dataclasses.dataclass(frozen=True)
class PayloadSchema:
    """The declarative wire layout and protocol contract of one
    :class:`MessageCode`, field for field the JAX package's.

    Every payload is ``[*fields, *rest]`` on the tagged-float32 wire:
    ``fields`` names the fixed head positions (``*_lo``/``*_hi`` pairs are
    uint16 halves of one 32-bit value, :func:`_split16`), ``rest`` names the
    variable tail (``None`` for fixed-size frames; ``rest_min`` is the
    tail's minimum length when one is required) and ``handled_by`` the
    planes whose modules dispatch on the code (``ps``, ``serving``,
    ``coord`` or ``transport``).

    Protocol annotations:

    - ``dedup_key`` — one of :data:`DEDUP_KEYS`, the guard that makes
      at-least-once redelivery safe;
    - ``durability`` — one of :data:`DURABILITY`;
    - ``delivery`` — one of :data:`DELIVERY`; the ``best_effort`` codes
      are ``ReliableTransport``'s default ``unreliable_codes``
      (:data:`BEST_EFFORT_CODES`);
    - ``rest_sections`` / ``rest_separator`` — a tail that grew into
      several sections declares the sentinel that separates them (frames
      without it still decode);
    - ``fenced`` — a coordinator command that carries the coordinator's
      epoch fence trailer.

    :attr:`min_size` is the receiver-side minimum frame size.
    """

    fields: Tuple[str, ...] = ()
    rest: Optional[str] = None
    rest_min: int = 0
    handled_by: Tuple[str, ...] = ()
    doc: str = ""
    dedup_key: Optional[str] = None
    durability: str = "none"
    delivery: str = "reliable"
    rest_sections: Tuple[str, ...] = ()
    rest_separator: Optional[float] = None
    fenced: bool = False

    def __post_init__(self):
        if self.dedup_key is not None and self.dedup_key not in DEDUP_KEYS:
            raise ValueError(
                f"unknown dedup_key {self.dedup_key!r} (vocabulary: "
                f"{DEDUP_KEYS})")
        if self.durability not in DURABILITY:
            raise ValueError(
                f"unknown durability {self.durability!r} (vocabulary: "
                f"{DURABILITY})")
        if self.delivery not in DELIVERY:
            raise ValueError(
                f"unknown delivery {self.delivery!r} (vocabulary: "
                f"{DELIVERY})")
        if len(self.rest_sections) >= 2 and self.rest_separator is None:
            raise ValueError(
                "a multi-section rest tail needs a declared rest_separator "
                "(old frames must still decode)")

    @property
    def min_size(self) -> int:
        return len(self.fields) + self.rest_min


#: the codes this package's modules send or dispatch on: the parameter
#: server's plane (its compressed pushes and delta pull replies too), the
#: coordinator's membership plane and its stamped shard traffic, its snapshot
#: and rollback barriers, the scheduler's preempt, grant and resume, the
#: serving frontend's, the reliability wire, the coded wires the
#: ``wire_bytes`` bench leg prices, and the MPMD stage plane's (all of the
#: JAX table's codes).
WIRE_SCHEMAS: Dict[MessageCode, PayloadSchema] = {
    MessageCode.ParameterUpdate: PayloadSchema(
        rest="params", handled_by=("ps", "coord"), dedup_key="idempotent",
        doc="central flat params (server push / construction install)"),
    MessageCode.ParameterRequest: PayloadSchema(
        rest="held", handled_by=("ps", "coord"), dedup_key="idempotent",
        doc="pull request (also the TCP hello frame). Empty = legacy full pull. A "
            "delta-enabled worker appends its held stamp [held_epoch, held_ver_lo, "
            "held_ver_hi]: the server may then answer with a DeltaParams frame "
            "against exactly that (epoch, version) instead of the dense reply; "
            "held_epoch -1 forces a full reply (first pull / base miss)"),
    MessageCode.GradientUpdate: PayloadSchema(
        rest="params", handled_by=("ps", "coord"), dedup_key="env_seq",
        durability="wal_before_ack",
        doc="lr-pre-scaled accumulated update; server ADDS it"),
    MessageCode.WorkerDone: PayloadSchema(
        handled_by=("ps", "coord"), dedup_key="idempotent",
        doc="clean worker exit"),
    MessageCode.Heartbeat: PayloadSchema(
        handled_by=("ps", "coord"), dedup_key="idempotent", delivery="best_effort",
        doc="liveness only; never retried"),
    MessageCode.SubmitRequest: PayloadSchema(
        fields=("id", "max_new", "temperature", "top_k", "top_p", "seed", "eos"),
        rest="prompt", rest_min=1, handled_by=("serving",), dedup_key="request_id",
        doc="client -> engine; eos < 0 means none"),
    MessageCode.StreamTokens: PayloadSchema(
        fields=("id", "done_flag", "start_index"), rest="tokens",
        handled_by=("serving",), dedup_key="request_id",
        doc="engine -> client; start_index enables gap arithmetic"),
    MessageCode.ServeReject: PayloadSchema(
        fields=("id",), handled_by=("serving",), dedup_key="request_id",
        doc="queue full, or a resume the engine cannot serve"),
    MessageCode.CancelRequest: PayloadSchema(
        fields=("id",), handled_by=("serving",), dedup_key="request_id",
        doc="client -> engine"),
    MessageCode.ReliableFrame: PayloadSchema(
        fields=("inc_lo", "inc_hi", "seq_lo", "seq_hi", "crc_lo", "crc_hi", "code",
                "corr_lo", "corr_hi"),
        rest="payload", handled_by=("transport",), delivery="envelope",
        doc="reliability envelope; CRC covers header + body. corr is the "
            "flight-recorder CORRELATION id riding the envelope: the sender stamps "
            "its thread's active id (utils/obs.current_corr, 0 = none), the receiver "
            "restores it on delivery — one GradientUpdate / microbatch is followable "
            "across members without touching any inner payload layout"),
    MessageCode.ReliableAck: PayloadSchema(
        fields=("seq_lo", "seq_hi", "inc_lo", "inc_hi"), handled_by=("transport",),
        delivery="envelope",
        doc="ack echoes the frame's incarnation (stale-life acks ignored)"),
    MessageCode.StreamAck: PayloadSchema(
        fields=("id", "n_received"), handled_by=("serving",), dedup_key="request_id",
        doc="client progress + liveness"),
    MessageCode.ResumeStream: PayloadSchema(
        fields=("id", "n_received"), handled_by=("serving",), dedup_key="request_id",
        doc="re-send the stream from offset (gap recovery / reconnect)"),
    MessageCode.CoordJoin: PayloadSchema(
        fields=("kind", "inc_lo", "inc_hi"), handled_by=("coord",), dedup_key="incarnation",
        doc="member -> coordinator; idempotent, retried until answered"),
    MessageCode.CoordLeave: PayloadSchema(
        fields=("inc_lo", "inc_hi"), handled_by=("coord",), dedup_key="incarnation",
        doc="explicit leave; stale incarnations cannot evict newer lives"),
    MessageCode.LeaseRenew: PayloadSchema(
        fields=("inc_lo", "inc_hi", "push_count", "step", "ewma_ms", "wire_open", "nacks",
                "bad_loss", "loss_ewma", "gnorm_ewma", "retrans_rate", "nack_rate",
                "blocked_s", "fsync_p95_ms", "busy_ratio"),
        rest="gray_links", handled_by=("coord",), dedup_key="incarnation",
        delivery="best_effort",
        doc="lease refresh carrying the straggler-detector progress report, the member's "
            "open-circuit-breaker count (wire health), the numerical-health telemetry: "
            "cumulative admission nacks received, nonfinite-loss count, and loss / grad-norm "
            "EWMAs — the reputation + rollback-watchdog inputs — and the gray-health tail: "
            "retransmit rate, nack rate, blocked-send seconds, fsync p95 and busy-vs-wall "
            "ratio, plus per-directed-link (peer, retrans, blocked_s) evidence triples in the "
            "rest — the adaptive-suspicion inputs (receivers tolerate the 5/6/10-field older "
            "forms with neutral gray defaults)"),
    MessageCode.ShardMapUpdate: PayloadSchema(
        fields=("n_entries", "version_lo", "version_hi", "n_params_lo", "n_params_hi"),
        rest="entries", handled_by=("coord",), dedup_key="version", fenced=True,
        doc="encoded ShardMap; 9 floats per entry (coord/shardmap.py)"),
    MessageCode.FleetState: PayloadSchema(
        fields=("version_lo", "version_hi", "n_workers", "n_shards", "n_engines",
                "workers_done"),
        rest="engine_ranks", handled_by=("coord",), dedup_key="version",
        rest_sections=("engine_ranks", "fleet_metrics"), rest_separator=-1.0, fenced=True,
        doc="compact fleet broadcast the serving frontend consumes; the tail lists live "
            "engine coord-ranks (per-engine lease health) and, behind a -1 separator (ranks "
            "are non-negative, so the split is unambiguous; a tail without one decodes as "
            "older), the fleet_metrics registry summary in "
            "coord/coordinator.FLEET_METRICS_FIELDS order (the decoder zips names to the "
            "floats that arrived, so the gray_suspects field is absent, not wrong, on short "
            "frames)"),
    MessageCode.SpeculateTask: PayloadSchema(
        fields=("task_id", "victim_rank", "from_step"), handled_by=("coord",),
        dedup_key="request_id", fenced=True,
        doc="coordinator -> backup AND victim; same id for dedup"),
    MessageCode.SpeculativeUpdate: PayloadSchema(
        fields=("task_lo", "task_hi", "ver_lo", "ver_hi", "lo_lo", "lo_hi", "hi_lo", "hi_hi"),
        rest="payload", handled_by=("coord",), dedup_key="request_id",
        doc="Sandblaster backup-task result stamped like ShardPush; first task id wins at the "
            "PS, wrong-offset traffic dropped"),
    MessageCode.RangeInstall: PayloadSchema(
        fields=("lo_lo", "lo_hi", "hi_lo", "hi_hi"), rest="values", handled_by=("coord",),
        dedup_key="idempotent",
        doc="worker seeds a freshly-acquired shard range; first install wins"),
    MessageCode.SnapshotRequest: PayloadSchema(
        fields=("snap_lo", "snap_hi", "map_lo", "map_hi"), handled_by=("coord",),
        dedup_key="request_id", fenced=True,
        doc="coordinator -> shard servers: checkpoint at your next version boundary under "
            "this snapshot id / shard-map version"),
    MessageCode.SnapshotDone: PayloadSchema(
        fields=("snap_lo", "snap_hi", "map_lo", "map_hi", "lo_lo", "lo_hi", "hi_lo", "hi_hi",
                "apply_lo", "apply_hi", "push_lo", "push_hi"),
        handled_by=("coord",), dedup_key="request_id",
        doc="shard -> coordinator: checkpoint taken (range + apply seq + push count); the "
            "coordinator assembles the FleetManifest"),
    MessageCode.SubmitRequestV2: PayloadSchema(
        fields=("id", "max_new", "temperature", "top_k", "top_p", "seed", "eos",
                "priority", "deadline_ms", "session"),
        rest="prompt", rest_min=1, handled_by=("serving",), dedup_key="request_id",
        doc="client -> engine with overload-plane metadata: priority (higher wins "
            "admission under shed), deadline_ms (0 = none; relative to submit) and "
            "session (affinity hint)"),
    MessageCode.ShardPush: PayloadSchema(
        fields=("ver_lo", "ver_hi", "lo_lo", "lo_hi", "hi_lo", "hi_hi"), rest="params",
        rest_min=1, handled_by=("coord",), dedup_key="env_seq", durability="wal_before_ack",
        doc="elastic worker -> shard server: GradientUpdate stamped with the sender's "
            "shard-map version AND the absolute [lo,hi) it sliced — the RANGE is the "
            "correctness gate (closes the equal-size stale-map blind spot, coord/shardmap.py; "
            "a benign version bump with unmoved ranges stays compatible)"),
    MessageCode.ShardParams: PayloadSchema(
        fields=("ver_lo", "ver_hi", "lo_lo", "lo_hi", "hi_lo", "hi_hi"), rest="params",
        rest_min=1, handled_by=("ps",), dedup_key="version",
        doc="elastic shard server -> worker: pull reply stamped like ShardPush (the versioned "
            "ParameterUpdate); the worker applies only a reply whose range matches its "
            "current expectation"),
    MessageCode.CumAck: PayloadSchema(
        fields=("inc_lo", "inc_hi", "cum_lo", "cum_hi", "credit"),
        handled_by=("transport",), delivery="envelope",
        doc="batched cumulative ack: every seq <= cum of the echoed incarnation is "
            "acknowledged at once, and the receiver piggybacks its advertised "
            "send-window credit (the backpressure signal) — one small frame per "
            "delivery batch instead of one ReliableAck per frame"),
    MessageCode.UpdateNack: PayloadSchema(
        fields=("reason", "norm", "z"), handled_by=("ps",), dedup_key="env_seq",
        doc="server -> worker: your GradientUpdate/ShardPush was QUARANTINED by the "
            "admission gate (utils/health.py) — reason is a NACK_* code, norm/z the "
            "offending magnitude (clamped finite for the wire). A reject is never "
            "silent: the worker counts it, resyncs by pulling fresh params, and "
            "reports the count in LeaseRenew"),
    MessageCode.RollbackRequest: PayloadSchema(
        fields=("roll_lo", "roll_hi", "snap_lo", "snap_hi", "map_lo", "map_hi", "phase"),
        handled_by=("coord",), dedup_key="request_id", fenced=True,
        doc="coordinator -> everyone: the auto-rollback barrier. phase 0 = start (shards "
            "restore the named FleetManifest snapshot in place, workers drop in-flight "
            "accumulators and pull, serving frontends hold submits), phase 1 = complete/"
            "abandoned (holds release; member-side holds also expire on a TTL so a lost "
            "completion frame fails open)"),
    MessageCode.RollbackDone: PayloadSchema(
        fields=("roll_lo", "roll_hi", "map_lo", "map_hi", "lo_lo", "lo_hi", "hi_lo", "hi_hi",
                "apply_lo", "apply_hi"),
        handled_by=("coord",), dedup_key="request_id",
        doc="shard -> coordinator: range [lo,hi) restored to the manifest snapshot at "
            "apply_seq under this map version; all-reported completes the rollback barrier "
            "(MTTR measured)"),
    MessageCode.PreemptRequest: PayloadSchema(
        fields=("grant_lo", "grant_hi", "snap_lo", "snap_hi"),
        handled_by=("coord",), dedup_key="request_id", fenced=True,
        doc="scheduler (via coordinator) -> victim shard member: park yourself under "
            "grant_id; snap_id names the FleetManifest snapshot the scheduler barriered "
            "BEFORE issuing the preempt (the park-with-manifest gate the sched model "
            "checks). The member commits its WAL group, reports PreemptDone and stops "
            "serving WITHOUT a CoordLeave — a parked life, not a dead one"),
    MessageCode.PreemptDone: PayloadSchema(
        fields=("grant_lo", "grant_hi", "snap_lo", "snap_hi", "lo_lo", "lo_hi", "hi_lo",
                "hi_hi", "apply_lo", "apply_hi"),
        handled_by=("coord",), dedup_key="request_id",
        doc="parked shard -> coordinator: range [lo,hi) parked at apply_seq under snapshot "
            "snap_id; the scheduler frees the slot and only NOW may grant it to another "
            "tenant (the double-grant gate the sched model checks)"),
    MessageCode.SlotGrant: PayloadSchema(
        fields=("grant_lo", "grant_hi", "tenant", "action", "slot"),
        handled_by=("coord",), dedup_key="request_id", fenced=True,
        doc="scheduler -> node agent: actuate a placement decision — action 1 grants slot "
            "to tenant (the agent spawns that tenant's member kind, e.g. an EngineMember "
            "for a serving tenant), action 0 revokes it (the agent retires the member). "
            "grant_id makes redelivery first-wins idempotent"),
    MessageCode.ResumeRequest: PayloadSchema(
        fields=("grant_lo", "grant_hi", "rank", "snap_lo", "snap_hi"),
        handled_by=("coord",), dedup_key="request_id", fenced=True,
        doc="scheduler -> node agent: resume the member parked under grant_id as a fresh "
            "life of `rank`, restoring snapshot snap_id bit-for-bit from the FleetManifest "
            "and replaying WAL'd deltas exactly once before rejoining the fleet"),
    MessageCode.ActivationShip: PayloadSchema(
        fields=("step_lo", "step_hi", "mb", "kind", "ver_lo", "ver_hi", "codec"),
        rest="payload", rest_min=1, handled_by=("ps",), dedup_key="step_mb",
        doc="MPMD pipeline data plane: stage s -> s+1 activation hand-off for (step, "
            "microbatch), stamped with the sender's StagePlacement version. kind 0 = "
            "activation, 1 = tokens (driver -> first stage), 2 = targets (driver -> last "
            "stage), 3 = per-microbatch ce_sum report (last stage -> driver). codec "
            "(utils/codecs.py) names the body encoding — 0 = dense f32 (mandatory for "
            "token/target/loss kinds: exact contract), 1 = int8 per-block absmax for "
            "activations (bounded contract, |x - x̂| <= scale/2); the receiver DECODES "
            "before its size/finite gates. Receivers dedup by (step, mb) so chaos dups, "
            "reliability redelivery and watermark replay can never double-apply a "
            "microbatch"),
    MessageCode.ActivationGrad: PayloadSchema(
        fields=("step_lo", "step_hi", "mb", "ver_lo", "ver_hi", "codec"),
        rest="payload", rest_min=1, handled_by=("ps",), dedup_key="step_mb",
        doc="MPMD backward hand-off: stage s+1 -> s activation cotangent for (step, "
            "microbatch); same (step, mb) dedup discipline and codec-plane discipline (0 = "
            "dense, 1 = int8 bounded) as ActivationShip (no microbatch's gradient applied "
            "twice)"),
    MessageCode.StageReady: PayloadSchema(
        fields=("stage", "inc_lo", "inc_hi", "wm_lo", "wm_hi"),
        handled_by=("coord",), dedup_key="incarnation",
        doc="stage member -> coordinator: I serve pipeline stage `stage` at microbatch "
            "watermark wm (= step * n_microbatches, the global count my checkpoint has "
            "applied). A restarted member announces its recovery point here; the coordinator "
            "assigns it into the StagePlacement and broadcasts StageAssign"),
    MessageCode.StageAssign: PayloadSchema(
        fields=("ver_lo", "ver_hi", "n_stages", "n_params_lo", "n_params_hi"),
        rest="entries", handled_by=("coord",), dedup_key="version", fenced=True,
        doc="coordinator -> everyone: the versioned StagePlacement (coord/stages.py; 10 "
            "floats per entry: stage, rank, inc halves, lo/hi halves, watermark halves). "
            "Neighbors react to an entry whose member INCARNATION changed by re-shipping "
            "retained (step, mb) traffic at or past that entry's watermark — the "
            "bounded-replay restart contract"),
    MessageCode.CompressedUpdate: PayloadSchema(
        fields=("codec", "n_lo", "n_hi", "crc_lo", "crc_hi", "param", "ver_lo", "ver_hi",
                "lo_lo", "lo_hi", "hi_lo", "hi_hi"),
        rest="body", rest_min=1, handled_by=("ps", "coord"), dedup_key="env_seq",
        durability="wal_before_ack",
        doc="compressed GradientUpdate/ShardPush (utils/compress.py): codec names the "
            "encoding (1 = int8 per-block quant, 2 = top-k), n the decoded length, param "
            "the codec parameter (block size / k), crc a crc32 of the body bytes (the "
            "decoder's own integrity gate; chaos SDC must re-stamp it, "
            "compress.restamp_crc). The ver/lo/hi halves mirror ShardPush's elastic stamp "
            "— all-zero means unstamped (single-server wire); elastic servers gate on the "
            "RANGE before paying for a decode. The server DECODES before the admission "
            "gate (z-scores on the decoded norm — compression cannot slip the gate), "
            "WAL-logs the decoded delta plus this codec id, then applies — replay never "
            "re-decodes"),
    MessageCode.DeltaParams: PayloadSchema(
        fields=("codec", "epoch", "base_lo", "base_hi", "ver_lo", "ver_hi", "lo_lo", "lo_hi",
                "hi_lo", "hi_hi", "n_lo", "n_hi", "crc_lo", "crc_hi"),
        rest="body", rest_min=1, handled_by=("ps",), dedup_key="version",
        doc="server -> worker delta pull reply (utils/codecs.py DeltaParams plane, "
            "error-feedback contract): the body decodes to central[lo:hi) MINUS the "
            "worker's held base at (epoch, base version) — the server tracks each "
            "worker's exact materialized view, so base + decoded == central - residual "
            "holds exactly by construction. codec 0 = dense FULL install (the fallback "
            "rung: version miss, epoch change, restore, rebalance), 2 = top-k delta (the "
            "steady-state rung: the inter-pull delta is naturally sparse). A worker "
            "applies a delta only when (epoch, base) equals its held stamp, else it drops "
            "the reply and re-pulls full; crc guards the body like CompressedUpdate"),
    MessageCode.KvMigrate: PayloadSchema(
        fields=("codec", "id_lo", "id_hi", "n_tok_lo", "n_tok_hi", "n_kv_lo", "n_kv_hi",
                "crc_lo", "crc_hi"),
        rest="handoff", rest_min=1, handled_by=("serving",), dedup_key="request_id",
        doc="serving migration handoff (utils/codecs.py KvMigrate plane): the retiring "
            "engine's stream state for request id — n_tok token-history ids packed EXACT "
            "via tok16 (two ids per word; the resumed stream re-prefills from these, so "
            "token identity never depends on the lossy rung), then the slot's KV lane "
            "(n_kv elements) under `codec` (0 = dense f32, 1 = int8 per-block absmax, the "
            "serving cache's kv_quant recipe; bounded contract, verified at the "
            "receiver). crc covers the whole handoff body"),
}


#: the codes sent without the reliability envelope: periodic and
#: self-healing, never retried (``delivery="best_effort"``)
BEST_EFFORT_CODES = tuple(c for c, s in WIRE_SCHEMAS.items() if s.delivery == "best_effort")
#: the codes whose ack a durable receiver holds until they are logged
#: (``durability="wal_before_ack"``)
LOGGED_BEFORE_ACK = frozenset(c for c, s in WIRE_SCHEMAS.items()
                              if s.durability == "wal_before_ack")

Message = Tuple[int, MessageCode, np.ndarray]


class Transport:
    """Point-to-point tagged-tensor channel for one rank."""

    rank: int = 0

    def send(self, code: MessageCode, payload: np.ndarray, dst: int = SERVER_RANK) -> None:
        raise NotImplementedError

    def sendv(self, code: MessageCode, parts, dst: int = SERVER_RANK) -> None:
        """Scatter/gather send: one wire frame from several float32 parts.
        This base version joins them (one copy); :class:`TCPTransport`
        writes the parts one after another instead."""
        self.send(code, np.concatenate(
            [np.asarray(p, np.float32).ravel() for p in parts]), dst=dst)

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        """Blocking receive; returns ``None`` on timeout or closed transport."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class InProcessTransport(Transport):
    """Queue-based transport: a whole world inside one process.

    ``mailboxes`` maps each rank to its ``queue.Queue`` of
    ``(sender, code, payload)``; a world made by either package can be
    shared, since both use that tuple and the same integer codes."""

    def __init__(self, rank: int, mailboxes: Dict[int, "queue.Queue[Message]"]):
        self.rank = rank
        self._boxes = mailboxes
        self._closed = False

    @classmethod
    def create_world(cls, world_size: int) -> Dict[int, "InProcessTransport"]:
        boxes: Dict[int, queue.Queue] = {r: queue.Queue() for r in range(world_size)}
        return {r: cls(r, boxes) for r in range(world_size)}

    def send(self, code: MessageCode, payload: np.ndarray, dst: int = SERVER_RANK) -> None:
        # copy: the receiver must never alias the sender's live buffer (the
        # server's central vector is updated in place)
        arr = np.array(payload, dtype=np.float32, copy=True).ravel()
        self._boxes[dst].put((self.rank, MessageCode(code), arr))

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        if self._closed:
            return None
        try:
            return self._boxes[self.rank].get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._closed = True


def _code_name(code: int) -> str:
    try:
        return MessageCode(code).name
    except ValueError:
        return str(code)


def _send_frame(sock: socket.socket, sender: int, code: int, payload: np.ndarray) -> None:
    buf = np.ascontiguousarray(payload, dtype=np.float32).tobytes()
    sock.sendall(_HEADER.pack(sender, code, len(buf)) + buf)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        try:
            b = sock.recv(min(n, 1 << 20))
        except (OSError, ValueError):
            return None
        if not b:
            return None
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


#: a malformed frame was consumed but the stream is still framed
_MALFORMED = object()


def _recv_frame(sock: socket.socket):
    """One wire frame: a ``Message``, ``None`` (closed or unframeable), or
    :data:`_MALFORMED` (a bad frame was skipped; keep reading)."""
    hdr = _recv_exact(sock, _HEADER.size)
    if hdr is None:
        return None
    sender, code, nbytes = _HEADER.unpack(hdr)
    if nbytes < 0 or nbytes > MAX_FRAME_BYTES:
        _LOGGER.warning("dropping connection: unframeable payload length %d "
                        "(sender=%d code=%d)", nbytes, sender, code)
        return None
    body = _recv_exact(sock, nbytes)
    if body is None:
        return None
    try:
        mcode = MessageCode(code)
    except ValueError:
        _LOGGER.warning("dropping frame with unknown MessageCode %d from %d", code, sender)
        return _MALFORMED
    if nbytes % 4:
        _LOGGER.warning("dropping frame: %d-byte payload is not float32-aligned", nbytes)
        return _MALFORMED
    return sender, mcode, np.frombuffer(body, dtype=np.float32).copy()


class TCPTransport(Transport):
    """Star-topology socket transport.

    Rank 0 (the server) binds ``master:port`` and admits ``world_size - 1``
    worker connections (``wait_for`` overrides the count), each identified
    by its hello frame; then a thread goes on accepting, so a restarted
    worker of the same rank replaces its dead socket (the old one is shut
    down, and closed at :meth:`close`). A connection whose hello does not
    arrive within ``handshake_timeout`` seconds is dropped, so a stalled
    dial cannot wedge the rendezvous or the accept loop. A worker dials
    until ``connect_timeout`` on a seeded :class:`Backoff` (rank and port),
    so workers started together spread their dials. Reader threads pump
    incoming frames into a local queue, so :meth:`recv` has the in-process
    transport's blocking-queue semantics.
    """

    def __init__(self, rank: int, world_size: int, master: str = "localhost",
                 port: int = 29500, connect_timeout: float = 60.0,
                 wait_for: Optional[int] = None, handshake_timeout: float = 5.0):
        self.rank = rank
        self.world_size = world_size
        self.handshake_timeout = float(handshake_timeout)
        self._inbox: "queue.Queue[Message]" = queue.Queue()
        self._peers: Dict[int, socket.socket] = {}
        # one lock per peer: the training loop, the push flusher, the
        # heartbeat and retry threads may send concurrently, and frames must
        # not interleave
        self._send_locks: Dict[int, threading.Lock] = {}
        # guards the peer table (_peers, _send_locks, _retired), which the
        # accept thread rewires on a rejoin while other threads send. Lock
        # order: a peer's send lock, then _peers_mu
        self._peers_mu = threading.Lock()
        #: a rendezvous in progress: (workers expected, deadline, timeout)
        self._expect: Optional[Tuple[int, float, float]] = None
        self._retired: list = []
        self._threads = []
        self._closed = False
        self._server_sock = None
        if rank == SERVER_RANK:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((master if master != "localhost" else "", int(port)))
            srv.listen(world_size)
            srv.settimeout(connect_timeout)
            self._server_sock = srv
            need = world_size - 1 if wait_for is None else int(wait_for)
            while len(self._peers) < need:
                conn, _addr = srv.accept()
                try:
                    self._admit_worker(conn)
                except ConnectionError:
                    conn.close()  # a garbage connection: drop it, keep waiting
            t = threading.Thread(target=self._accept_loop, name="tcp-accept", daemon=True)
            t.start()
            self._threads.append(t)
        else:
            deadline = time.monotonic() + connect_timeout
            policy = Backoff(0.05, 1.0, jitter=0.25, seed=(rank << 16) ^ int(port))
            sock, err = None, None
            for _attempt in policy.attempts(deadline):
                try:
                    sock = socket.create_connection(
                        (master, int(port)), timeout=min(self.handshake_timeout,
                                                         connect_timeout))
                    break
                except OSError as e:
                    err = e
            if sock is None:
                raise err if err is not None else OSError(
                    f"connect to {master}:{port} timed out")
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send_frame(sock, rank, int(MessageCode.ParameterRequest),
                        np.zeros(0, np.float32))
            self._peers[SERVER_RANK] = sock
            self._spawn_reader(sock)

    def _admit_worker(self, conn: socket.socket) -> None:
        """Handshake one inbound connection and start its reader; raises
        ``ConnectionError`` on a missing, malformed or out-of-range hello.
        A rank that already has a socket is a rejoin: the stale socket is
        swapped out under that peer's send lock (an in-flight send to it
        finishes first) and shut down, so its reader exits; it is closed
        only at :meth:`close`, so no reader ever sees its number reused."""
        conn.settimeout(self.handshake_timeout)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hello = _recv_frame(conn)
        if hello is None or hello is _MALFORMED:
            raise ConnectionError("worker handshake failed")
        conn.settimeout(None)
        peer_rank = hello[0]
        if not (1 <= peer_rank < self.world_size):
            raise ConnectionError(f"invalid worker rank in hello: {peer_rank}")
        with self._send_lock_for(peer_rank):
            with self._peers_mu:
                old = self._peers.get(peer_rank)
                self._peers[peer_rank] = conn
                if old is not None:
                    self._retired.append(old)
            if old is not None:
                try:
                    old.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        self._spawn_reader(conn)

    def expect_peers(self, n: int, timeout: float) -> None:
        """Start a rendezvous of ``n`` workers (a server built with
        ``wait_for=0`` admits them on its accept thread) that must end
        within ``timeout`` seconds; :meth:`rendezvous_done` polls it."""
        self._expect = (int(n), time.monotonic() + timeout, float(timeout))

    def rendezvous_done(self) -> bool:
        """Whether the expected workers have all connected (True with no
        rendezvous pending); raises ``TimeoutError`` past its deadline."""
        expect = self._expect
        if expect is None:
            return True
        n, deadline, timeout = expect
        with self._peers_mu:
            if len(self._peers) >= n:
                self._expect = None
                return True
        if time.monotonic() >= deadline:
            raise TimeoutError(f"{n} workers did not connect within {timeout:.0f} s")
        return False

    def _send_lock_for(self, dst: int) -> threading.Lock:
        """The peer's send lock, made on first use (holds only _peers_mu)."""
        with self._peers_mu:
            lock = self._send_locks.get(dst)
            if lock is None:
                lock = self._send_locks[dst] = threading.Lock()
            return lock

    def _accept_loop(self) -> None:
        # poll: a close() in another thread does not reliably wake a
        # blocked accept
        try:
            self._server_sock.settimeout(0.25)
        except OSError:
            return  # closed before the loop began
        while not self._closed:
            try:
                conn, _addr = self._server_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # the listener was closed
            try:
                self._admit_worker(conn)
            except ConnectionError:
                conn.close()

    def _spawn_reader(self, sock: socket.socket) -> None:
        def pump():
            while not self._closed:
                msg = _recv_frame(sock)
                if msg is None:
                    break
                if msg is not _MALFORMED:
                    self._inbox.put(msg)

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        self._threads.append(t)

    def send(self, code: MessageCode, payload: np.ndarray, dst: int = SERVER_RANK) -> None:
        self.sendv(code, (payload,), dst=dst)

    def sendv(self, code: MessageCode, parts, dst: int = SERVER_RANK) -> None:
        """The header and each part written in turn under the peer's send
        lock: one wire frame, byte for byte the joined parts', without a
        payload-sized copy. A frame of at most 64 KiB leaves in one
        ``sendall``. An unknown ``dst`` raises ``KeyError``."""
        arrs = [np.ascontiguousarray(np.asarray(p, np.float32).ravel()) for p in parts]
        nbytes = sum(a.nbytes for a in arrs)
        with self._send_lock_for(dst):
            with self._peers_mu:
                sock = self._peers[dst]
            if nbytes <= _SMALL_FRAME_BYTES:
                sock.sendall(b"".join([_HEADER.pack(self.rank, int(code), nbytes)]
                                      + [a.tobytes() for a in arrs]))
                return
            sock.sendall(_HEADER.pack(self.rank, int(code), nbytes))
            for a in arrs:
                sock.sendall(memoryview(a).cast("B"))

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        # short slices, so a blocked recv() returns None once closed
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._closed:
                return None
            slice_t = 0.1 if deadline is None else max(0.0, min(0.1, deadline - time.monotonic()))
            try:
                return self._inbox.get(timeout=slice_t)
            except queue.Empty:
                if deadline is not None and time.monotonic() >= deadline:
                    return None

    def close(self) -> None:
        self._closed = True
        with self._peers_mu:
            targets = list(self._peers.values()) + list(self._retired)
        for s in targets:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        if self._server_sock is not None:
            self._server_sock.close()


def _split16(value: int) -> Tuple[float, float]:
    """A uint32 as two float32-exact uint16 halves (the float32 wire carries
    integers exactly only below 2^24)."""
    return float(value & 0xFFFF), float((value >> 16) & 0xFFFF)


def _join16(lo: float, hi: float) -> int:
    return (int(lo) & 0xFFFF) | ((int(hi) & 0xFFFF) << 16)


#: the coordinator's epoch fence trailer, ``[FENCE_SEPARATOR, FENCE_MAGIC,
#: epoch_lo, epoch_hi]``, appended after the payload of every frame a
#: coordinator sends (the JAX package's constants): a trailer leaves every
#: decoder's layout as it is, and the magic guards the match, since payload
#: floats are arbitrary and FleetState tails already use -1 sections. A
#: frame without it is an unfenced coordinator's and is taken as it is.
FENCE_SEPARATOR = -2.0
FENCE_MAGIC = 91217.0


def stamp_epoch(payload: np.ndarray, epoch: int) -> np.ndarray:
    """Append the coordinator epoch fence trailer to one outbound frame."""
    return np.concatenate([
        np.asarray(payload, np.float32),
        np.asarray([FENCE_SEPARATOR, FENCE_MAGIC, *_split16(int(epoch))], np.float32)])


def strip_epoch(payload: np.ndarray):
    """``(body, epoch)`` of a frame; ``epoch`` is ``None`` for an unstamped
    frame. The inverse of :func:`stamp_epoch`."""
    if (payload.size >= 4 and float(payload[-4]) == FENCE_SEPARATOR
            and float(payload[-3]) == FENCE_MAGIC):
        return payload[:-4], _join16(payload[-2], payload[-1])
    return payload, None


#: bodies of at least this many bytes switch from a full crc32 to the bulk
#: digest (a uint64 word sum and the length, crc-mixed with the header); the
#: choice depends only on the body's length, so both ends agree
_BULK_SUM_BYTES = 1 << 16


def _frame_crc(inc: int, seq: int, code: int, body, corr: int = 0) -> int:
    """Checksum over the whole envelope: incarnation, seq, code,
    correlation id and body, so a flipped header field fails the check too
    (a corrupted incarnation adopted as a newer life would blackhole every
    later frame as stale).

    ``body`` is any buffer (bytes, memoryview or a contiguous float32
    array) and is never copied: a 9.9 MB push is read in place. Small
    bodies get a full crc32; bodies of :data:`_BULK_SUM_BYTES` or more a
    uint64 little-endian word sum and the exact length, crc-mixed with the
    header, at memory bandwidth. The sum catches every corruption that
    changes one 32-bit word and every change of length, but unlike a CRC
    compensating errors in several words can fool it; TCP's own checksum
    screens the wire beneath."""
    head = struct.pack("<IIII", inc & 0xFFFFFFFF, seq & 0xFFFFFFFF,
                       code & 0xFFFFFFFF, corr & 0xFFFFFFFF)
    h = zlib.crc32(head)
    if isinstance(body, np.ndarray):
        mv = memoryview(np.ascontiguousarray(body)).cast("B")
    elif isinstance(body, memoryview):
        mv = body.cast("B")
    else:
        mv = memoryview(body)
    nbytes = mv.nbytes
    if nbytes >= _BULK_SUM_BYTES:
        n8 = nbytes // 8 * 8
        words = np.frombuffer(mv[:n8], np.uint64)
        digest = struct.pack("<QI", int(words.sum(dtype=np.uint64)), nbytes)
        h = zlib.crc32(digest, h)
        if n8 != nbytes:
            h = zlib.crc32(mv[n8:], h)
        return h & 0xFFFFFFFF
    return zlib.crc32(mv, h) & 0xFFFFFFFF


def _frame_crc_legacy(inc: int, seq: int, code: int, body, corr: int = 0) -> int:
    """The older envelope checksum (the JAX package's ``_frame_crc_legacy``):
    a crc32 of the header's incarnation, seq and code, then of the whole
    body through a ``tobytes()`` copy. Only ``ReliableTransport(
    legacy_envelope=True)`` uses it, as the reliability bench's before; the
    correlation id is accepted and not covered, as it was not then."""
    head = struct.pack("<III", inc & 0xFFFFFFFF, seq & 0xFFFFFFFF, code & 0xFFFFFFFF)
    if isinstance(body, np.ndarray):
        body = body.tobytes()
    return zlib.crc32(body, zlib.crc32(head)) & 0xFFFFFFFF


#: frames a reliable receiver's retry tick takes in (and acks) ahead of an
#: application that is not calling recv(): a worker's install, pull and
#: push sent before the server's loop has started, from two workers. Past
#: it the tick still reads on, for the acks of its own frames, and holds
#: the data frames behind them unread and unacked
PARK_MAX = 8

#: the share of the timeout floor that the frames queued at a lagging
#: receiver may take its application to serve: while its application lags
#: (a frame was still waiting when it took one, within the last
#: ``ack_timeout``, or frames wait while it holds one), the credit it
#: advertises is at most this share of ``ack_timeout`` over the
#: application's time a frame, split among its senders. A quarter: a frame
#: also waits for its own serving and its log's fsync, and the senders'
#: queued frames together take up to this share, so half the floor and more
#: stays between the longest ack and its timeout
LAG_CREDIT_SHARE = 0.25

#: the codes of the reliable layer's acks, taken in whatever the park holds
_ACK_CODES = (MessageCode.ReliableAck, MessageCode.CumAck)

_INC_LOCK = threading.Lock()
_LAST_INC = 0


def _next_incarnation() -> int:
    """A stamp for one life of a server (its WAL records): epoch seconds in
    32 bits (they wrap in 2106; milliseconds would wrap every 50 days and
    make a restart after the wrap read as an older life), strictly
    increasing within the process, so two lives begun in the same second
    still differ."""
    global _LAST_INC
    with _INC_LOCK:
        _LAST_INC = max(_LAST_INC + 1, int(time.time()) & 0xFFFFFFFF)
        return _LAST_INC


#: the last incarnation stamped on each endpoint a reliable sender wraps
_STAMPED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _wire_incarnation(endpoint) -> int:
    """The incarnation a reliable sender stamps on its frames: the
    wall-clock second it starts in, never a later one, so a receiver of
    either package orders it against a life of the other package begun in
    another second (a JAX life stamps its start second). A new wrapper of
    an endpoint this process stamped in this second (a restart within the
    process) waits for the next second, so it is strictly newer for every
    receiver. Lives in two processes may still share a second: the port's
    receiver tells them apart by their first frames' nonces
    (:class:`ReliableTransport`), the JAX receiver cannot."""
    while True:
        with _INC_LOCK:
            now = time.time()
            stamp = int(now) & 0xFFFFFFFF
            if stamp > _STAMPED.get(endpoint, -1):
                _STAMPED[endpoint] = stamp
                return stamp
        time.sleep(max(0.001, 1.0 - (now - int(now))))


class _Pending:
    __slots__ = ("parts", "dst", "deadline", "attempt", "code",
                 "first_sent", "retransmitted", "corr", "clock", "seq", "leaving")

    def __init__(self, parts, dst: int, deadline: float, code: int = -1,
                 corr: int = 0):
        # (header, body), re-sent by sendv: the body is the caller's buffer,
        # held until the frame is acked
        self.parts = parts
        self.dst = dst
        self.deadline = deadline
        self.attempt = 1
        self.code = code  # the inner MessageCode (per-code ack accounting)
        self.corr = corr
        self.first_sent = 0.0
        #: Karn's rule: an RTT sample only from a frame never retransmitted
        #: (an ack of a retransmitted frame does not say which copy it
        #: answers)
        self.retransmitted = False
        #: when the frame's retransmit clock last started: its send, or the
        #: ack of an older frame toward the same peer
        self.clock = 0.0
        self.seq = -1
        #: its first copy is still being handed to the inner transport
        self.leaving = False


class _PeerState:
    """Per-peer sender state: the RTT estimator, the window's accounting
    and the circuit breaker."""

    __slots__ = ("srtt", "rttvar", "rto", "inflight", "credit",
                 "consec_timeouts", "breaker", "dead", "probe_key",
                 "probe_at", "opens", "last_ack")

    def __init__(self, rto: float):
        self.srtt: Optional[float] = None
        self.rttvar = 0.0
        self.rto = rto
        self.last_ack = 0.0        # monotonic stamp of the last ack heard
        self.inflight = 0          # pending (unacked) frames toward the peer
        self.credit: Optional[int] = None  # receiver-advertised window
        self.consec_timeouts = 0   # RTO blowups since the last ack
        self.breaker = "closed"    # "closed" | "open" (probe_key => half-open)
        self.dead = False          # terminal give-up (revived only by contact)
        self.probe_key = None      # pending key currently serving as probe
        self.probe_at = 0.0        # when the open breaker may half-open
        self.opens = 0             # consecutive opens (cooldown exponent)


class _RxState:
    """Per-sender receiver state for cumulative acks."""

    __slots__ = ("inc", "cum_hw", "eligible", "dirty", "last_flush", "advertised")

    def __init__(self, inc: int):
        self.inc = inc
        #: highest seq such that EVERY seq <= cum_hw has been delivered and
        #: is ack-eligible (durably applied, for deferred-ack receivers)
        self.cum_hw = -1
        #: ack-eligible seqs above a gap, waiting for it to fill
        self.eligible: set = set()
        self.dirty = 0             # eligible deliveries since the last flush
        self.last_flush = 0.0
        self.advertised: Optional[int] = None  # the credit the last CumAck carried


class ReliableTransport(Transport):
    """Reliable delivery over any :class:`Transport` (the JAX package's
    layer, envelope for envelope).

    **Sender.** Every frame is wrapped in a ``ReliableFrame`` envelope
    ``[inc, seq, crc, code, corr]`` (32-bit values as uint16 halves) with
    the payload behind it, sent as two parts through the inner ``sendv``
    and kept until acked; a thread retransmits on the peer's timeout until
    an ack arrives or ``max_retries`` run out, when the peer is declared
    dead and later sends raise ``ConnectionError`` (the worker's
    degrade-to-local path). Codes in :attr:`unreliable_codes` (by default
    :data:`BEST_EFFORT_CODES`, the heartbeats: periodic and self-healing)
    skip the envelope.

    **Receiver.** A frame that fails its checksum is dropped unacked (the
    retry delivers a clean copy); a duplicate is re-acked but not
    delivered again, so a ``GradientUpdate`` is applied exactly once under
    duplicates and retries. Plain frames from an unwrapped peer pass
    through. Each sender instance stamps an *incarnation* (its start
    second): a newer one resets that rank's dedup state (a restarted
    process's fresh sequence space), an older one is acked and dropped; any
    frame from a rank declared dead revives it for sending. Two lives begun
    in the same second share an incarnation, so each life's first frame to
    a peer (seq 0) carries a random per-life *nonce* in place of an absent
    correlation id: a seq-0 frame whose checksum differs from every seq 0
    of that incarnation starts a new life.

    **Per peer:**

    - *timeout*: Jacobson/Karels SRTT/RTTVAR from ack round trips (Karn's
      rule: never from a retransmitted frame), clamped to ``[ack_timeout,
      max_backoff]``; a timeout doubles it; retransmits back off
      exponentially with seeded jitter. A frame's clock starts once its
      last byte has been handed to the inner transport, and an ack of the
      oldest frame pending toward a peer restarts the clocks of the others
      (RFC 6298 §5.3): a receiver that works through a queue of frames is
      slow, not lossy, and a timeout measures how long the peer made no
      progress, not how long a frame queued behind others;
    - *window*: at most ``min(send_window, advertised credit)`` unacked
      frames; :meth:`send` blocks there (and pumps the inner transport, so
      acks clear on a rank with no receiving thread), counting
      ``window_blocked`` and ``window_blocked_s`` when ``send_window``
      frames are unacked (the JAX layer's meaning, the gray plane's witness
      of a link whose acks do not come back), and ``credit_blocked`` and
      ``credit_blocked_s`` when the receiver's advertised credit held the
      window below it (a live receiver slowing its senders down);
    - *cumulative acks*: in-order deliveries are acked by one ``CumAck(inc,
      cum, credit)`` per ``ack_batch_n`` frames or retry tick; frames above
      a gap get an individual ``ReliableAck`` at once;
    - *deferred acks* (``ack_on_delivery=False``): the ack of a delivered
      frame whose code must be logged before it is acked (``durability=
      "wal_before_ack"`` in :data:`WIRE_SCHEMAS`: the push) waits for
      :meth:`ack_delivered` (the server calls it after the WAL's fsync), and
      a duplicate of it is not re-acked early; other codes are acked on
      delivery, since no log holds them;
    - *circuit breaker*: ``breaker_fails`` timed-out ticks with the peer
      ack-silent for ``breaker_grace`` open it: sends fail fast, retransmits
      pause, and after a growing cooldown one pending frame probes
      (half-open); an ack closes it.

    **Acks do not wait for the application.** Each retry tick also takes
    in every frame already waiting in the inner transport: acks clear
    pending frames, and data frames are checked, deduplicated, made due for
    their ack and parked, with their envelope, for :meth:`recv` to hand out
    in arrival order. Parked frames count against the credit this receiver
    advertises, so a slow application still narrows its senders' windows.
    While the application lags (a frame was still waiting when it took one,
    within the last timeout floor, or frames wait while it holds one), the
    credit is also at most what the application serves within
    :data:`LAG_CREDIT_SHARE` of that floor, at its time a frame (a running
    estimate from a hand-out to the next :meth:`recv`, which a slower frame
    raises at once, or the time it has held its current frame when that is
    longer), split among its senders, less the frames a sender has parked (acked
    ones too: a push waits behind every frame ahead of it): a frame whose
    ack waits for the application (a durable push, which also waits for the
    log's group) is not queued behind more than that. A cut by that bound is sent
    at once (a ``CumAck`` repeating the frontier), and :meth:`acks_overdue`
    tells a durable receiver when a withheld ack has waited that share of
    the floor since its frame was read.
    Past :data:`PARK_MAX` parked frames the tick still takes in acks, and
    holds the data frames read beside them unprocessed and unacked (the
    backlog, handed out after the park, in order).

    ``recorder`` (a ``utils/obs.SpanRecorder``, attached after
    construction) takes the wire plane's side of a timeline: the spans a
    send was blocked at the window, retransmit and breaker events, the
    release of withheld acks and one ``wire-stats`` event at teardown. It
    is never consulted for a protocol decision, so a frame, its checksum
    and a chaos log are the same with it or without it.
    """

    def __init__(self, inner: Transport, *, ack_timeout: float = 1.0,
                 max_backoff: float = 2.0, max_retries: int = 10,
                 dedup_window: int = 4096,
                 unreliable_codes: Tuple[MessageCode, ...] = BEST_EFFORT_CODES,
                 ack_on_delivery: bool = True, send_window: int = 32,
                 recv_window: int = 64, ack_batch_n: int = 8,
                 batched_acks: bool = True, breaker_fails: int = 6,
                 breaker_cooldown: float = 0.5,
                 breaker_grace: Optional[float] = None, jitter: float = 0.25,
                 legacy_envelope: bool = False):
        self.inner = inner
        self.rank = inner.rank
        self.ack_timeout = float(ack_timeout)   # timeout floor and initial value
        self.max_backoff = float(max_backoff)   # timeout and backoff cap
        self.max_retries = int(max_retries)
        self.dedup_window = int(dedup_window)
        self.send_window = int(send_window)
        self.recv_window = int(recv_window)
        self.ack_batch_n = int(ack_batch_n)
        self.batched_acks = bool(batched_acks)
        self.breaker_fails = int(breaker_fails)
        self.breaker_cooldown = float(breaker_cooldown)
        #: the breaker opens only when the peer has also been ack-silent
        #: this long: a lossy but live link keeps flowing
        self.breaker_grace = (float(breaker_grace) if breaker_grace is not None
                              else self.max_backoff)
        self.jitter = float(jitter)
        #: the older envelope, for the reliability bench's before: the frame
        #: concatenated into one copy and checked by :func:`_frame_crc_legacy`
        #: (both ends of a link must agree)
        self.legacy_envelope = bool(legacy_envelope)
        self.unreliable_codes = frozenset(int(c) for c in unreliable_codes) | {
            int(MessageCode.ReliableFrame), int(MessageCode.ReliableAck),
            int(MessageCode.CumAck)}
        self._lock = threading.Lock()
        #: seeded per rank: retransmits desynchronize across peers and
        #: replay per rank
        self._jrng = random.Random((self.rank << 8) ^ 0x5EED)
        self.incarnation = _wire_incarnation(inner)
        #: this life's first frame to each peer carries it (never 0)
        self.nonce = int.from_bytes(os.urandom(4), "little") or 1
        self._next_seq: Dict[int, int] = {}
        self._pending: Dict[Tuple[int, int], _Pending] = {}
        self._peers: Dict[int, _PeerState] = {}
        #: deliverable frames taken in by the retry tick or by a blocked
        #: send() or flush(), each ``(corr, envelope, message)``, handed out
        #: by recv() before anything newer
        self._requeue: "collections.deque" = collections.deque()
        #: inner frames read past a full park, not yet processed (so not
        #: acked), each ``(read at, message)``, in arrival order; processed
        #: before anything newer
        self._backlog: "collections.deque" = collections.deque()
        #: held by whichever thread reads the inner transport, so frames are
        #: parked and handed out in the order they arrived
        self._rx_lock = threading.Lock()
        self._seen: Dict[int, "collections.OrderedDict"] = {}
        #: per sender, the checksums of the seq-0 frames delivered in its
        #: current incarnation: one per life begun in that second
        self._firsts: Dict[int, set] = {}
        self._peer_inc: Dict[int, int] = {}
        self._rx: Dict[int, _RxState] = {}
        self._credit_override: Optional[int] = None
        #: the application's time a frame of each code (seconds, running
        #: estimates that a slower frame raises at once): from a hand-out to
        #: its next call of recv()
        self._service_s: Dict[int, float] = {}
        #: when the frame the application holds was handed out, and its code
        self._last_handout: Optional[Tuple[float, int]] = None
        #: the application lags until then (monotonic seconds)
        self._lag_until = 0.0
        self._dead_peers: set = set()
        self.ack_on_delivery = bool(ack_on_delivery)
        self._deferred_acks: "collections.OrderedDict" = collections.OrderedDict()
        #: when each withheld frame was taken in (monotonic seconds)
        self._taken_in: Dict[Tuple[int, int, int], float] = {}
        self._last_delivery: Optional[Tuple[int, int]] = None
        self._acked_codes: Dict[Tuple[int, int], int] = {}
        self._closed = False
        self.stats = {
            "sent": 0, "retries": 0, "acked": 0, "gave_up": 0,
            "crc_dropped": 0, "dup_dropped": 0, "delivered": 0,
            "passthrough": 0,
            "cum_acked": 0, "acks_tx": 0, "cum_acks_tx": 0,
            "rto_expired": 0, "window_blocked": 0, "credit_blocked": 0, "breaker_opens": 0,
            "probes": 0,
            # seconds that sends spent blocked at the window
            "window_blocked_s": 0.0,
            # seconds that sends spent blocked at a receiver's credit
            "credit_blocked_s": 0.0,
        }
        #: the longest a frame's clock ran before its ack (seconds, frames
        #: never retransmitted): a timeout fires when it passes the peer's
        #: timeout, which is never below ``ack_timeout``
        self.max_ack_wait = 0.0
        #: the least time a frame had left before its timeout when its ack
        #: came (seconds, frames never retransmitted; ``None`` before the
        #: first): the margin by which no timeout fired
        self.min_ack_slack: Optional[float] = None
        #: each timeout, oldest first (at most 64): the frame's peer, seq,
        #: code and attempt, and how long its clock had run
        self.expired: list = []
        #: the optional flight recorder (see the class docstring)
        self.recorder = None
        self._retry_wake = threading.Event()
        self._retry_thread = threading.Thread(target=self._retry_loop, name="reliable-retry",
                                              daemon=True)
        self._retry_thread.start()

    # ---------------------------------------------------------- peer state

    def _peer(self, dst: int) -> _PeerState:
        """Caller holds ``_lock``."""
        st = self._peers.get(dst)
        if st is None:
            st = self._peers[dst] = _PeerState(self.ack_timeout)
            # the grace starts at the peer's first use: a link whose first
            # ack is merely slow gets the whole grace
            st.last_ack = time.monotonic()
        return st

    def _rtt_sample(self, st: _PeerState, sample: float) -> None:
        """Jacobson/Karels; caller holds ``_lock``."""
        if sample <= 0:
            return
        if st.srtt is None:
            st.srtt = sample
            st.rttvar = sample / 2.0
        else:
            st.rttvar = 0.75 * st.rttvar + 0.25 * abs(st.srtt - sample)
            st.srtt = 0.875 * st.srtt + 0.125 * sample
        st.rto = min(max(st.srtt + max(4.0 * st.rttvar, 0.01), self.ack_timeout),
                     self.max_backoff)

    def _on_peer_ack(self, st: _PeerState) -> None:
        """An ack arrived: the path to this peer works. Caller holds
        ``_lock``."""
        st.consec_timeouts = 0
        st.last_ack = time.monotonic()
        if st.breaker != "closed":
            st.breaker = "closed"
            st.probe_key = None
            st.opens = 0

    def _revive(self, sender: int) -> None:
        """Any frame from a rank declared dead is evidence of life (the
        rejoin path). A merely open breaker stays open: on a one-way link
        the peer's data keeps arriving while our frames go unacked, and only
        an ack may close it. Caller holds ``_lock``."""
        if sender in self._dead_peers:
            self._dead_peers.discard(sender)
            st = self._peer(sender)
            st.dead = False
            st.breaker = "closed"
            st.probe_key = None
            st.consec_timeouts = 0

    def _backoff_delay(self, st: _PeerState, attempt: int) -> float:
        """Jittered capped exponential backoff off the peer's current
        timeout (:class:`Backoff`'s shape, with a moving base)."""
        raw = st.rto * (2.0 ** max(0, attempt - 1))
        jit = 1.0 + self.jitter * (2.0 * self._jrng.random() - 1.0)
        return min(raw * jit, self.max_backoff)

    # ---------------------------------------------------------------- send

    def send(self, code: MessageCode, payload: np.ndarray, dst: int = SERVER_RANK) -> None:
        if int(code) in self.unreliable_codes:
            self.inner.send(code, payload, dst=dst)
            return
        arr = np.ascontiguousarray(np.asarray(payload, dtype=np.float32).ravel())
        corr = _obs.current_corr()
        blocked = None  # the stat a block counts in, once blocked
        block_t0 = 0
        while True:
            with self._lock:
                st = self._peer(dst)
                if st.dead or st.breaker == "open":
                    raise ConnectionError(
                        f"peer {dst} "
                        + (f"declared dead after {self.max_retries} unacked retries"
                           if st.dead else
                           "circuit breaker open (consecutive timeouts)"))
                if self._closed or st.inflight < self._window(st):
                    seq = self._next_seq.get(dst, 0)
                    if seq == 0 and corr == 0:
                        corr = self.nonce
                    self._next_seq[dst] = seq + 1
                    # reserve the window slot inside the check's critical
                    # section: two sending threads must not both pass it
                    st.inflight += 1
                    break
                if blocked is None:
                    blocked = ("credit_blocked" if st.inflight < self.send_window
                               else "window_blocked")
                    block_t0 = time.monotonic_ns()
                    self.stats[blocked] += 1
            self._pump(timeout=0.02)
        if blocked is not None:
            # a send blocked at the window is a wait state of its own: the
            # span goes to the wire plane's timeline
            now_ns = time.monotonic_ns()
            with self._lock:
                self.stats[blocked + "_s"] += (now_ns - block_t0) / 1e9
            rec = self.recorder
            if rec is not None:
                rec.record("wire-blocked", "wire-blocked", block_t0, now_ns, corr=corr,
                           meta={"dst": dst})
        try:
            checksum = _frame_crc_legacy if self.legacy_envelope else _frame_crc
            crc = checksum(self.incarnation, seq, int(code), arr, corr)
            header = np.asarray(
                [*_split16(self.incarnation), *_split16(seq), *_split16(crc),
                 float(int(code)), *_split16(corr)], np.float32)
            parts = ((np.concatenate([header, arr]),) if self.legacy_envelope
                     else (header, arr))
        except Exception:
            with self._lock:
                st = self._peer(dst)
                st.inflight = max(0, st.inflight - 1)
            raise
        now = time.monotonic()
        with self._lock:
            st = self._peer(dst)
            p = _Pending(parts, dst, now + st.rto, code=int(code), corr=corr)
            p.first_sent = p.clock = now
            p.seq, p.leaving = seq, True
            self._pending[(dst, seq)] = p
            self.stats["sent"] += 1
        left = False
        try:
            self.inner.sendv(MessageCode.ReliableFrame, parts, dst=dst)
            left = True
        except (OSError, ConnectionError, KeyError):
            pass  # the retry thread owns recovery: the frame is pending
        finally:
            # every way out of the hand-off gives the frame to the retry
            # thread; once it has left, its clock starts: the time to hand
            # 9.9 MB to a contended socket is not round-trip time
            now = time.monotonic()
            with self._lock:
                p.leaving = False
                if left and not p.retransmitted and self._pending.get((dst, seq)) is p:
                    p.first_sent = p.clock = now
                    p.deadline = now + self._peer(dst).rto

    def _window(self, st: _PeerState) -> int:
        """The effective send window, never below 1 (a zero credit must not
        deadlock the link: acks flow only when frames do)."""
        w = self.send_window
        if st.credit is not None:
            w = min(w, st.credit)
        return max(1, w)

    def _restart_clocks(self, dst: int, now: float) -> None:
        """The oldest frame pending toward ``dst`` was acked: the peer made
        progress, so the clocks of the frames queued behind it start again
        (retransmitted frames keep their backoff). Caller holds ``_lock``."""
        rto = self._peer(dst).rto
        for (d, _seq), p in self._pending.items():
            if d == dst and not p.retransmitted and p.deadline < now + rto:
                p.clock, p.deadline = now, now + rto

    def _note_ack_wait(self, p: _Pending, now: float) -> None:
        """Fold one first-try ack into ``max_ack_wait`` and
        ``min_ack_slack``. Caller holds ``_lock``."""
        self.max_ack_wait = max(self.max_ack_wait, now - p.clock)
        slack = p.deadline - now
        if self.min_ack_slack is None or slack < self.min_ack_slack:
            self.min_ack_slack = slack

    def _oldest_pending(self, dst: int) -> Optional[int]:
        """The lowest seq pending toward ``dst``. Caller holds ``_lock``."""
        return min((seq for d, seq in self._pending if d == dst), default=None)

    def _pop_pending(self, key) -> Optional[_Pending]:
        """Caller holds ``_lock``."""
        p = self._pending.pop(key, None)
        if p is not None:
            st = self._peer(p.dst)
            st.inflight = max(0, st.inflight - 1)
        return p

    def _give_up(self, key, p: _Pending) -> None:
        """Terminal give-up: the peer is dead until it speaks again. Caller
        holds ``_lock``."""
        st = self._peer(p.dst)
        self._pop_pending(key)
        self.stats["gave_up"] += 1
        st.dead = True
        st.breaker = "open"
        st.probe_key = None
        self._dead_peers.add(p.dst)
        dropped = [k for k in self._pending if k[0] == p.dst]
        for k in dropped:
            self._pop_pending(k)
        _LOGGER.warning("reliable: peer %d unacked after %d retries — declaring it dead "
                        "(%d queued frames dropped)", p.dst, self.max_retries, len(dropped))

    def _retry_tick(self) -> None:
        """One pass of retransmission: timeouts, breaker transitions and
        half-open probes."""
        now = time.monotonic()
        resend: list = []
        timed_out: set = set()
        with self._lock:
            for key, p in list(self._pending.items()):
                st = self._peer(p.dst)
                if st.dead:
                    continue
                if st.breaker == "open":
                    if st.probe_key is None:
                        if now < st.probe_at:
                            continue
                        # half-open: exactly one pending frame probes the
                        # link (the oldest: dict order is send order)
                        if p.attempt > self.max_retries:
                            self._give_up(key, p)
                            continue
                        st.probe_key = key
                        p.attempt += 1
                        p.retransmitted = True
                        p.deadline = now + self._backoff_delay(st, p.attempt)
                        self.stats["probes"] += 1
                        resend.append(p)
                    elif st.probe_key == key and p.deadline <= now:
                        # the probe went unanswered: deepen the open state
                        st.probe_key = None
                        st.opens += 1
                        st.probe_at = now + min(self.breaker_cooldown * (2.0 ** st.opens),
                                                4.0 * self.max_backoff)
                        if p.attempt > self.max_retries:
                            self._give_up(key, p)
                    continue
                if p.deadline > now or p.leaving:
                    # a first copy still being handed to the inner transport
                    # (a 9.9 MB frame behind a contended socket) has not
                    # left: its clock starts when it has
                    continue
                if p.attempt > self.max_retries:
                    self._give_up(key, p)
                    continue
                timed_out.add(p.dst)
                self.stats["rto_expired"] += 1
                if len(self.expired) < 64:
                    self.expired.append({
                        "dst": p.dst, "seq": p.seq, "code": _code_name(p.code),
                        "attempt": p.attempt, "clock_s": round(now - p.clock, 4)})
                p.attempt += 1
                p.retransmitted = True
                p.deadline = now + self._backoff_delay(st, p.attempt)
                self.stats["retries"] += 1
                resend.append(p)
            # a burst of expiries in one tick (one loss event hitting a
            # window) is one piece of evidence, not N
            for dst in timed_out:
                st = self._peer(dst)
                st.consec_timeouts += 1
                # Karn's rule, part 2: a timeout backs the peer's timeout
                # off, and new frames keep it until a clean sample; with a
                # floor below the true RTT every frame would retransmit and
                # no sample would ever be taken
                st.rto = min(st.rto * 2.0, self.max_backoff)
                ack_silent = now - st.last_ack >= self.breaker_grace
                if (st.consec_timeouts >= self.breaker_fails and ack_silent
                        and not st.dead and st.breaker == "closed"):
                    st.breaker = "open"
                    st.opens += 1
                    st.probe_key = None
                    st.probe_at = now + min(self.breaker_cooldown * (2.0 ** (st.opens - 1)),
                                            4.0 * self.max_backoff)
                    self.stats["breaker_opens"] += 1
                    if self.recorder is not None:
                        self.recorder.event("breaker-open", corr=0, dst=dst)
                    _LOGGER.warning("reliable: circuit to peer %d OPEN after %d consecutive "
                                    "timeouts (rto %.0f ms), probe in %.2f s", dst,
                                    st.consec_timeouts, st.rto * 1e3, st.probe_at - now)
        rec = self.recorder
        for p in resend:
            if rec is not None:
                rec.event("retransmit", corr=p.corr, dst=p.dst, attempt=p.attempt,
                          code=p.code)
            try:
                self.inner.sendv(MessageCode.ReliableFrame, p.parts, dst=p.dst)
            except (OSError, ConnectionError, KeyError):
                pass  # the next pass retries or gives up

    def _retry_loop(self) -> None:
        tick = min(0.02, self.ack_timeout / 2)
        while not self._closed:
            self._retry_wake.wait(tick)
            self._retry_wake.clear()
            if self._closed:
                return
            self._pump_arrivals()
            self._flush_acks()  # the timed cumulative-ack flush
            self._retry_tick()

    # ---------------------------------------------------------------- recv

    def _pump(self, timeout: float) -> None:
        """Take in one inner frame (waiting up to ``timeout``) and park it if
        deliverable; when another thread is reading the inner transport, it
        processes what arrives, and this only waits."""
        if not self._rx_lock.acquire(timeout=timeout):
            return
        try:
            delivery = self._process(*self._next_inner(timeout))
            if delivery is not None:
                self._requeue.append(delivery)
        finally:
            self._rx_lock.release()

    def _next_inner(self, timeout: float) -> Tuple[Optional[Message], Optional[float]]:
        """The oldest inner frame not yet processed and when it was read:
        the backlog's first, else the inner transport's next (read now).
        Caller holds ``_rx_lock``."""
        if self._backlog:
            read_at, msg = self._backlog.popleft()
            return msg, read_at
        return self.inner.recv(timeout=timeout), None

    def _pump_arrivals(self) -> None:
        """Take in the frames already waiting in the inner transport (the
        retry tick's share of receiving), unless a thread is receiving now,
        until :data:`PARK_MAX` frames wait for the application. Beyond
        that, acks are still taken in (a lagging application must not time
        out its own frames), and data frames go to the backlog unprocessed
        and unacked, so a receiver that stops reading still closes its
        senders' windows."""
        if not self._rx_lock.acquire(blocking=False):
            return
        try:
            while not self._closed:
                if len(self._requeue) < PARK_MAX:
                    msg, read_at = self._next_inner(0.0)
                    if msg is None:
                        return
                    delivery = self._process(msg, read_at)
                    if delivery is not None:
                        self._requeue.append(delivery)
                    continue
                msg = self.inner.recv(timeout=0.0)
                if msg is None:
                    return
                if msg[1] in _ACK_CODES:
                    self._process(msg)
                else:
                    self._backlog.append((time.monotonic(), msg))
        finally:
            self._rx_lock.release()

    def _process(self, msg: Optional[Message], read_at: Optional[float] = None):
        """Handle one inner frame (read from the inner transport at
        ``read_at``, else now): acks and envelope bookkeeping are absorbed;
        returns ``(corr, envelope, message)`` for a deliverable frame
        (``envelope`` is ``(incarnation, seq)``, ``None`` for a plain
        frame), else ``None``. Caller holds ``_rx_lock``."""
        if msg is None:
            return None
        sender, code, payload = msg
        with self._lock:
            self._revive(sender)
        if code == MessageCode.ReliableAck:
            # the ack echoes the frame's incarnation: an ack for a previous
            # life's frame of the same seq must not clear this life's
            if payload.size >= 4:
                try:
                    seq = _join16(payload[0], payload[1])
                    inc = _join16(payload[2], payload[3])
                except (ValueError, OverflowError):
                    return None
                if inc != self.incarnation:
                    return None
                now = time.monotonic()
                with self._lock:
                    head = self._oldest_pending(sender) == seq
                    p = self._pop_pending((sender, seq))
                    if p is not None:
                        st = self._peer(sender)
                        if not p.retransmitted:
                            self._rtt_sample(st, now - p.first_sent)
                            self._note_ack_wait(p, now)
                        if head:
                            self._restart_clocks(sender, now)
                        self._on_peer_ack(st)
                        self.stats["acked"] += 1
                        key = (sender, p.code)
                        self._acked_codes[key] = self._acked_codes.get(key, 0) + 1
            return None
        if code == MessageCode.CumAck:
            # every seq <= cum of our incarnation is acked, and the peer's
            # advertised credit rides along
            if payload.size >= 5 and np.isfinite(payload[:5]).all():
                try:
                    inc = _join16(payload[0], payload[1])
                    cum = _join16(payload[2], payload[3])
                    credit = int(payload[4])
                except (ValueError, OverflowError):
                    return None
                if inc != self.incarnation:
                    return None
                now = time.monotonic()
                with self._lock:
                    st = self._peer(sender)
                    st.credit = credit
                    keys = [k for k in self._pending if k[0] == sender and k[1] <= cum]
                    freshest = None
                    for k in keys:
                        p = self._pop_pending(k)
                        self.stats["acked"] += 1
                        self.stats["cum_acked"] += 1
                        ck = (sender, p.code)
                        self._acked_codes[ck] = self._acked_codes.get(ck, 0) + 1
                        if p.retransmitted:
                            continue
                        self._note_ack_wait(p, now)
                        if freshest is None or p.first_sent > freshest:
                            freshest = p.first_sent
                    if freshest is not None:
                        self._rtt_sample(st, now - freshest)
                    if keys:  # every key is <= cum, so the oldest was among them
                        self._restart_clocks(sender, now)
                    self._on_peer_ack(st)
            return None
        if code != MessageCode.ReliableFrame:
            with self._lock:
                self.stats["passthrough"] += 1
            # a plain frame from an unwrapped peer: no envelope to remember,
            # and no correlation id (never inherit a stale one)
            return 0, None, msg
        if payload.size < 9:
            return None  # a truncated envelope: unacked, the sender retries
        try:
            inc = _join16(payload[0], payload[1])
            seq = _join16(payload[2], payload[3])
            crc = _join16(payload[4], payload[5])
            inner_code = int(payload[6])
            corr = _join16(payload[7], payload[8])
        except (ValueError, OverflowError):
            # a header float turned non-finite: unacked, the retry delivers
            # a clean copy
            with self._lock:
                self.stats["crc_dropped"] += 1
            return None
        body = payload[9:]
        checksum = _frame_crc_legacy if self.legacy_envelope else _frame_crc
        if checksum(inc, seq, inner_code, body, corr) != crc:
            with self._lock:
                self.stats["crc_dropped"] += 1
            return None
        with self._lock:
            known = self._peer_inc.get(sender)
            new_second = known is None or inc > known
            if new_second or (inc == known and self._another_life(sender, inc, seq, crc)):
                # a newer life of this rank: a fresh sequence space, which
                # the old dedup state would blackhole
                self._peer_inc[sender] = inc
                self._seen.pop(sender, None)
                self._rx[sender] = _RxState(inc)
                if new_second:
                    self._firsts[sender] = set()
            if seq == 0 and inc == self._peer_inc[sender]:
                self._firsts.setdefault(sender, set()).add(crc)
            # inc < known: a retry from the rank's previous life, acked
            # below so the dead process stops retrying, never delivered
            stale = known is not None and inc < known
        deliver = not stale
        mcode: Optional[MessageCode] = None
        if deliver:
            try:
                mcode = MessageCode(inner_code)
            except ValueError:
                deliver = False  # acked (no retries of garbage), never delivered
        dup = False
        if deliver:
            with self._lock:
                rx = self._rx.setdefault(sender, _RxState(inc))
                seen = self._seen.setdefault(sender, collections.OrderedDict())
                if seq <= rx.cum_hw or seq in seen:
                    dup = True
                    self.stats["dup_dropped"] += 1
                else:
                    seen[seq] = True
                    while len(seen) > self.dedup_window:
                        seen.popitem(last=False)
                    self.stats["delivered"] += 1
        key = (sender, seq, inc)
        if deliver and not dup and not self.ack_on_delivery and mcode in LOGGED_BEFORE_ACK:
            # log-before-ack: withheld from here on; ack_delivered() releases
            # it once recv() has handed the frame out and the update behind
            # it is durable (a frame still parked is not yet applied)
            with self._lock:
                self._deferred_acks[key] = False
                self._taken_in[key] = time.monotonic() if read_at is None else read_at
            return corr, (inc, seq), (sender, mcode, body)
        send_individual = False
        flush_now = False
        with self._lock:
            # a duplicate of a frame whose ack is withheld is not re-acked
            # early: the retry is the sender doing its job until durability
            # commits
            withheld = key in self._deferred_acks
            if not withheld:
                rx = self._rx.get(sender)
                if (stale or not deliver or rx is None or rx.inc != inc
                        or not self.batched_acks):
                    send_individual = True
                elif dup:
                    if seq <= rx.cum_hw:
                        # below the frontier: the next cumulative ack covers
                        # it again, no per-frame re-ack storm
                        rx.dirty += 1
                        flush_now = rx.dirty >= self.ack_batch_n
                    else:
                        send_individual = True  # a seeded or out-of-order dup
                else:
                    self._mark_eligible(rx, seq)
                    if seq <= rx.cum_hw:
                        rx.dirty += 1
                        flush_now = rx.dirty >= self.ack_batch_n
                    else:
                        # out of order (a gap below it): acked at once
                        send_individual = True
        if send_individual:
            self._send_ack(sender, seq, inc)
        if flush_now:
            self._flush_acks()
        if deliver and not dup:
            return corr, (inc, seq), (sender, mcode, body)
        return None

    def _another_life(self, sender: int, inc: int, seq: int, crc: int) -> bool:
        """Whether a frame of ``sender``'s current incarnation is the first
        of a new life begun in the same second: a seq 0 whose checksum no
        seq 0 of this incarnation had (a retry repeats its frame's; a new
        life's carries its own nonce). A seq 0 seeded from the log, its
        checksum unknown, is taken as a retry. The old life's withheld acks
        are dropped: they would name the new life's seqs. Caller holds
        ``_lock``."""
        firsts = self._firsts.get(sender)
        if seq != 0 or not firsts or crc in firsts:
            return False
        for key in [k for k in self._deferred_acks if k[0] == sender and k[2] == inc]:
            del self._deferred_acks[key]
            self._taken_in.pop(key, None)
        _LOGGER.warning("reliable: rank %d began a new life in incarnation %d's second "
                        "(a seq 0 with another checksum) — fresh sequence space",
                        sender, inc)
        return True

    def _mark_eligible(self, rx: _RxState, seq: int) -> None:
        """Record one ack-eligible seq and advance the cumulative frontier
        through any now-contiguous run. Caller holds ``_lock``."""
        if seq == rx.cum_hw + 1:
            rx.cum_hw = seq
            while rx.cum_hw + 1 in rx.eligible:
                rx.cum_hw += 1
                rx.eligible.discard(rx.cum_hw)
        elif seq > rx.cum_hw:
            rx.eligible.add(seq)
            if len(rx.eligible) > self.dedup_window:
                # a permanent gap (frames lost with a dead peer) must not
                # grow the set forever; the dropped entries were acked
                # individually already
                rx.eligible.discard(min(rx.eligible))

    def _send_ack(self, sender: int, seq: int, inc: int) -> None:
        with self._lock:
            self.stats["acks_tx"] += 1
        try:
            self.inner.send(MessageCode.ReliableAck,
                            np.asarray([*_split16(seq), *_split16(inc)], np.float32),
                            dst=sender)
        except (OSError, ConnectionError, KeyError):
            pass  # a lost ack: the sender's retry asks again

    def _credit_for(self, sender: int) -> int:
        """How many more frames this receiver will have in flight from
        ``sender``. Caller holds ``_lock``."""
        if self._credit_override is not None:
            return max(0, int(self._credit_override))
        withheld = sum(1 for (s, _q, _i), handed in self._deferred_acks.items()
                       if s == sender and handed)
        parked = sum(1 for _c, _e, m in list(self._requeue) if m[0] == sender)
        credit = max(0, self.recv_window - withheld - parked)
        served = self._served_credit(parked)
        return credit if served is None else min(credit, served)

    def _lag_service(self) -> Optional[float]:
        """The application's time a frame while it lags, else None: the
        slowest code's running estimate, or the time it has held the frame
        it took last when that is longer (a frame slower than the ones
        before it shows while it is served, not after); unbounded while it
        holds a frame of a code it has not served before (a first push is
        not as quick as the pulls before it: one frame at a time until its
        time is known). The application lags while a frame waited at its
        last hand-out (within the last timeout floor), or while frames
        wait as it holds one. Caller holds ``_lock``."""
        now = time.monotonic()
        held, code = (0.0, None) if self._last_handout is None else (
            now - self._last_handout[0], self._last_handout[1])
        if now >= self._lag_until and not (held > 0.0 and (self._requeue or self._backlog)):
            return None
        if code is not None and code not in self._service_s:
            return float("inf")
        return max(max(self._service_s.values(), default=0.0), held)

    def _served_credit(self, parked: int) -> Optional[int]:
        """While the application lags, the frames a sender may have queued
        here that it serves within :data:`LAG_CREDIT_SHARE` of the timeout
        floor, less the ``parked`` ones it has queued already (acked frames
        among them: a push waits behind them all); None when it does not
        lag. Caller holds ``_lock``."""
        service = self._lag_service()
        if not service:
            return None
        share = self.ack_timeout * LAG_CREDIT_SHARE / service
        return max(0, int(min(share / max(1, len(self._rx)), self.recv_window)) - parked)

    def _flush_acks(self) -> None:
        """Send every dirty cumulative ack (on a full batch, on the retry
        tick and at durability commits), outside the lock."""
        out = []
        with self._lock:
            for sender, rx in self._rx.items():
                if rx.cum_hw < 0:
                    continue
                credit = self._credit_for(sender)
                # a cut while the application lags is news: sent at once
                cut = self._lag_service() is not None and credit < (
                    self.recv_window if rx.advertised is None else rx.advertised)
                if rx.dirty <= 0 and not cut:
                    continue
                rx.dirty = 0
                rx.advertised = credit
                out.append((sender, np.asarray(
                    [*_split16(rx.inc), *_split16(rx.cum_hw), float(credit)], np.float32)))
        for sender, frame in out:
            with self._lock:
                self.stats["cum_acks_tx"] += 1
            try:
                self.inner.send(MessageCode.CumAck, frame, dst=sender)
            except (OSError, ConnectionError, KeyError):
                pass  # a lost ack: the sender's retransmit asks again

    def ack_delivered(self) -> None:
        """Release the withheld acks of every frame :meth:`recv` has handed
        out; call only once the updates behind them are durable (the WAL's
        group commit). In-order runs collapse into one cumulative ack;
        frames above a gap keep their individual acks."""
        individual = []
        with self._lock:
            due = [k for k, handed in self._deferred_acks.items() if handed]
            for key in due:
                del self._deferred_acks[key]
                self._taken_in.pop(key, None)
        rec = self.recorder
        if rec is not None and due:
            # the durability commit released these acks
            rec.event("ack-release", corr=0, n=len(due))
        with self._lock:
            for sender, seq, inc in due:
                rx = self._rx.get(sender)
                if rx is None or rx.inc != inc or not self.batched_acks:
                    individual.append((sender, seq, inc))
                    continue
                self._mark_eligible(rx, seq)
                if seq <= rx.cum_hw:
                    rx.dirty += 1
                else:
                    individual.append((sender, seq, inc))
        for sender, seq, inc in individual:
            self._send_ack(sender, seq, inc)
        self._flush_acks()

    def acks_overdue(self) -> bool:
        """Whether a withheld ack of a frame already handed to the
        application has waited :data:`LAG_CREDIT_SHARE` of the timeout
        floor since the frame was read from the inner transport: a durable receiver commits then
        instead of growing its group."""
        limit = time.monotonic() - self.ack_timeout * LAG_CREDIT_SHARE
        with self._lock:
            return any(handed and self._taken_in.get(k, limit) < limit
                       for k, handed in self._deferred_acks.items())

    def advertise_credit(self, credit: Optional[int]) -> None:
        """Pin the advertised credit (``None`` restores the default,
        ``recv_window`` less the withheld acks) and push it to every known
        sender: a receiver narrows its senders' windows under load."""
        with self._lock:
            self._credit_override = credit
            for rx in self._rx.values():
                if rx.cum_hw >= 0:
                    rx.dirty = max(rx.dirty, 1)
        self._flush_acks()

    @property
    def last_delivery(self) -> Optional[Tuple[int, int]]:
        """``(incarnation, seq)`` of the most recently delivered envelope
        (``None`` after a plain frame): what a durable receiver records per
        WAL record, so that a restart can seed dedup."""
        with self._lock:
            return self._last_delivery

    def acked_count(self, dst: int, code: MessageCode) -> int:
        """How many frames of ``code`` sent to ``dst`` were acked."""
        with self._lock:
            return self._acked_codes.get((dst, int(code)), 0)

    def seed_dedup(self, entries) -> None:
        """Mark ``(sender, incarnation, seq)`` triples as already delivered:
        a restored server seeds the envelopes its log and checkpoint
        recorded, so a sender's retry of an applied but unacked frame is
        re-acked, never applied again."""
        with self._lock:
            for sender, inc, seq in entries:
                known = self._peer_inc.get(sender)
                if known is None or inc > known:
                    self._peer_inc[sender] = inc
                    self._seen[sender] = collections.OrderedDict()
                    self._firsts[sender] = set()
                if inc == self._peer_inc.get(sender):
                    seen = self._seen.setdefault(sender, collections.OrderedDict())
                    seen[seq] = True
                    while len(seen) > self.dedup_window:
                        seen.popitem(last=False)
                    # the frontier stays below the seeded entries (they may
                    # be sparse): their dups take the individual-ack path
                    self._rx.setdefault(sender, _RxState(inc))

    # -------------------------------------------------- wire-health surface

    def breaker_state(self, dst: int) -> str:
        """``closed``, ``open``, ``half-open`` or ``dead``."""
        with self._lock:
            st = self._peers.get(dst)
            if st is None:
                return "closed"
            if st.dead:
                return "dead"
            if st.breaker == "open":
                return "half-open" if st.probe_key is not None else "open"
            return "closed"

    def breaker_open(self, dst: int) -> bool:
        return self.breaker_state(dst) != "closed"

    def open_breakers(self) -> int:
        """How many peers have a circuit that is not closed."""
        with self._lock:
            return sum(1 for st in self._peers.values() if st.dead or st.breaker != "closed")

    def pending_depth(self, dst: Optional[int] = None) -> int:
        """Unacked frames in flight (toward ``dst``, or in all)."""
        with self._lock:
            if dst is None:
                return len(self._pending)
            st = self._peers.get(dst)
            return 0 if st is None else st.inflight

    def pressure(self) -> float:
        """The fullest peer window, 0..1."""
        with self._lock:
            worst = 0.0
            for st in self._peers.values():
                worst = max(worst, st.inflight / self._window(st))
            return min(1.0, worst)

    def rto(self, dst: int) -> float:
        """The peer's current retransmission timeout (seconds)."""
        with self._lock:
            st = self._peers.get(dst)
            return self.ack_timeout if st is None else st.rto

    def emit_wire_stats(self) -> None:
        """One ``wire-stats`` event at teardown with the counters the
        timeline analyzer reads (retransmit share, ack frames per data
        frame, seconds blocked at the window)."""
        rec = self.recorder
        if rec is None:
            return
        with self._lock:
            stats = dict(self.stats)
        rec.event("wire-stats", corr=0,
                  **{k: (round(v, 6) if isinstance(v, float) else v) for k, v in stats.items()})

    def detach(self) -> None:
        """Stop this wrapper (the retry thread exits, ``recv`` returns
        ``None``) without closing the inner transport: a server's restart
        within one process hands the endpoint to a new wrapper."""
        if not self._closed:
            self.emit_wire_stats()
        self._closed = True
        self._retry_wake.set()

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        """The next deliverable frame, parked ones first; its envelope
        becomes :attr:`last_delivery` and its correlation id this thread's
        (the handler inherits the sender's unit of work)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            if self._last_handout is not None:
                # the application's time for the frame it took last
                t, code = self._last_handout
                dt = time.monotonic() - t
                est = self._service_s.get(code)
                self._service_s[code] = dt if est is None else max(dt, 0.7 * est + 0.3 * dt)
                self._last_handout = None
        while True:
            if self._closed:
                return None
            slice_t = 0.1
            if deadline is not None:
                slice_t = max(0.0, min(0.1, deadline - time.monotonic()))
            with self._rx_lock:
                if self._requeue:
                    delivery = self._requeue.popleft()
                else:
                    delivery = self._process(*self._next_inner(slice_t))
                waiting = bool(self._requeue or self._backlog)
            if delivery is not None:
                corr, envelope, msg = delivery
                with self._lock:
                    now = time.monotonic()
                    self._last_handout = (now, int(msg[1]))
                    if waiting:
                        self._lag_until = now + self.ack_timeout
                    self._last_delivery = envelope
                    if envelope is not None:
                        key = (msg[0], envelope[1], envelope[0])
                        if key in self._deferred_acks:
                            self._deferred_acks[key] = True  # now the application's
                _obs.set_corr(corr)
                return msg
            if deadline is not None and time.monotonic() >= deadline:
                return None

    # --------------------------------------------------------------- admin

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every sent frame is acked (or its peer is dead, or
        ``timeout``); pumps the inner transport itself, so acks clear with
        no other thread in :meth:`recv`, and parks data frames for the next
        ``recv``. Call it before ``WorkerDone``."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                live = [k for k in self._pending if k[0] not in self._dead_peers]
            if not live:
                return True
            self._pump(timeout=0.02)
        return False

    def rendezvous_done(self) -> bool:
        """The inner transport's rendezvous (``TCPTransport.
        rendezvous_done``); True when it has none."""
        done = getattr(self.inner, "rendezvous_done", None)
        return True if done is None else done()

    def close(self) -> None:
        if not self._closed:
            self.flush(timeout=min(2.0, self.max_backoff))
            self.emit_wire_stats()
        self._closed = True
        self._retry_wake.set()
        self.inner.close()


def make_transport(rank: int, world_size: int, master: str = "localhost",
                   port: int = 29500, kind: str = "auto", connect_timeout: float = 60.0,
                   reliable: bool = False, durable_acks: bool = False,
                   reliable_opts: Optional[dict] = None) -> Transport:
    """The transport of one rank of the PS world.

    ``kind``: ``"native"`` (the C++ library, ``native/transport.cpp``,
    built with g++ on first use; raises when it cannot be built or loaded),
    ``"python"`` (:class:`TCPTransport`) or ``"auto"`` (native when it
    loads, else Python). Both speak one wire format, so mixed worlds
    interoperate. ``reliable`` wraps the result in a
    :class:`ReliableTransport` (set it on every rank of the world);
    ``durable_acks`` (a server with a WAL, which calls ``ack_delivered``
    from ``ParameterServer.commit``) defers each delivery ack until the
    update behind it is durable. ``reliable_opts`` passes tuning knobs
    (``ack_timeout``, ``send_window``, ...) to the wrapper. A reliable
    server, native or Python, returns before its workers have all connected,
    so that it serves the first while the rest connect (a durable receiver
    that is not serving holds its pushes' acks): its ``rendezvous_done()``,
    which ``ParameterServer.run`` polls, ends the rendezvous and raises past
    ``connect_timeout``. Any other rank 0 waits for its workers here."""
    if kind not in ("auto", "native", "python"):
        raise ValueError(f"unknown transport kind: {kind!r}")
    # the reliable server's layer runs before the rendezvous ends: the frames
    # of the workers that connected first are taken in and acked while the
    # others connect, not left to time out
    open_server = reliable and rank == SERVER_RANK
    opts = dict(ack_on_delivery=not durable_acks, **(reliable_opts or {}))
    t: Optional[Transport] = None
    if kind in ("auto", "native"):
        from distributed_ml_pytorch_tpu_torch import native

        if native.native_available():
            t = native.NativeTCPTransport(rank, world_size, master, int(port),
                                          connect_timeout, open_rendezvous=open_server)
        elif kind == "native":
            raise RuntimeError("native transport requested but unavailable: "
                               f"{native.native_load_error()}")
    if t is None and open_server:
        t = TCPTransport(rank, world_size, master, int(port), connect_timeout, wait_for=0)
    if open_server:
        t.expect_peers(world_size - 1, connect_timeout)
    elif t is None:
        t = TCPTransport(rank, world_size, master, int(port), connect_timeout)
    if not reliable:
        return t
    rt = ReliableTransport(t, **opts)
    # the wrapper's counters are in every --metrics-dump (a restarted rank
    # attaches its new wrapper in place of the old one)
    from distributed_ml_pytorch_tpu_torch.utils.metrics import get_registry

    get_registry().attach(f"wire.rank{rank}", lambda rt=rt: dict(rt.stats))
    return rt


def make_world(world_size: int, *, reliable: bool = False, plan=None, log=None,
               reliable_opts: Optional[dict] = None):
    """One in-process world through the layer stack the TCP and native
    paths use: the mailboxes, wrapped in ``utils/chaos.FaultyTransport``
    under ``plan`` (a ``ChaosPlan``; ``log`` the ``ChaosLog`` to share), then
    reliability-wrapped on every rank with ``reliable`` — reliable over chaos
    over raw, the JAX package's order. Returns ``(transports, chaos log or
    None)``."""
    world: Dict[int, Transport] = InProcessTransport.create_world(world_size)
    chaos_log = None
    if plan is not None:
        from distributed_ml_pytorch_tpu_torch.utils.chaos import FaultyTransport

        world, chaos_log = FaultyTransport.wrap_world(world, plan, log=log)
    if reliable:
        world = {r: ReliableTransport(t, **(reliable_opts or {})) for r, t in world.items()}
    return world, chaos_log


# --- module-level default transport: the reference's send_message has no
# transport argument (its process group is ambient state)

_default_transport: Optional[Transport] = None


def set_default_transport(t: Optional[Transport]) -> None:
    global _default_transport
    _default_transport = t


def get_default_transport() -> Transport:
    if _default_transport is None:
        raise RuntimeError("no default transport installed — call set_default_transport()")
    return _default_transport


def _host_f32(payload) -> np.ndarray:
    if hasattr(payload, "detach"):  # a torch tensor, on any device
        payload = payload.detach().cpu().numpy()
    return np.asarray(payload, dtype=np.float32)


def send_message(message_code: MessageCode, payload, dst: int = SERVER_RANK,
                 transport: Optional[Transport] = None) -> None:
    """Fire-and-forget tagged tensor send (reference ``Asynchronous.py:34,49,59``)."""
    t = transport or get_default_transport()
    t.send(MessageCode(message_code), _host_f32(payload), dst=dst)


class MessageListener(threading.Thread):
    """Background receive loop; subclasses override :meth:`receive` and
    deposit results for the training loop to install between steps."""

    def __init__(self, model=None, transport: Optional[Transport] = None):
        super().__init__(daemon=True)
        self.model = model
        self.transport = transport or get_default_transport()
        self._running = threading.Event()
        self._running.set()

    def receive(self, sender: int, message_code: MessageCode, parameter: np.ndarray) -> None:
        raise NotImplementedError

    def run(self) -> None:
        while self._running.is_set():
            msg = self.transport.recv(timeout=0.1)
            if msg is None:
                continue
            sender, code, payload = msg
            self.receive(sender, MessageCode(code), payload)

    def stop(self) -> None:
        self._running.clear()
