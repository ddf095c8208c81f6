"""Async DownPour-SGD parameter server (counterpart of the JAX
``parallel/async_ps.py``; the reference's ``asgd/optim/Asynchronous.py``).

- Workers train locally with SGD and accumulate their updates into a flat
  float32 vector every step (``accum += updates`` through the ``flat_axpy``
  kernel, ``ops/fused_update.py``).
- Every ``n_pull`` steps a worker sends **ParameterRequest**; the server
  replies with **ParameterUpdate** carrying the central vector.
- Every ``n_push`` steps the worker sends **GradientUpdate** with the
  accumulator and zeroes it; the server ADDS it to the central vector (the
  updates are already lr-scaled).
- At construction each worker installs its initial parameters as the central
  vector (one ParameterUpdate), or with ``rejoin`` adopts the server's;
  ``WorkerDone`` lets the server stop once every worker has finished.

The flat vector is laid out exactly as the JAX package lays it out
(``utils/serialization.py``), so a port worker can train against a JAX
server and the other way round. A listener thread receives replies while the
worker trains and the optimizer installs the newest one between steps, so no
step sees a torn model. Pushes are snapshots of the accumulator, copied to
the host and sent by a background thread (:class:`PushFlusher`) while the
next steps run.

**Chunked dispatch.** Between two host-communication gaps every step is
purely local SGD, so a worker can run the whole run as one dispatch
(:func:`downpour_chunk_schedule`, :meth:`Asynchronous.boundary`). On the
card, :func:`make_downpour_chunk_step` captures one DownPour step (forward,
backward with the relu→pool kernels, the local update and ``flat_axpy``)
as a CUDA graph and replays it once per step of the run; on the CPU the same
step runs in a loop.

**The server's planes.** Checkpoint and resume of the central vector and its
clock (``ps_central.npy`` and ``ps_meta.json``, bound by a CRC, the previous
generation kept for the window between the two renames), the write-ahead log
(``ps_wal.log``, ``utils/wal.py``) with group commit, the admission gate
(``utils/health.py``) whose rejects are quarantined and nacked
(``UpdateNack``), and staleness damping. File names, meta keys and the log's
bytes are the JAX package's, so either package restores the other's
directory.

**The reliable wire.** Over a ``utils/messaging.ReliableTransport`` the
server records the delivery envelope ``(incarnation, seq)`` of each applied
push in its WAL record and in a tail of recent envelopes kept in the
checkpoint's meta; a restored server seeds the transport's dedup from both,
so a retry of a push applied before a crash is re-acked, not applied again.
With durable acks (``--wal``) the ack of a push is released only after the
log's fsync (:meth:`ParameterServer.commit`). A worker flushes its pending
frames before ``WorkerDone``.

**The optimizer and codec plane.** A worker with ``compress="int8"|"topk"``
pushes ``CompressedUpdate`` frames through an error-feedback encoder
(``utils/compress.py``); the server decodes a frame before its admission
gate, logs the decoded delta with its codec id and applies it like a dense
push. ``combine="adasum"`` merges each push with the overlap applied since
its worker's last pull (``parallel/optplane.adasum_adjust``), and an
``optimizer`` (``optplane.ShardedOptimizer``) turns each combined update
into the applied delta; its state rides the checkpoint (``ps_opt.npz``) and
WAL replay re-runs it. A worker with ``delta_pull`` sends its held stamp
with each pull and the server answers with a ``DeltaParams`` frame: a top-k
delta against the view it tracks for that worker, or a full install after a
miss or a restore.

**The elastic path.** With ``pull_reply_head`` set (by
``coord/elastic.ElasticShardServer``, which re-stamps it on every resize)
the server answers a pull with ``ShardParams``, the vector behind the
owner's map version and absolute range; the :class:`Listener` keeps that
stamp beside the reply for the elastic client's range gate.

**Rollback.** :meth:`ParameterServer.rollback_restore` rebuilds a live
server in place as its checkpoint plus the WAL replayed up to a target
apply seq (the one the coordinator's last good fleet manifest names) and
drops the log's tail past it, so the discarded updates cannot come back at
a later restore.
"""

from __future__ import annotations

import collections
import io
import json
import logging
import math
import os
import queue
import sys
import threading
import time
import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from distributed_ml_pytorch_tpu_torch.ops.fused_update import LANES, flat_axpy
from distributed_ml_pytorch_tpu_torch.parallel.optplane import adasum_adjust
from distributed_ml_pytorch_tpu_torch.utils import codecs
from distributed_ml_pytorch_tpu_torch.utils.compress import (
    CODEC_DENSE,
    CODEC_TOPK,
    CompressingEncoder,
    CompressionError,
    body_crc,
    decode_update,
    make_codec,
)
from distributed_ml_pytorch_tpu_torch.utils.durability import atomic_write
from distributed_ml_pytorch_tpu_torch.utils.failure import StalenessAuditor
from distributed_ml_pytorch_tpu_torch.utils.health import (
    NACK_REASONS,
    admission_from_args,
    clamp_finite32,
)
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    LOGGED_BEFORE_ACK,
    SERVER_RANK,
    MessageCode,
    MessageListener,
    ReliableTransport,
    Transport,
    _join16,
    _next_incarnation,
    _split16,
    send_message,
)
from distributed_ml_pytorch_tpu_torch.utils.serialization import (
    make_unraveler,
    ravel_model_params,
    ravel_tensors,
    unravel_model_params,
)

_LOGGER = logging.getLogger(__name__)

#: group commit: the log is fsync'd after this many pushes at the latest
WAL_GROUP_N = 8
#: delivery envelopes of the latest applies kept in the checkpoint's meta
RECENT_ENVELOPES = 512
#: the chunked worker reads its device losses back every this many dispatches
LOSS_FLUSH_DISPATCHES = 8


class ParameterServer:
    """Central parameter holder: a host float32 vector.

    ``run()`` serves messages until every worker has sent ``WorkerDone``
    (or failed, with ``worker_timeout``), ``stop()`` is called or the
    timeout passes.

    - ``ckpt_dir``: where the central vector and its clock are saved, every
      ``ckpt_every`` applied pushes and at the end of ``run()``;
      :meth:`maybe_restore` adopts them. A restored server answers a
      worker's install with its own vector instead of taking it.
    - ``wal``: log each applied update before it mutates the vector
      (``<ckpt_dir>/ps_wal.log``), fsync'd in groups of :data:`WAL_GROUP_N`
      (:meth:`commit`); restore replays what the checkpoint does not cover.
    - ``admission``: a ``utils/health.GradientAdmission``; a push it rejects
      never reaches the vector, the clock or the log, and its sender gets an
      ``UpdateNack``.
    - ``staleness_damping``: a push that raced ``s`` versions since its
      worker last pulled applies scaled by ``1 / (1 + damping * s)``.
    - ``combine``: ``"add"``, or ``"adasum"`` (each push merged with the
      overlap applied since its worker's last pull; the alternative to
      damping, never stacked on it).
    - ``optimizer``: an ``optplane.ShardedOptimizer`` over exactly this
      server's vector, stepped on each combined update; the WAL logs its
      input, the checkpoint its state (``ps_opt.npz``).
    """

    def __init__(self, model: Optional[nn.Module] = None, *,
                 params: Optional[np.ndarray] = None,
                 transport: Optional[Transport] = None,
                 n_workers: Optional[int] = None,
                 worker_timeout: Optional[float] = None,
                 ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 500,
                 staleness_damping: float = 0.0,
                 wal: bool = False,
                 admission=None,
                 combine: str = "add",
                 optimizer=None,
                 recorder=None):
        if params is not None:
            self.central = np.asarray(params, dtype=np.float32).copy()
        elif model is not None:
            self.central = ravel_model_params(model).cpu().numpy().astype(np.float32)
        else:
            raise ValueError("ParameterServer needs a model or a flat params vector")
        self.transport = transport
        self.n_workers = n_workers
        self.worker_timeout = worker_timeout
        self.failed_workers: set = set()
        self.message_counts = {code: 0 for code in MessageCode}
        self.dropped_bad_updates = 0
        self.staleness = StalenessAuditor()
        self.staleness_damping = float(staleness_damping)
        #: the optional flight recorder (``utils/obs.SpanRecorder``): the
        #: server's side of a push's timeline (quarantines, the log's append
        #: and fsync, the apply) under the correlation id its envelope
        #: carried; never consulted for a decision
        self.recorder = recorder
        # --- durability: checkpoint, clock, write-ahead log
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every or 0)
        self._push_count = 0
        self._restored = False
        self.rejected_installs = 0
        #: this server life's stamp on its log records
        self.incarnation = _next_incarnation()
        #: one increment per applied push, monotonic across lives (restored
        #: from the meta): the checkpoint/log handshake key
        self._apply_seq = 0
        self.applied_by_sender: dict = {}
        self.replayed_updates = 0
        #: applied updates a rollback discarded, over the server's life
        self.rolled_back_updates = 0
        #: ``(sender, incarnation, seq)`` of recent applies, kept in the
        #: checkpoint's meta: a truncation drops the log's envelopes, but an
        #: ack may still be lost in flight, and the retry must be re-acked
        self._recent_envelopes = collections.deque(maxlen=RECENT_ENVELOPES)
        #: the delivery envelope of the frame being handled (``run()`` reads
        #: the transport's ``last_delivery``), recorded per WAL record
        self._envelope = None
        self._prev_ckpt_meta = None
        self.wal = None
        if wal:
            if not self.ckpt_dir:
                raise ValueError("wal=True needs a ckpt_dir — the write-ahead log lives "
                                 "beside the checkpoint it protects")
            from distributed_ml_pytorch_tpu_torch.utils.wal import WriteAheadLog

            self.wal = WriteAheadLog(os.path.join(self.ckpt_dir, "ps_wal.log"),
                                     incarnation=self.incarnation)
        # --- admission
        self.admission = admission
        self.quarantined = 0
        self.quarantined_by_sender: dict = {}
        self.nacks_sent = 0
        # --- the optimizer plane
        if combine not in ("add", "adasum"):
            raise ValueError(f"combine must be 'add' or 'adasum', got {combine!r}")
        if combine == "adasum" and self.staleness_damping > 0.0:
            raise ValueError("combine='adasum' replaces --staleness-damping — pick one "
                             "(stacking them would damp the same staleness twice)")
        self.combine = combine
        #: adasum: sender -> the deltas applied since its last pull
        self._overlap: dict = {}
        self.optimizer = optimizer
        if optimizer is not None and optimizer.size != self.central.shape[0]:
            raise ValueError(f"optimizer covers {optimizer.size} params but this server "
                             f"holds {self.central.shape[0]}")
        # --- delta pull replies
        #: bumped, and the bases dropped, on every restore: the next reply
        #: to every worker is a full install
        self._pull_epoch = 0
        #: sender -> (epoch, apply seq, view): the worker's exact installed
        #: vector, replayed from this server's own encode and decode
        self._pull_bases: dict = {}
        self.delta_replies = 0
        self.full_replies = 0
        #: wire floats of the DeltaParams replies sent (head and body)
        self.delta_reply_wire_floats = 0
        #: the elastic reply head ``[ver(2), lo(2), hi(2)]``: when set, full
        #: pull replies go out as ``ShardParams = [*head, *central]``
        self.pull_reply_head: Optional[np.ndarray] = None
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    # ------------------------------------------------------- durability

    def _ckpt_path(self) -> str:
        return os.path.join(self.ckpt_dir, "ps_central.npy")

    def _meta_path(self) -> str:
        return os.path.join(self.ckpt_dir, "ps_meta.json")

    def _opt_path(self) -> str:
        return os.path.join(self.ckpt_dir, "ps_opt.npz")

    def save_checkpoint(self) -> None:
        """Save the central vector and its clock, atomically and durably
        (``utils/durability.atomic_write``). The meta is written first and
        carries the vector's CRC and, under ``"prev"``, the previous
        generation's fields, so a crash between the two renames is detected
        at restore and resolved to the consistent previous generation (the
        log, truncated only after both renames, still holds the gap)."""
        if not self.ckpt_dir:
            return
        os.makedirs(self.ckpt_dir, exist_ok=True)
        if self.wal is not None:
            self.wal.sync()  # the checkpoint never gets ahead of the log
        buf = io.BytesIO()
        np.save(buf, self.central)
        blob = buf.getvalue()
        meta = {
            "version": self.staleness.version,
            "push_count": self._push_count,
            "apply_seq": self._apply_seq,
            "applied_by_sender": {str(k): int(v) for k, v in self.applied_by_sender.items()},
            "central_crc": zlib.crc32(blob) & 0xFFFFFFFF,
            "recent_envelopes": [list(e) for e in self._recent_envelopes],
            "prev": self._prev_ckpt_meta,
        }
        if self.optimizer is not None:
            # written first, bound to this vector by its CRC; the last
            # completed generation's CRC names the stored one kept as prev
            last_crc = (self._prev_ckpt_meta or {}).get("central_crc")
            self.optimizer.save_state(self._opt_path(), central_crc=int(meta["central_crc"]),
                                      apply_seq=self._apply_seq,
                                      prev_crc=None if last_crc is None else int(last_crc))
        atomic_write(self._meta_path(), json.dumps(meta).encode())
        atomic_write(self._ckpt_path(), blob)
        self._prev_ckpt_meta = {k: v for k, v in meta.items() if k != "prev"}
        if self.wal is not None:
            # every logged update is durable now: release the acks deferred
            # behind them before the truncation drops their records (the
            # meta's recent envelopes keep the dedup seed)
            self._release_acks()
            self.wal.truncate(self._apply_seq)

    def _read_checkpoint(self):
        """The saved ``(vector, meta)`` with the tear window resolved: a
        vector that fails its meta's CRC but matches the previous
        generation's is that generation, and its fields are adopted. A size
        mismatch or a vector matching neither raises."""
        path = self._ckpt_path()
        with open(path, "rb") as f:
            blob = f.read()
        arr = np.load(io.BytesIO(blob))
        if arr.shape != self.central.shape:
            raise ValueError(f"checkpoint at {path} holds {arr.shape[0]} params but the "
                             f"model ravels to {self.central.shape[0]} — wrong --model?")
        meta = None
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                meta = json.load(f)
        if meta is not None and "central_crc" in meta:
            crc = zlib.crc32(blob) & 0xFFFFFFFF
            if crc != int(meta["central_crc"]):
                prev = meta.get("prev")
                if prev is not None and int(prev.get("central_crc", -1)) == crc:
                    _LOGGER.warning("checkpoint meta is one generation ahead of the vector "
                                    "(crash between renames) — restoring the previous "
                                    "consistent generation")
                    meta = prev
                else:
                    raise ValueError(
                        f"checkpoint at {path} matches neither its meta CRC nor the "
                        "previous generation's — refusing to resume with an unverifiable "
                        "staleness clock")
        return arr.astype(np.float32), meta

    def maybe_restore(self) -> bool:
        """Adopt the saved vector and clock, then replay the log past them;
        False when there is nothing to restore. A wrong size, a vector that
        matches neither generation and damage mid-log raise: training on
        from a fresh init while claiming to resume is the one wrong
        answer."""
        if not self.ckpt_dir:
            return False
        restored = False
        if os.path.exists(self._ckpt_path()):
            arr, meta = self._read_checkpoint()
            self.central = arr
            if meta is not None:
                self.staleness.version = int(meta.get("version", 0))
                self._push_count = int(meta.get("push_count", 0))
                self._apply_seq = int(meta.get("apply_seq", 0))
                self.applied_by_sender = {
                    int(k): int(v) for k, v in meta.get("applied_by_sender", {}).items()}
                self._recent_envelopes.extend(
                    (int(s), int(i), int(q)) for s, i, q in meta.get("recent_envelopes", []))
                self._prev_ckpt_meta = {k: v for k, v in meta.items() if k != "prev"}
            self._restore_optimizer_state(meta)
            restored = True
        if self.wal is not None:
            restored = bool(self._replay_wal()) or restored
        if restored:
            self._restored = True
            # the bases describe views this life cannot vouch for
            self.reset_pull_bases()
        return restored

    def reset_pull_bases(self) -> None:
        """Drop every tracked worker view and bump the pull epoch: the next
        reply to each worker is a full install."""
        self._pull_epoch += 1
        self._pull_bases.clear()

    def _restore_optimizer_state(self, meta) -> None:
        """Adopt the optimizer generation bound to the adopted vector by its
        CRC; no state file beside the checkpoint resets the moments, with a
        warning (replay then rebuilds from zero as the live path would)."""
        if self.optimizer is None:
            return
        crc = int(meta["central_crc"]) if meta is not None and "central_crc" in meta else None
        if not self.optimizer.load_state(self._opt_path(), central_crc=crc):
            self.optimizer.reset()
            _LOGGER.warning("no optimizer state beside the checkpoint (%s) — resuming with "
                            "fresh zero moments", self._opt_path())

    def _replay_wal(self) -> int:
        """Re-apply the logged updates the checkpoint does not cover
        (``seq > apply_seq``, so replay is idempotent); returns how many.
        The transport's dedup is seeded from the meta's recent envelopes
        and every surviving record's own, so a sender's retry of an applied
        but unacked push is re-acked, never applied again."""
        records, stats = self.wal.replay()
        envelopes = [tuple(e) for e in self._recent_envelopes]
        n = 0
        for rec in records:
            if rec.env_inc or rec.env_seq:
                envelopes.append((rec.sender, rec.env_inc, rec.env_seq))
                self._recent_envelopes.append((rec.sender, rec.env_inc, rec.env_seq))
            if rec.seq <= self._apply_seq:
                continue
            if rec.payload.shape != self.central.shape:
                raise ValueError(
                    f"WAL record seq {rec.seq} holds {rec.payload.shape[0]} params but the "
                    f"restored vector holds {self.central.shape[0]} — log/checkpoint mismatch")
            # the record is the optimizer's input: replay steps it too
            self._apply_delta(rec.payload)
            self._apply_seq = rec.seq
            self._push_count += 1
            self.staleness.version += 1
            self.applied_by_sender[rec.sender] = self.applied_by_sender.get(rec.sender, 0) + 1
            n += 1
        self.replayed_updates += n
        if stats["stale_skipped"] or stats["torn_tail"]:
            _LOGGER.warning("WAL replay: %d stale-incarnation record(s) skipped, torn tail=%d",
                            stats["stale_skipped"], stats["torn_tail"])
        seed = getattr(self.transport, "seed_dedup", None)
        if seed is not None and envelopes:
            seed(envelopes)
        return n

    def rollback_restore(self, target_seq: int) -> int:
        """Discard the live state and rebuild it as the checkpoint plus the
        WAL replayed up to ``target_seq``, the apply seq the last good fleet
        manifest names; returns how many applied updates were discarded.

        The server is live (no process died): its transport and dedup state
        stay. In order: commit, so the acks withheld behind the log go out
        (delivery did happen; the discard is the coordinator's logged
        decision); refuse when the checkpoint on disk is already past the
        target (a later generation overwrote the barrier's, and a "rollback"
        to it would keep the suspect updates); adopt the checkpoint's
        optimizer generation; clear the Adasum overlap windows (they
        describe the discarded regime); replay the log capped at the target;
        drop the log's tail past it; fence the delta-reply bases."""
        if not self.ckpt_dir:
            raise ValueError("rollback_restore needs a ckpt_dir")
        target_seq = int(target_seq)
        self.commit()
        if not os.path.exists(self._ckpt_path()):
            raise ValueError(f"rollback to apply seq {target_seq} impossible: no checkpoint "
                             f"under {self.ckpt_dir!r}")
        before_seq = self._apply_seq
        arr, meta = self._read_checkpoint()
        ckpt_seq = int(meta.get("apply_seq", 0)) if meta is not None else 0
        if ckpt_seq > target_seq:
            raise ValueError(
                f"rollback target apply seq {target_seq} is BEHIND the on-disk checkpoint "
                f"({ckpt_seq}) — a later checkpoint overwrote the snapshot generation; "
                "refusing to fake a rollback that keeps the suspect updates")
        self.central = arr
        if meta is not None:
            self.staleness.version = int(meta.get("version", 0))
            self._push_count = int(meta.get("push_count", 0))
            self._apply_seq = ckpt_seq
            self.applied_by_sender = {
                int(k): int(v) for k, v in meta.get("applied_by_sender", {}).items()}
        else:
            self._apply_seq = 0
        # the live optimizer state goes with the live vector: the capped
        # replay catches both up to the target together
        self._restore_optimizer_state(meta)
        if self.combine == "adasum":
            self._overlap.clear()
        replayed = 0
        if self.wal is not None:
            records, _stats = self.wal.replay()
            for rec in records:
                if rec.seq <= self._apply_seq or rec.seq > target_seq:
                    continue
                if rec.payload.shape != self.central.shape:
                    raise ValueError(
                        f"WAL record seq {rec.seq} holds {rec.payload.shape[0]} params but "
                        f"the restored vector holds {self.central.shape[0]}")
                self._apply_delta(rec.payload)
                self._apply_seq = rec.seq
                self._push_count += 1
                self.staleness.version += 1
                self.applied_by_sender[rec.sender] = self.applied_by_sender.get(rec.sender, 0) + 1
                replayed += 1
            self.wal.drop_after(target_seq)
        discarded = max(0, before_seq - self._apply_seq)
        self.rolled_back_updates += discarded
        self._restored = True
        # the rewound apply seqs may already stamp replies of other bytes:
        # the epoch bump keeps the delta plane from confusing them
        self.reset_pull_bases()
        _LOGGER.warning("rollback: restored apply seq %d (ckpt %d + %d WAL records), "
                        "DISCARDED %d applied update(s) past the good snapshot",
                        self._apply_seq, ckpt_seq, replayed, discarded)
        return discarded

    def _release_acks(self) -> None:
        ack = getattr(self.transport, "ack_delivered", None)
        if ack is not None:
            ack()

    def _acks_overdue(self) -> bool:
        overdue = getattr(self.transport, "acks_overdue", None)
        return overdue is not None and overdue()

    def commit(self) -> None:
        """Group commit: fsync the log's pending records, then release the
        delivery acks deferred behind them (log before ack: an acked push
        survives a crash)."""
        if self.wal is not None:
            rec = self.recorder
            had_pending = self.wal.pending > 0
            t0 = time.monotonic_ns() if rec is not None else 0
            self.wal.sync()
            if rec is not None and had_pending:
                # an empty group's commit is no fsync, and no span
                rec.record("wal-fsync", "wal", t0, time.monotonic_ns(), corr=0)
        self._release_acks()

    # ----------------------------------------------------------- serving

    def handle(self, sender: int, code: MessageCode, payload: np.ndarray) -> None:
        _LOGGER.info("Processing message: %s", MessageCode(code).name)
        self.message_counts[code] = self.message_counts.get(code, 0) + 1
        if code == MessageCode.GradientUpdate:
            self._apply_update(sender, payload)
        elif code == MessageCode.CompressedUpdate:
            # decoded first: the gate, the log and the apply see the delta
            try:
                _stamp, codec_id, delta = decode_update(payload)
            except CompressionError as e:
                self.dropped_bad_updates += 1
                _LOGGER.warning("dropping CompressedUpdate from %d: %s", sender, e)
                return
            self._apply_update(sender, delta, codec=codec_id)
        elif code == MessageCode.ParameterRequest:
            # a held stamp [epoch, ver_lo, ver_hi] opts into delta replies
            if payload.size >= 3 and np.isfinite(payload[:3]).all():
                self._reply_delta(sender, (int(payload[0]), _join16(payload[1], payload[2])))
            else:
                self._reply(sender, self.central)
            self.staleness.on_pull(sender)
            if self.combine == "adasum":
                # the worker now holds everything applied: its window restarts
                self._overlap[sender] = np.zeros_like(self.central)
        elif code == MessageCode.ParameterUpdate:
            if self._restored:
                # a fresh worker's install must not overwrite the restored
                # vector: answer with it (the worker installs it between
                # steps). Every later install is answered the same way.
                self.rejected_installs += 1
                _LOGGER.info("restored server: rejecting install #%d from worker %d, "
                             "answering with the restored params",
                             self.rejected_installs, sender)
                self._reply(sender, self.central)
            elif payload.shape != self.central.shape:
                self.dropped_bad_updates += 1
                _LOGGER.warning("dropping install from %d: %d params vs central %d",
                                sender, payload.size, self.central.size)
            else:
                self.central = payload.astype(np.float32).copy()

    def _apply_update(self, sender: int, payload: np.ndarray, codec: int = CODEC_DENSE) -> None:
        """Size gate, then the admission gate, then the accounting, damping
        or Adasum, the log (the combined delta, the optimizer's input, with
        ``codec``) and the apply, in that order: a push that fails a gate
        moves neither the clock nor the log."""
        if payload.shape != self.central.shape:
            # a record replay could never fit would refuse every restore,
            # and a size-1 payload would broadcast into the vector
            self.dropped_bad_updates += 1
            _LOGGER.warning("dropping update from %d: %d params vs central %d "
                            "(wrong model?)", sender, payload.size, self.central.size)
            return
        if self.admission is not None:
            verdict = self.admission.evaluate(sender, payload)
            if verdict is not None:
                self._quarantine_update(sender, verdict)
                return
        staleness = self.staleness.on_push(sender)
        if self.staleness_damping > 0.0 and staleness > 0:
            delta = (payload / (1.0 + self.staleness_damping * staleness)).astype(np.float32)
        elif self.combine == "adasum":
            delta = self._adasum_combine(sender, payload)
        else:
            delta = payload
        self._apply_seq += 1
        self.applied_by_sender[sender] = self.applied_by_sender.get(sender, 0) + 1
        rec = self.recorder
        if self.wal is not None:
            # log before apply: the combined delta is what replay must feed
            # the optimizer, and the envelope what restore seeds dedup with
            env_inc, env_seq = self._envelope or (0, 0)
            t0 = time.monotonic_ns() if rec is not None else 0
            self.wal.append(self._apply_seq, delta, sender=sender, env_inc=env_inc,
                            env_seq=env_seq, codec=codec)
            if rec is not None:
                rec.record("wal-append", "wal", t0, time.monotonic_ns(),
                           meta={"sender": sender, "seq": self._apply_seq})
            if env_inc or env_seq:
                self._recent_envelopes.append((sender, env_inc, env_seq))
        t0 = time.monotonic_ns() if rec is not None else 0
        applied = self._apply_delta(delta)
        if rec is not None:
            # the envelope's correlation id stitches push, log, apply and ack
            rec.record("apply", "apply", t0, time.monotonic_ns(),
                       meta={"sender": sender, "seq": self._apply_seq})
        if self.combine == "adasum":
            # what moved the parameters joins every other worker's window
            for other, o in self._overlap.items():
                if other != sender and o.shape == applied.shape:
                    o += applied
        self._push_count += 1
        if self.ckpt_dir and self.ckpt_every and self._push_count % self.ckpt_every == 0:
            self.save_checkpoint()

    def _apply_delta(self, delta: np.ndarray) -> np.ndarray:
        """Step the optimizer, if any, and add the result to the vector;
        returns what was added. The live path and WAL replay both come
        here, so the optimizer state cannot drift between them."""
        if self.optimizer is not None:
            delta = self.optimizer.step(delta)
        self.central += delta
        return delta

    def _adasum_combine(self, sender: int, payload: np.ndarray) -> np.ndarray:
        """Adasum against ``sender``'s overlap window; with no window (no
        pull since the mode came up) the push applies as it is."""
        o = self._overlap.get(sender)
        if o is None or o.shape != payload.shape:
            self._overlap.pop(sender, None)
            return payload
        return adasum_adjust(o, payload)

    def _quarantine_update(self, sender: int, verdict) -> None:
        """Count one rejected push and tell its worker with an
        ``UpdateNack`` frame ``[reason, norm, z]`` (clamped to finite
        float32); the push itself touches nothing."""
        reason, norm, z = verdict
        self.quarantined += 1
        self.quarantined_by_sender[sender] = self.quarantined_by_sender.get(sender, 0) + 1
        if self.recorder is not None:
            self.recorder.event("quarantine", sender=sender, reason=int(reason),
                                norm=clamp_finite32(norm), z=clamp_finite32(z))
        _LOGGER.warning("quarantined GradientUpdate #%d from worker %d: %s (norm %.3g, "
                        "z %.2f) — nacking", self.quarantined_by_sender[sender], sender,
                        NACK_REASONS.get(int(reason), reason), norm, z)
        frame = np.asarray([float(reason), clamp_finite32(norm), clamp_finite32(z)],
                           np.float32)
        try:
            send_message(MessageCode.UpdateNack, frame, dst=sender, transport=self.transport)
            self.nacks_sent += 1
        except (OSError, ConnectionError, KeyError):
            _LOGGER.warning("UpdateNack to worker %d failed (peer gone?) — the quarantine "
                            "stands; its next pull resyncs it anyway", sender)

    def _reply_delta(self, sender: int, held: Tuple[int, int]) -> None:
        """Answer a delta-opted pull with a ``DeltaParams`` frame: ``central -
        view`` on the top-k rung when this server tracks the worker's view at
        exactly the held ``(epoch, version)``, else a full dense install. The
        tracked view advances by this server's own encode and decode, so it
        stays equal to the worker's bit for bit and the next delta carries
        whatever this one could not represent. The frame is a fresh array: a
        reliable transport may resend it."""
        central = self.central
        ver = self._apply_seq
        epoch = self._pull_epoch
        base = self._pull_bases.get(sender)
        use_delta = base is not None and base[0] == held[0] == epoch and base[1] == held[1]
        if use_delta:
            cid, body = codecs.encode_body(MessageCode.DeltaParams, central - base[2],
                                           CODEC_TOPK)
            base_ver = base[1]
        else:
            cid, body = codecs.encode_body(MessageCode.DeltaParams, central, CODEC_DENSE)
            base_ver = 0
        decoded = codecs.decode_body(MessageCode.DeltaParams, cid, body, central.size)
        view = (base[2] + decoded) if use_delta else decoded
        self._pull_bases[sender] = (epoch, ver, view.astype(np.float32))
        n = int(central.size)
        head = np.asarray([float(cid), float(epoch), *_split16(base_ver), *_split16(ver),
                           *_split16(0), *_split16(n), *_split16(n), *_split16(body_crc(body))],
                          np.float32)
        if use_delta:
            self.delta_replies += 1
        else:
            self.full_replies += 1
        self.delta_reply_wire_floats += int(head.size) + int(body.size)
        try:
            send_message(MessageCode.DeltaParams, np.concatenate([head, body]), dst=sender,
                         transport=self.transport)
        except (OSError, ConnectionError, KeyError):
            # the base moved on: the worker's next held stamp misses it and
            # gets a full install
            _LOGGER.warning("delta reply to worker %d failed (peer gone?) — dropping it; "
                            "its next pull full-syncs via the held-stamp miss", sender)

    def _reply(self, sender: int, payload: np.ndarray) -> None:
        """Answer one worker; a worker gone between request and reply must
        not take the server down. A reliable transport keeps the frame's
        buffer until it is acked and the central vector moves in place, so
        it is sent a snapshot: a retransmit must carry the bytes its
        checksum covers. With :attr:`pull_reply_head` set the reply is the
        stamped ``ShardParams`` frame."""
        code = MessageCode.ParameterUpdate
        if self.pull_reply_head is not None:
            code = MessageCode.ShardParams
            payload = np.concatenate([self.pull_reply_head, payload])
        elif isinstance(self.transport, ReliableTransport):
            payload = payload.copy()
        try:
            send_message(code, payload, dst=sender, transport=self.transport)
        except (OSError, ConnectionError, KeyError):
            _LOGGER.warning("reply to worker %d failed (peer gone?) — dropping it", sender)

    def run(self, timeout: Optional[float] = None) -> None:
        """Serve until all workers finish (or ``stop()``/``timeout``). With
        ``worker_timeout``, a worker silent that long (heartbeats count) is
        declared failed and no longer waited for. The log is fsync'd as soon
        as the inbox is empty, after any frame that is not a push, and after
        :data:`WAL_GROUP_N` pushes or once a held ack is overdue (the
        reliable wire's ``acks_overdue``: it has waited a quarter of the timeout
        floor), so pushes that queue up share one fsync, no ack waits for
        traffic that is not there and none times out behind a slow apply;
        the last state is
        checkpointed on the way out. A transport whose rendezvous is still
        open (a reliable Python server's) is served as it goes on:
        the silence of a worker counts once every worker has connected, and
        a rendezvous past its deadline raises."""
        from distributed_ml_pytorch_tpu_torch.utils.failure import FailureDetector

        done_workers = set()
        detector = None
        rendezvous = getattr(self.transport, "rendezvous_done", None)
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._stop.is_set():
            if deadline is not None and time.monotonic() >= deadline:
                break
            if rendezvous is not None and rendezvous():
                rendezvous = None
            if (detector is None and rendezvous is None and self.worker_timeout
                    and self.n_workers is not None):
                detector = FailureDetector(self.worker_timeout,
                                           ranks=range(1, self.n_workers + 1))
            if detector is not None:
                for rank in sorted(detector.expired()):
                    print("parameter server: worker {} silent for {:.1f}s — "
                          "declaring it failed".format(rank, self.worker_timeout))
                self.failed_workers = set(detector.failed)
                if len(done_workers) + len(self.failed_workers) >= self.n_workers:
                    break
            # with logged pushes whose acks wait, only look for a frame that
            # is already there: an empty inbox closes the group at once
            held = self.wal is not None and self.wal.pending > 0
            msg = self.transport.recv(timeout=0.0 if held else 0.2)
            if msg is None:
                self.commit()
                continue
            sender, code, payload = msg
            self._envelope = getattr(self.transport, "last_delivery", None)
            if detector is not None:
                detector.note(sender)
                self.failed_workers = set(detector.failed)
            if code == MessageCode.Heartbeat:
                self.message_counts[code] += 1
                continue
            if code == MessageCode.WorkerDone:
                self.message_counts[code] += 1
                done_workers.add(sender)
                self.commit()
                if detector is not None:
                    detector.forget(sender)
                if self.n_workers is not None and (
                        len(done_workers) + len(self.failed_workers) >= self.n_workers):
                    break
                continue
            self.handle(sender, code, payload)
            if (self.wal is None or not _ack_waits_for_wal(code)
                    or self.wal.pending >= WAL_GROUP_N or self._acks_overdue()):
                # the group waits only for the codes whose ack the log holds;
                # everything else commits, and releases its ack, at once
                self.commit()
        self.save_checkpoint()
        self.commit()
        line = self.staleness.report()
        if line:
            print("parameter server:", line)


def _ack_waits_for_wal(code: MessageCode) -> bool:
    """Whether the ack of ``code`` waits for the WAL's group commit
    (``durability="wal_before_ack"`` in :data:`WIRE_SCHEMAS`)."""
    return code in LOGGED_BEFORE_ACK


def validate_downpour_args(lr: float, n_push: int, n_pull: int) -> None:
    if lr < 0.0:
        raise ValueError("Invalid learning rate: {}".format(lr))
    if int(n_push) < 1 or int(n_pull) < 1:
        raise ValueError("Invalid cadence: n_push={}, n_pull={} (both must be >= 1)"
                         .format(n_push, n_pull))


def init_downpour_accumulator(model: nn.Module):
    """``(flat_init, flat_n, pad, accum)``: the flat parameters (host), their
    count, the pad up to a multiple of ``LANES`` (the JAX package's length),
    and a zero accumulator of ``flat_n + pad`` on the model's device."""
    flat = ravel_model_params(model).cpu().numpy()
    n = int(flat.shape[0])
    pad = (-n) % LANES
    device = next(model.parameters()).device
    return flat, n, pad, torch.zeros(n + pad, dtype=torch.float32, device=device)


def default_downpour_tx(lr: float):
    """The reference worker recipe: plain SGD, no momentum."""
    from distributed_ml_pytorch_tpu_torch.training.trainer import SGD

    return SGD(lr)


def _downpour_micro_update(tx, model: nn.Module, opt_state, accum: torch.Tensor,
                           scratch: torch.Tensor, flat_n: int) -> torch.Tensor:
    """THE DownPour per-step device math: the local optimizer turns the
    gradients in ``p.grad`` into updates, the flat updates accumulate into
    ``accum`` through the ``flat_axpy`` kernel (``accum += 1.0·updates``, in
    place), and the same updates apply to the parameters. ``scratch`` is the
    padded flat-update buffer; its tail past ``flat_n`` stays zero."""
    names, params = zip(*model.named_parameters())
    updates = tx.update([p.grad for p in params], opt_state, list(params))
    ravel_tensors(model, dict(zip(names, updates)), out=scratch[:flat_n])
    flat_axpy(accum, scratch, 1.0)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)
    return accum


def make_downpour_device_step(model: nn.Module, tx, flat_n: int, pad: int):
    """``step(opt_state, accum) -> accum``: :func:`_downpour_micro_update`
    with its padded scratch buffer allocated once."""
    device = next(model.parameters()).device
    scratch = torch.zeros(flat_n + pad, dtype=torch.float32, device=device)

    def _device_step(opt_state, accum):
        return _downpour_micro_update(tx, model, opt_state, accum, scratch, flat_n)

    return _device_step


def downpour_chunk_schedule(n_push: int, n_pull: int, start: int, stop: int,
                            max_chunk: int = 64):
    """Dispatch schedule for steps ``[start, stop)``: the runs of purely
    local SGD between host-communication gaps, as the JAX package's.

    A gap sits between steps ``t − 1`` and ``t`` when a pull opens step
    ``t`` (``t % n_pull == 0``) or a push closed step ``t − 1`` (``(t − 1)
    % n_push == 0``: the +1 offset, since a push fires after its step).
    Returns ``[(gap, length), …]`` with global gap indices and lengths
    summing to ``stop − start``, each at most ``max_chunk`` (an extra cut is
    a boundary with nothing to do). With ``n_push = n_pull = 10`` the runs
    alternate between 1 and 9 steps.
    """
    gaps = {start, stop}
    gaps |= {t for t in range(start, stop) if t % n_pull == 0}
    gaps |= {t + 1 for t in range(start, stop) if t % n_push == 0}
    cuts = sorted(g for g in gaps if start <= g <= stop)
    out = []
    for a, b in zip(cuts, cuts[1:]):
        while b - a > max_chunk:
            out.append((a, max_chunk))
            a += max_chunk
        if b > a:
            out.append((a, b - a))
    return out


def make_downpour_chunk_step(model: nn.Module, tx, accum: torch.Tensor, flat_n: int,
                             capacity: int = 0):
    """A whole run of local DownPour steps a dispatch: ``chunk(opt_state,
    images [L, B, ...], labels [L, B], generator=None) -> losses [L]`` (a
    device tensor), each step exactly :func:`make_downpour_device_step`'s
    after ``loss_and_grads``: the parameters, ``opt_state`` and ``accum``
    advance in place.

    On the card the step is captured once as a CUDA graph and replayed once
    per batch (``training.trainer.GraphedSteps``, its buffers sized for
    ``capacity`` steps: one capture serves every run length up to it), so
    the relu→pool kernels and ``flat_axpy`` run inside the graph; the
    wrappers count the warm-up and capture launches, not the replays. The
    accumulator is bound here and must stay this one tensor: a graph writes
    to the address it was captured with. A capture or replay that fails
    raises; nothing falls back to eager steps. On the CPU the same step
    runs in a loop."""
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        dispatch_steps,
        loss_and_grads,
    )

    scratch = torch.zeros_like(accum)
    dispatch = dispatch_steps(accum.device, capacity)

    def chunk(opt_state, images, labels, generator=None) -> torch.Tensor:
        def body(x, y, g):
            loss = loss_and_grads(model, x, y, generator=g)
            _downpour_micro_update(tx, model, opt_state, accum, scratch, flat_n)
            return loss

        return dispatch(body, images, labels, generator, owner=opt_state)

    chunk.graphed = dispatch.graphed
    return chunk


class Listener(MessageListener):
    """Receives the server's ParameterUpdate replies and deposits the newest
    in a mailbox for the optimizer to install between steps; counts the
    server's ``UpdateNack`` frames for the optimizer to resync on.

    It also installs ``DeltaParams`` replies: it keeps the worker's view of
    the central vector and the ``(epoch, version)`` stamp it sits at, which
    the next delta-opted pull carries (:meth:`held_stamp`). A full install
    replaces the view; a delta applies only onto the view at its stamped
    base, and is otherwise dropped and counted in ``delta_base_miss``.

    An elastic server's ``ShardParams`` reply deposits its vector with its
    ``(version, lo, hi)`` stamp (:meth:`take_latest_versioned`); ``replies``
    counts the pull replies of every kind that arrived."""

    def __init__(self, transport: Optional[Transport] = None):
        super().__init__(transport=transport)
        self._lock = threading.Lock()
        self._latest: Optional[np.ndarray] = None
        #: (version, lo, hi) of the newest reply; None for an unstamped one
        self._latest_stamp: Optional[Tuple[int, int, int]] = None
        self._got_update = threading.Event()
        self.replies = 0
        #: nacks received in all, and those the optimizer has not taken
        #: yet (one batch taken triggers one resync pull)
        self.nacks = 0
        self._nacks_pending = 0
        self._view: Optional[np.ndarray] = None
        self._held: Optional[Tuple[int, int]] = None
        self.delta_base_miss = 0
        self.delta_installs = 0
        self.full_installs = 0

    def held_stamp(self) -> np.ndarray:
        """A delta-opted pull's payload ``[epoch, ver_lo, ver_hi]``; epoch -1
        (no view held) asks for a full install."""
        with self._lock:
            if self._held is None or self._view is None:
                return np.asarray([-1.0, 0.0, 0.0], np.float32)
            epoch, ver = self._held
            return np.asarray([float(epoch), *_split16(ver)], np.float32)

    def _on_delta_params(self, parameter: np.ndarray) -> None:
        # head: codec epoch base(2) ver(2) lo(2) hi(2) n(2) crc(2) = 14
        if parameter.size < 15 or not np.isfinite(parameter[:14]).all():
            return  # malformed: dropped
        cid = int(parameter[0])
        epoch = int(parameter[1])
        base_ver = _join16(parameter[2], parameter[3])
        ver = _join16(parameter[4], parameter[5])
        lo = _join16(parameter[6], parameter[7])
        hi = _join16(parameter[8], parameter[9])
        n = _join16(parameter[10], parameter[11])
        crc = _join16(parameter[12], parameter[13])
        body = parameter[14:]
        # the range and the checksum before paying for a decode
        if hi - lo != n or body_crc(body) != crc:
            return
        try:
            decoded = codecs.decode_body(MessageCode.DeltaParams, cid, body, n)
        except CompressionError:
            return
        with self._lock:
            if cid == CODEC_DENSE:
                self._view = decoded
                self._held = (epoch, ver)
                self.full_installs += 1
            else:
                if not (self._view is not None and self._view.size == n
                        and self._held == (epoch, base_ver)):
                    # a delta against a base this worker does not hold: the
                    # next pull's stamp asks for a full install
                    self.delta_base_miss += 1
                    return
                self._view = (self._view + decoded).astype(np.float32)
                self._held = (epoch, ver)
                self.delta_installs += 1
            self._latest = self._view
            self._latest_stamp = None
        self._got_update.set()

    def receive(self, sender: int, message_code: MessageCode, parameter: np.ndarray) -> None:
        if message_code in (MessageCode.DeltaParams, MessageCode.ParameterUpdate,
                            MessageCode.ShardParams):
            with self._lock:
                self.replies += 1
        if message_code == MessageCode.DeltaParams:
            self._on_delta_params(parameter)
        elif message_code == MessageCode.ParameterUpdate:
            with self._lock:
                self._latest = parameter
                self._latest_stamp = None
            self._got_update.set()
        elif message_code == MessageCode.ShardParams:
            if parameter.size < 7 or not np.isfinite(parameter[:6]).all():
                return  # malformed: dropped
            with self._lock:
                self._latest = parameter[6:]
                self._latest_stamp = (_join16(parameter[0], parameter[1]),
                                      _join16(parameter[2], parameter[3]),
                                      _join16(parameter[4], parameter[5]))
            self._got_update.set()
        elif message_code == MessageCode.UpdateNack:
            if parameter.size >= 3 and np.isfinite(parameter[:1]).all():
                with self._lock:
                    self.nacks += 1
                    self._nacks_pending += 1

    def take_latest(self) -> Optional[np.ndarray]:
        return self.take_latest_versioned()[1]

    def take_latest_versioned(self) -> Tuple[Optional[Tuple[int, int, int]],
                                             Optional[np.ndarray]]:
        """The newest reply with its ``(version, lo, hi)`` stamp (None for
        an unstamped ``ParameterUpdate``)."""
        with self._lock:
            latest, self._latest = self._latest, None
            stamp, self._latest_stamp = self._latest_stamp, None
        return stamp, latest

    def take_nacks(self) -> int:
        """The nacks not taken since the last call."""
        with self._lock:
            n, self._nacks_pending = self._nacks_pending, 0
            return n

    def wait_for_update(self, timeout: float) -> bool:
        """Block until a ParameterUpdate has arrived (it may have been taken
        since); False on timeout."""
        return self._got_update.wait(timeout)


class PushFlusher:
    """Background push pipeline: the cadence boundary hands this thread a
    snapshot of the accumulator (and, on the card, an event recorded after
    the snapshot was queued), and the thread copies it to the host and
    sends it while the training thread runs the next steps. FIFO (one
    thread, one queue), so pushes arrive in cadence order; at most
    ``MAX_IN_FLIGHT`` pushes wait, beyond which :meth:`enqueue` blocks
    (backpressure)."""

    MAX_IN_FLIGHT = 2

    def __init__(self, send_fn):
        self._send_fn = send_fn  # called with the host np.ndarray
        self._q: "queue.Queue" = queue.Queue(maxsize=self.MAX_IN_FLIGHT)
        self._stream = None
        self._thread = threading.Thread(target=self._run, name="downpour-push-flusher",
                                        daemon=True)
        self._thread.start()

    def _fetch(self, snap: torch.Tensor, ready) -> np.ndarray:
        # every push gets a buffer of its own (the snapshot, or a fresh
        # pinned one): a reliable transport holds the sent buffer until the
        # frame is acked and retransmits those bytes, which must still be
        # the ones its checksum covers
        if ready is None:
            return snap.numpy()
        # the snapshot was queued on the training thread's stream: this
        # thread's own stream waits for its event, so the copy can never
        # read it half-written, and only this stream is synchronized, so
        # the copy overlaps the steps queued after the snapshot
        if self._stream is None:
            self._stream = torch.cuda.Stream(snap.device)
        host = torch.empty(snap.shape, dtype=snap.dtype, pin_memory=True)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            host.copy_(snap, non_blocking=True)
        self._stream.synchronize()
        return host.numpy()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self._send_fn(self._fetch(*item))
            except Exception as e:  # noqa: BLE001 — the thread must survive
                # a failed copy/send loses THIS push (accepted async
                # staleness); a dead thread would deadlock drain()
                print(f"push flusher: dropping one push after {type(e).__name__}: {e}",
                      file=sys.stderr)
            finally:
                self._q.task_done()

    def enqueue(self, snap: torch.Tensor, ready: Optional[torch.cuda.Event] = None) -> None:
        """Hand over ``snap``, which nothing else writes again; ``ready``
        (CUDA tensors) is an event recorded after its last write."""
        self._q.put((snap, ready))

    def drain(self) -> None:
        """Block until every enqueued push has been copied and sent."""
        self._q.join()

    def stop(self) -> None:
        self.drain()
        self._q.put(None)
        self._thread.join(timeout=10)


#: the seconds a revoked worker's finish waits for its last acks, over all
#: its links together
REVOKED_FLUSH_S = 1.0


class DownpourClient:
    """What the DownPour clients share, over one server link
    (:class:`Asynchronous`) or one per shard (``sharded_ps.
    ShardedAsynchronous``): the set-up, the accumulator and its push, the
    nack resync and its hold, the per-step cadence and the finish.

    A subclass sends on link ``s`` with its own degrade policy
    (:meth:`_send_link`), installs what has arrived (:meth:`_install_arrived`,
    adding each link it installed to ``_fresh_installed`` during a hold) and
    says whether a link is down (:meth:`_link_down`) and what to call it;
    :meth:`finish` stops the heartbeat senders in ``_owned_heartbeats``.
    """

    def _setup(self, model: nn.Module, lr: float, n_push: int, n_pull: int, tx,
               transports, compress: Optional[str] = None,
               compress_opts: Optional[dict] = None) -> torch.Tensor:
        """The state both clients start from; returns the flat parameters.
        Each link's listener attaches before anything is sent, so no reply
        can race it. With ``compress`` (``"int8"`` or ``"topk"``, options
        ``compress_opts``) pushes go out as ``CompressedUpdate`` frames of
        one error-feedback encoder over the whole flat vector, which only
        the push thread touches."""
        validate_downpour_args(lr, n_push, n_pull)
        self.model = model
        self.lr = float(lr)
        self.n_push = int(n_push)
        self.n_pull = int(n_pull)
        self.transports = list(transports)
        self.idx = 0
        self._unravel = make_unraveler(model)
        self.tx = tx if tx is not None else default_downpour_tx(self.lr)
        self.opt_state = self.tx.init(list(model.parameters()))
        flat, self._flat_n, self._pad, self.accum = init_downpour_accumulator(model)
        #: nacks taken so far; each batch sends one resync pull to every link
        self.nacks = 0
        self._hold_updates = False
        #: the links installed since the hold began
        self._fresh_installed: set = set()
        self.skipped_updates = 0
        #: nonfinite losses passed to step()
        self.bad_losses = 0
        self._device_step = make_downpour_device_step(model, self.tx, self._flat_n,
                                                      self._pad)
        self.encoder = None
        if compress:
            self.encoder = CompressingEncoder(
                self._flat_n, make_codec(compress, **(compress_opts or {})))
        self.listeners = [Listener(transport=t) for t in self.transports]
        for listener in self.listeners:
            listener.start()
        return flat

    def _send_link(self, link: int, code: MessageCode, payload) -> None:
        raise NotImplementedError

    def _link_down(self, link: int) -> bool:
        raise NotImplementedError

    def _link_name(self, link: int) -> str:
        raise NotImplementedError

    def _install_arrived(self) -> None:
        raise NotImplementedError

    def _at_boundary(self) -> None:
        """Host work of a step boundary after the nack resync, before its
        installs: the elastic client's cutover."""

    def _pull_payload(self, link: int) -> np.ndarray:
        """A pull's payload on ``link``: empty, a full pull."""
        return np.zeros(0, np.float32)

    def _pull_all(self) -> None:
        for link in range(len(self.transports)):
            self._send_link(link, MessageCode.ParameterRequest, self._pull_payload(link))

    def _push(self) -> None:
        """Snapshot the accumulator's first ``flat_n`` floats for the
        flusher and zero the accumulator in place, both on the current
        stream; on the card an event recorded after the snapshot orders the
        flusher's copy behind it."""
        snap = self.accum[: self._flat_n].clone()
        ready = None
        if snap.is_cuda:
            ready = torch.cuda.Event()
            ready.record()
        self.accum.zero_()
        self._flusher.enqueue(snap, ready)

    def _resync_on_nacks(self) -> None:
        """A quarantined push means this worker may be diverging from the
        central parameters it can no longer move: pull every link now, not
        at the cadence, and hold the per-step updates until each has
        installed (an install stomped by updates from the diverged state
        would never converge). One pull per batch of nacks."""
        got = 0
        for link, listener in enumerate(self.listeners):
            n = listener.take_nacks()
            if n:
                got += n
                print(f"worker: {n} push(es) quarantined by {self._link_name(link)}'s "
                      "admission gate — resyncing with a fresh pull", file=sys.stderr)
        if got:
            self.nacks += got
            self._hold_updates = True
            self._fresh_installed = set()
            self._pull_all()

    def step(self, loss=None) -> None:
        """One DownPour step, after ``loss.backward()``. A nonfinite
        ``loss`` (when given) skips the update: its gradients would poison
        even freshly pulled parameters; the next install heals the worker."""
        bad_loss = loss is not None and not math.isfinite(float(loss))
        if bad_loss:
            self.bad_losses += 1
        self._resync_on_nacks()
        self._at_boundary()
        # decided before this step's installs: even on the step that
        # completes the resync, the gradients in hand predate the installs
        held = self._hold_updates
        self._install_arrived()
        if held and self._fresh_installed >= set(range(len(self.listeners))):
            self._hold_updates = False  # updates resume next step
            self._fresh_installed = set()
        if self.idx % self.n_pull == 0:
            self._pull_all()
        if held or bad_loss:
            self.skipped_updates += 1
        else:
            self._device_step(self.opt_state, self.accum)
        if self.idx % self.n_push == 0:
            self._push()
        self.idx += 1

    def finish(self) -> None:
        """Push what is left (behind every earlier push, through the push
        thread, which alone touches the encoder's residual), notify every
        server, stop the threads. Over a reliable transport every pending
        frame of a live link is flushed first: the layer guarantees
        delivery, not order, and a retried push landing after
        ``WorkerDone`` could find the server gone.

        A worker whose lease the coordinator revoked (its ``coord`` client
        says ``revoked``) is no longer counted among the live workers, so
        the shards may leave without taking its last pushes: its flushes
        share one budget of ``REVOKED_FLUSH_S`` instead of 10 s a link. An
        unacked push stays unacked; nothing is counted as applied."""
        self._push()
        self._flusher.drain()
        coord = getattr(self, "coord", None)
        revoked_by = (time.monotonic() + REVOKED_FLUSH_S
                      if coord is not None and getattr(coord, "revoked", False) else None)
        for link, t in enumerate(self.transports):
            flush = getattr(t, "flush", None)
            if flush is not None and not self._link_down(link):
                flush(timeout=10.0 if revoked_by is None
                      else max(0.0, revoked_by - time.monotonic()))
            self._send_link(link, MessageCode.WorkerDone, np.zeros(0, np.float32))
        self._flusher.stop()
        for hb in self._owned_heartbeats:
            hb.stop()
        for listener in self.listeners:
            listener.stop()


class Asynchronous(DownpourClient):
    """DownPour-SGD client optimizer (reference ``Asynchronous.py:20-71``).

    Used like a torch optimizer: after ``loss.backward()``, ``opt.step()``
    installs the newest pulled parameters (if any), requests a pull every
    ``n_pull`` steps, applies the local update while accumulating it, and
    pushes the accumulator every ``n_push`` steps — both on step index 0
    too, as the reference's ``idx % n == 0`` tests do. The gradients in use
    at a step were computed before that step's install, as in the JAX
    package. The chunked path calls :meth:`boundary` between runs of steps
    instead (:func:`make_downpour_chunk_step`).

    The accumulator ``accum`` is one tensor for the optimizer's life (a
    captured graph writes to its address): a push snapshots it and zeroes
    it in place. With ``rejoin`` the worker adopts the server's central
    vector (a pull, awaited up to ``install_timeout`` seconds) instead of
    installing its own. A nack from the server's admission gate triggers a
    resync pull, and the per-step path then skips its updates until the
    pulled vector is installed.

    ``compress``/``compress_opts`` compress the pushes, with error feedback
    (:meth:`DownpourClient._setup`); with ``delta_pull`` every pull carries
    the listener's held stamp and the server answers with ``DeltaParams``
    frames.
    """

    def __init__(self, model: nn.Module, lr: float, n_push: int, n_pull: int, *,
                 tx=None, transport: Optional[Transport] = None, heartbeat=None,
                 rejoin: bool = False, install_timeout: float = 5.0,
                 compress: Optional[str] = None, compress_opts: Optional[dict] = None,
                 delta_pull: bool = False):
        self.delta_pull = bool(delta_pull)
        flat = self._setup(model, lr, n_push, n_pull, tx, [transport], compress,
                           compress_opts)
        self.transport = transport
        self.listener = self.listeners[0]
        if rejoin:
            send_message(MessageCode.ParameterRequest, self._pull_payload(0),
                         transport=transport)
            if not self.listener.wait_for_update(timeout=install_timeout):
                print("worker: rejoin pull unanswered after {:.1f}s — starting from local "
                      "init (server slow or down)".format(install_timeout), file=sys.stderr)
        else:
            # install this worker's initial params as the central params (:34)
            send_message(MessageCode.ParameterUpdate, flat, transport=transport)
        self.server_down = False
        self.heartbeat = heartbeat
        self._owned_heartbeats = [heartbeat] if heartbeat is not None else []
        self._chunk_step = None
        self._flusher = PushFlusher(self._send_push)

    def _send_push(self, arr: np.ndarray) -> None:
        """One push toward the server (on the push thread): a dense
        ``GradientUpdate``, or one ``CompressedUpdate`` of ``[0, flat_n)``
        whose fresh head and body leave through ``sendv``."""
        if self.encoder is None:
            self._send(MessageCode.GradientUpdate, arr)
            return
        head, body = self.encoder.encode_range(arr, 0, self._flat_n)
        self._sendv(MessageCode.CompressedUpdate, (head, body))

    def _guarded_send(self, do_send) -> None:
        """A dead server degrades the worker to purely-local SGD with one
        warning instead of crashing mid-epoch."""
        if self.server_down:
            return
        if self.heartbeat is not None and self.heartbeat.peer_down:
            self.server_down = True
        else:
            try:
                do_send()
                return
            except (OSError, ConnectionError):
                self.server_down = True
        print("worker: parameter server unreachable — continuing with purely-local "
              "SGD (no further push/pull)", file=sys.stderr)

    def _send(self, code: MessageCode, payload) -> None:
        """Send toward the server, under the degrade guard."""
        self._guarded_send(lambda: send_message(code, payload, transport=self.transport))

    def _sendv(self, code: MessageCode, parts) -> None:
        """A frame of several parts toward the server, under the degrade
        guard."""
        self._guarded_send(lambda: self.transport.sendv(code, parts))

    def _pull_payload(self, link: int) -> np.ndarray:
        if self.delta_pull:
            return self.listener.held_stamp()
        return np.zeros(0, np.float32)

    def _send_link(self, link: int, code: MessageCode, payload) -> None:
        self._send(code, payload)

    def _link_down(self, link: int) -> bool:
        return self.server_down

    def _link_name(self, link: int) -> str:
        return "the server"

    def install(self, flat: np.ndarray) -> None:
        """Copy a central vector into the model, in place (between steps)."""
        device = self.accum.device
        unravel_model_params(self.model, torch.from_numpy(flat).to(device),
                             unravel=self._unravel)

    def _install_arrived(self) -> None:
        latest = self.listener.take_latest()
        if latest is not None:
            self.install(latest)
            if self._hold_updates:
                self._fresh_installed.add(0)

    def boundary(self, gap: int) -> Optional[np.ndarray]:
        """The host communication at gap ``gap`` (between steps ``gap − 1``
        and ``gap``), the chunked path's counterpart of :meth:`step`'s, in
        its order: the push owed by step ``gap − 1``, then the newest
        install and the pull owed by step ``gap``. Returns the installed
        vector, or ``None``. The install also ends a post-nack hold: a
        chunk's updates cannot be skipped from here, so the install is the
        resync."""
        if gap >= 1 and (gap - 1) % self.n_push == 0:
            self._push()
        self._resync_on_nacks()
        latest = self.listener.take_latest()
        if latest is not None:
            self.install(latest)
            self._hold_updates = False
            self._fresh_installed = set()
        if gap % self.n_pull == 0:
            self._pull_all()
        self.idx = gap
        return latest


# the same optimizer under its original DownPour name
DownpourSGD = Asynchronous


def _chunk_step_cache(opt: Asynchronous, max_chunk: int):
    """One chunk step per optimizer (every run length shares its graph)."""
    if opt._chunk_step is None:
        opt._chunk_step = make_downpour_chunk_step(opt.model, opt.tx, opt.accum,
                                                   opt._flat_n, capacity=max_chunk)
    return opt._chunk_step


def train_worker(args, transport: Transport, heartbeat=None, device="cuda",
                 opt_factory=None) -> Tuple[nn.Module, "MetricsLogger"]:
    """Worker-side training loop (reference ``main(args)`` distributed
    branch): an eval every ``log_interval`` steps and at each epoch end.
    Sets full float32 (no TF32) for the run.

    ``--chunked-dispatch`` (``auto``: on for a CUDA device or
    ``--steps-per-dispatch`` > 1) runs each run of local steps between
    communication gaps as one dispatch (:func:`make_downpour_chunk_step`, at
    most ``--steps-per-dispatch`` steps when that is above 1, else 64); the
    per-step losses stay on the device until an eval, every
    :data:`LOSS_FLUSH_DISPATCHES` dispatches and the end of the epoch, and every step that crosses an eval interval
    gets a record carrying the evaluation at its chunk's end, so the CSV has
    the per-step path's rows. ``off`` runs one step a dispatch.

    ``--compress``/``--compress-block``/``--compress-topk`` compress the
    default optimizer's pushes (``utils/compress.compress_from_args``).

    ``opt_factory(model, tx) -> optimizer`` replaces the default
    :class:`Asynchronous` (the sharded worker's
    ``parallel/sharded_ps.ShardedAsynchronous``). Only an optimizer with
    ``boundary`` runs chunked, as in the JAX package: any other runs one
    step a dispatch whatever ``--chunked-dispatch`` says.

    ``--profile-dir`` traces the worker-global steps ``[--profile-start,
    + --profile-steps)`` (``utils/tracing.TraceWindow``; a chunk that
    strides over the window is traced whole)."""
    from distributed_ml_pytorch_tpu_torch.data import get_dataset, iterate_batches
    from distributed_ml_pytorch_tpu_torch.device import full_float32, resolve_device
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.training.trainer import (
        evaluate,
        loss_and_grads,
        make_eval_fn,
        to_device,
        tx_from_args,
    )
    from distributed_ml_pytorch_tpu_torch.utils.compress import compress_from_args
    from distributed_ml_pytorch_tpu_torch.utils.metrics import MetricsLogger, print_eval_line
    from distributed_ml_pytorch_tpu_torch.utils.tracing import TraceWindow

    dev = resolve_device(device)
    full_float32()
    x_train, y_train, x_test, y_test = get_dataset(args)
    seed = getattr(args, "seed", 0)
    # AlexNet's relu→pool tails run the relu_pool2 kernel: same numerics
    model = get_model(getattr(args, "model", "alexnet"), fused_epilogue=True,
                      seed=seed, device=dev)
    # the full optimizer surface of the CLI, its schedule in local updates
    steps_per_epoch = len(x_train) // args.batch_size
    tx = tx_from_args(args, steps_per_epoch)
    if opt_factory is not None:
        opt = opt_factory(model, tx)
    else:
        opt = Asynchronous(model, lr=args.lr, n_push=args.num_push, n_pull=args.num_pull,
                           tx=tx, transport=transport, heartbeat=heartbeat,
                           rejoin=getattr(args, "rejoin", False), **compress_from_args(args))
    gen = torch.Generator(device=dev).manual_seed(seed + 1 + transport.rank)
    eval_step = make_eval_fn(model)
    logger = MetricsLogger(getattr(args, "log_dir", "runs"))
    spd = int(getattr(args, "steps_per_dispatch", 1) or 1)
    mode = getattr(args, "chunked_dispatch", "auto")
    chunked = (dev.type == "cuda" or spd > 1) if mode == "auto" else mode == "on"
    chunked = chunked and hasattr(opt, "boundary")
    max_chunk = spd if spd > 1 else 64
    # in worker-global steps, the CSV's numbering
    tracer = TraceWindow(getattr(args, "profile_dir", None),
                         start=getattr(args, "profile_start", 10),
                         n_steps=getattr(args, "profile_steps", 10))
    for epoch in range(args.epochs):
        print("Training for epoch {}".format(epoch))
        batches = iterate_batches(x_train, y_train, args.batch_size,
                                  seed=seed + 1000 * transport.rank, epoch=epoch)
        if chunked:
            chunk_step = _chunk_step_cache(opt, max_chunk)
            start = epoch * steps_per_epoch
            pending = []  # (first step, device losses, eval steps, eval)

            def flush():
                for rel0, dev_losses, eval_is, ev in pending:
                    for off, loss in enumerate(dev_losses.cpu().tolist()):
                        i = rel0 + off
                        extra = ({"test_loss": ev[0], "test_accuracy": ev[1]}
                                 if ev is not None and i in eval_is else {})
                        rec = logger.log_step(i, loss, **extra)
                        if extra:
                            print_eval_line(rec)
                pending.clear()

            for gap, length in downpour_chunk_schedule(opt.n_push, opt.n_pull, start,
                                                       start + steps_per_epoch,
                                                       max_chunk=max_chunk):
                opt.boundary(gap)
                pairs = [next(batches) for _ in range(length)]
                tracer.on_step(gap, n_steps=length)
                losses = chunk_step(opt.opt_state, np.stack([p[0] for p in pairs]),
                                    np.stack([p[1] for p in pairs]), gen)
                opt.idx = gap + length
                tracer.after_step(gap + length)
                rel0 = gap - start
                eval_is = {i for i in range(rel0, rel0 + length)
                           if i % args.log_interval == 0 and i > 0}
                ev = (evaluate(eval_step, x_test, y_test, args.test_batch_size, dev)
                      if eval_is else None)
                pending.append((rel0, losses, eval_is, ev))
                if ev is not None or len(pending) >= LOSS_FLUSH_DISPATCHES:
                    flush()
            flush()
        else:
            for i, (bx, by) in enumerate(batches):
                tracer.on_step(opt.idx)
                loss = loss_and_grads(model, *to_device(bx, by, dev), generator=gen)
                opt.step()
                loss = float(loss)  # waits for the step
                tracer.after_step(opt.idx)
                extra = {}
                if i % args.log_interval == 0 and i > 0:
                    test_loss, test_acc = evaluate(eval_step, x_test, y_test,
                                                   args.test_batch_size, dev)
                    extra = {"test_loss": test_loss, "test_accuracy": test_acc}
                rec = logger.log_step(i, loss, **extra)
                if extra:
                    print_eval_line(rec)
        # a window across the epoch's end stops here, before the eval
        tracer.close()
        evaluate(eval_step, x_test, y_test, args.test_batch_size, dev, verbose=True)
    tracer.close()
    tracer.warn_if_never_opened()
    opt.finish()
    return model, logger


def make_server(args) -> ParameterServer:
    """The server of ``args`` before it has a transport: the central vector
    starts from the seeded model, built on the host — the server never
    touches the card. ``--ckpt-dir``/``--ckpt-every``, ``--wal``,
    ``--admission*``, ``--staleness-damping``, ``--combine`` and
    ``--server-opt``/``--server-lr``/``--server-momentum`` configure its
    planes."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.optplane import optimizer_from_args
    from distributed_ml_pytorch_tpu_torch.utils.serialization import flat_size

    model = get_model(getattr(args, "model", "alexnet"), seed=getattr(args, "seed", 0),
                      device="cpu")
    return ParameterServer(model, n_workers=args.world_size - 1,
                           worker_timeout=getattr(args, "worker_timeout", 0.0) or None,
                           ckpt_dir=getattr(args, "ckpt_dir", "") or None,
                           ckpt_every=getattr(args, "ckpt_every", 500),
                           staleness_damping=getattr(args, "staleness_damping", 0.0),
                           wal=getattr(args, "wal", False),
                           admission=admission_from_args(args),
                           combine=getattr(args, "combine", "add") or "add",
                           optimizer=optimizer_from_args(args, flat_size(model)))


def run_server(args, transport: Transport,
               server: Optional[ParameterServer] = None) -> ParameterServer:
    """Server-side entry (reference ``init_server``): ``server`` (by default
    :func:`make_server`'s) serves over ``transport``, first restoring its
    state with ``--resume``."""
    server = server if server is not None else make_server(args)
    server.transport = transport
    if getattr(args, "resume", False) and server.maybe_restore():
        print("parameter server: resumed central params from", server._ckpt_path())
    server.run()
    if server.failed_workers:
        print("parameter server: finished with failed workers: {}".format(
            sorted(server.failed_workers)))
    return server


def run_ps_process(args) -> int:
    """CLI entry for one PS-world process (rank 0 = server, 1+ = workers)."""
    from distributed_ml_pytorch_tpu_torch.utils.messaging import make_transport

    if args.rank is None:
        raise SystemExit("--rank is required for distributed --mode ps runs")
    is_server = args.server or args.rank == SERVER_RANK
    # the server is built before it listens: a worker's first frames must
    # not wait out the server's start-up for their acks
    server = make_server(args) if is_server else None
    transport = make_transport(
        args.rank, args.world_size, args.master, int(args.port),
        kind=getattr(args, "transport", "auto"), reliable=getattr(args, "reliable", False),
        # --wal's log-before-ack: the server defers its acks to the WAL's
        # group commit; workers ack on delivery
        durable_acks=is_server and getattr(args, "wal", False))
    heartbeat = None
    try:
        if is_server:
            run_server(args, transport, server)
            if not server.failed_workers:
                print("parameter server: all workers done")
        else:
            if args.heartbeat_interval > 0:
                from distributed_ml_pytorch_tpu_torch.utils.failure import HeartbeatSender

                heartbeat = HeartbeatSender(transport, interval=args.heartbeat_interval)
                heartbeat.start()
            _model, logger = train_worker(args, transport, heartbeat=heartbeat,
                                          device=args.backend)
            print("wrote", logger.to_csv("node{}.csv".format(args.rank)))
            print("Finished Training")
    finally:
        if heartbeat is not None:
            heartbeat.stop()
        transport.close()
    return 0
