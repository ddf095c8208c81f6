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

Not in this package yet (the JAX server's other planes): rollback, Adasum,
the sharded server-side optimizer, delta pulls and compressed pushes.
"""

from __future__ import annotations

import collections
import io
import json
import logging
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
from distributed_ml_pytorch_tpu_torch.utils.durability import atomic_write
from distributed_ml_pytorch_tpu_torch.utils.failure import StalenessAuditor
from distributed_ml_pytorch_tpu_torch.utils.health import (
    NACK_REASONS,
    admission_from_args,
    clamp_finite32,
)
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    SERVER_RANK,
    WIRE_SCHEMAS,
    MessageCode,
    MessageListener,
    ReliableTransport,
    Transport,
    _next_incarnation,
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
                 admission=None):
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
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    # ------------------------------------------------------- durability

    def _ckpt_path(self) -> str:
        return os.path.join(self.ckpt_dir, "ps_central.npy")

    def _meta_path(self) -> str:
        return os.path.join(self.ckpt_dir, "ps_meta.json")

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
            restored = True
        if self.wal is not None:
            restored = bool(self._replay_wal()) or restored
        if restored:
            self._restored = True
        return restored

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
            self.central += rec.payload
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

    def _release_acks(self) -> None:
        ack = getattr(self.transport, "ack_delivered", None)
        if ack is not None:
            ack()

    def commit(self) -> None:
        """Group commit: fsync the log's pending records, then release the
        delivery acks deferred behind them (log before ack: an acked push
        survives a crash)."""
        if self.wal is not None:
            self.wal.sync()
        self._release_acks()

    # ----------------------------------------------------------- serving

    def handle(self, sender: int, code: MessageCode, payload: np.ndarray) -> None:
        _LOGGER.info("Processing message: %s", MessageCode(code).name)
        self.message_counts[code] = self.message_counts.get(code, 0) + 1
        if code == MessageCode.GradientUpdate:
            self._apply_update(sender, payload)
        elif code == MessageCode.ParameterRequest:
            self._reply(sender, self.central)
            self.staleness.on_pull(sender)
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

    def _apply_update(self, sender: int, payload: np.ndarray) -> None:
        """Size gate, then the admission gate, then the accounting, the
        damping, the log and the apply, in that order: a push that fails a
        gate moves neither the clock nor the log."""
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
        else:
            delta = payload
        self._apply_seq += 1
        self.applied_by_sender[sender] = self.applied_by_sender.get(sender, 0) + 1
        if self.wal is not None:
            # log before apply: the damped delta is what replay must add,
            # and the envelope what restore seeds dedup with
            env_inc, env_seq = self._envelope or (0, 0)
            self.wal.append(self._apply_seq, delta, sender=sender, env_inc=env_inc,
                            env_seq=env_seq)
            if env_inc or env_seq:
                self._recent_envelopes.append((sender, env_inc, env_seq))
        self.central += delta
        self._push_count += 1
        if self.ckpt_dir and self.ckpt_every and self._push_count % self.ckpt_every == 0:
            self.save_checkpoint()

    def _quarantine_update(self, sender: int, verdict) -> None:
        """Count one rejected push and tell its worker with an
        ``UpdateNack`` frame ``[reason, norm, z]`` (clamped to finite
        float32); the push itself touches nothing."""
        reason, norm, z = verdict
        self.quarantined += 1
        self.quarantined_by_sender[sender] = self.quarantined_by_sender.get(sender, 0) + 1
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

    def _reply(self, sender: int, payload: np.ndarray) -> None:
        """Answer one worker; a worker gone between request and reply must
        not take the server down. A reliable transport keeps the frame's
        buffer until it is acked and the central vector moves in place, so
        it is sent a snapshot: a retransmit must carry the bytes its
        checksum covers."""
        if isinstance(self.transport, ReliableTransport):
            payload = payload.copy()
        try:
            send_message(MessageCode.ParameterUpdate, payload, dst=sender,
                         transport=self.transport)
        except (OSError, ConnectionError, KeyError):
            _LOGGER.warning("reply to worker %d failed (peer gone?) — dropping it", sender)

    def run(self, timeout: Optional[float] = None) -> None:
        """Serve until all workers finish (or ``stop()``/``timeout``). With
        ``worker_timeout``, a worker silent that long (heartbeats count) is
        declared failed and no longer waited for. The log is fsync'd when
        the inbox is idle, after any frame that is not a push, and after
        :data:`WAL_GROUP_N` pushes; the last state is checkpointed on the way
        out."""
        done_workers = set()
        detector = None
        if self.worker_timeout and self.n_workers is not None:
            from distributed_ml_pytorch_tpu_torch.utils.failure import FailureDetector

            detector = FailureDetector(self.worker_timeout,
                                       ranks=range(1, self.n_workers + 1))
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._stop.is_set():
            if deadline is not None and time.monotonic() >= deadline:
                break
            if detector is not None:
                for rank in sorted(detector.expired()):
                    print("parameter server: worker {} silent for {:.1f}s — "
                          "declaring it failed".format(rank, self.worker_timeout))
                self.failed_workers = set(detector.failed)
                if len(done_workers) + len(self.failed_workers) >= self.n_workers:
                    break
            msg = self.transport.recv(timeout=0.2)
            if msg is None:
                # idle: close the WAL group, so no ack waits longer than
                # one receive timeout
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
                    or self.wal.pending >= WAL_GROUP_N):
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
    schema = WIRE_SCHEMAS.get(code)
    return schema is not None and schema.durability == "wal_before_ack"


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
    server's ``UpdateNack`` frames for the optimizer to resync on."""

    def __init__(self, transport: Optional[Transport] = None):
        super().__init__(transport=transport)
        self._lock = threading.Lock()
        self._latest: Optional[np.ndarray] = None
        self._got_update = threading.Event()
        #: nacks received in all, and those the optimizer has not taken
        #: yet (one batch taken triggers one resync pull)
        self.nacks = 0
        self._nacks_pending = 0

    def receive(self, sender: int, message_code: MessageCode, parameter: np.ndarray) -> None:
        if message_code == MessageCode.ParameterUpdate:
            with self._lock:
                self._latest = parameter
            self._got_update.set()
        elif message_code == MessageCode.UpdateNack:
            if parameter.size >= 3 and np.isfinite(parameter[:1]).all():
                with self._lock:
                    self.nacks += 1
                    self._nacks_pending += 1

    def take_latest(self) -> Optional[np.ndarray]:
        with self._lock:
            latest, self._latest = self._latest, None
        return latest

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


class Asynchronous:
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
    """

    def __init__(self, model: nn.Module, lr: float, n_push: int, n_pull: int, *,
                 tx=None, transport: Optional[Transport] = None, heartbeat=None,
                 rejoin: bool = False, install_timeout: float = 5.0):
        validate_downpour_args(lr, n_push, n_pull)
        self.model = model
        self.lr = float(lr)
        self.n_push = int(n_push)
        self.n_pull = int(n_pull)
        self.transport = transport
        self.idx = 0
        self._unravel = make_unraveler(model)
        self.tx = tx if tx is not None else default_downpour_tx(self.lr)
        self.opt_state = self.tx.init(list(model.parameters()))
        flat, self._flat_n, self._pad, self.accum = init_downpour_accumulator(model)
        # attach the listener before anything is sent, so no reply can race it
        self.listener = Listener(transport=transport)
        self.listener.start()
        if rejoin:
            send_message(MessageCode.ParameterRequest, np.zeros(0, np.float32),
                         transport=transport)
            if not self.listener.wait_for_update(timeout=install_timeout):
                print("worker: rejoin pull unanswered after {:.1f}s — starting from local "
                      "init (server slow or down)".format(install_timeout), file=sys.stderr)
        else:
            # install this worker's initial params as the central params (:34)
            send_message(MessageCode.ParameterUpdate, flat, transport=transport)
        self.server_down = False
        self.heartbeat = heartbeat
        #: nacks taken so far; each batch sends one resync pull
        self.nacks = 0
        self._hold_updates = False
        self.skipped_updates = 0
        self._device_step = make_downpour_device_step(model, self.tx, self._flat_n,
                                                      self._pad)
        self._chunk_step = None
        self._flusher = PushFlusher(
            lambda arr: self._send(MessageCode.GradientUpdate, arr))

    def _send(self, code: MessageCode, payload) -> None:
        """Send toward the server; a dead server degrades the worker to
        purely-local SGD with one warning instead of crashing mid-epoch."""
        if self.server_down:
            return
        if self.heartbeat is not None and self.heartbeat.peer_down:
            self.server_down = True
        else:
            try:
                send_message(code, payload, transport=self.transport)
                return
            except (OSError, ConnectionError):
                self.server_down = True
        print("worker: parameter server unreachable — continuing with purely-local "
              "SGD (no further push/pull)", file=sys.stderr)

    def install(self, flat: np.ndarray) -> None:
        """Copy a central vector into the model, in place (between steps)."""
        device = self.accum.device
        unravel_model_params(self.model, torch.from_numpy(flat).to(device),
                             unravel=self._unravel)

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
        central vector it can no longer move: pull now, not at the cadence,
        and hold the per-step updates until the pull is installed. One pull
        per batch of nacks."""
        n = self.listener.take_nacks()
        if n:
            self.nacks += n
            self._hold_updates = True
            print(f"worker: {n} push(es) quarantined by the server's admission gate — "
                  "resyncing with a fresh pull", file=sys.stderr)
            self._send(MessageCode.ParameterRequest, np.zeros(0, np.float32))

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
        if gap % self.n_pull == 0:
            self._send(MessageCode.ParameterRequest, np.zeros(0, np.float32))
        self.idx = gap
        return latest

    def step(self) -> None:
        self._resync_on_nacks()
        # decided before this step's install: even on the step that
        # completes the resync, the gradients in hand predate the install
        held = self._hold_updates
        latest = self.listener.take_latest()
        if latest is not None:
            self.install(latest)
            if held:
                self._hold_updates = False  # updates resume next step
        if self.idx % self.n_pull == 0:
            self._send(MessageCode.ParameterRequest, np.zeros(0, np.float32))
        if held:
            self.skipped_updates += 1
        else:
            self._device_step(self.opt_state, self.accum)
        if self.idx % self.n_push == 0:
            self._push()
        self.idx += 1

    def finish(self) -> None:
        """Push what is left (behind every earlier push), notify the server,
        stop the threads. Over a reliable transport every pending frame is
        flushed first: the layer guarantees delivery, not order, and a
        retried push landing after ``WorkerDone`` could find the server
        gone."""
        self._push()
        self._flusher.drain()
        flush = getattr(self.transport, "flush", None)
        if flush is not None and not self.server_down:
            flush(timeout=10.0)
        self._send(MessageCode.WorkerDone, np.zeros(0, np.float32))
        self._flusher.stop()
        if self.heartbeat is not None:
            self.heartbeat.stop()
        self.listener.stop()


# the same optimizer under its original DownPour name
DownpourSGD = Asynchronous


def _chunk_step_cache(opt: Asynchronous, max_chunk: int):
    """One chunk step per optimizer (every run length shares its graph)."""
    if opt._chunk_step is None:
        opt._chunk_step = make_downpour_chunk_step(opt.model, opt.tx, opt.accum,
                                                   opt._flat_n, capacity=max_chunk)
    return opt._chunk_step


def train_worker(args, transport: Transport, heartbeat=None,
                 device="cuda") -> Tuple[nn.Module, "MetricsLogger"]:
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
    the per-step path's rows. ``off`` runs one step a dispatch."""
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
    from distributed_ml_pytorch_tpu_torch.utils.metrics import MetricsLogger, print_eval_line

    dev = resolve_device(device)
    full_float32()
    x_train, y_train, x_test, y_test = get_dataset(args)
    seed = getattr(args, "seed", 0)
    # AlexNet's relu→pool tails run the relu_pool2 kernel: same numerics
    model = get_model(getattr(args, "model", "alexnet"), fused_epilogue=True,
                      seed=seed, device=dev)
    # the full optimizer surface of the CLI, its schedule in local updates
    steps_per_epoch = len(x_train) // args.batch_size
    opt = Asynchronous(model, lr=args.lr, n_push=args.num_push, n_pull=args.num_pull,
                       tx=tx_from_args(args, steps_per_epoch), transport=transport,
                       heartbeat=heartbeat, rejoin=getattr(args, "rejoin", False))
    gen = torch.Generator(device=dev).manual_seed(seed + 1 + transport.rank)
    eval_step = make_eval_fn(model)
    logger = MetricsLogger(getattr(args, "log_dir", "runs"))
    spd = int(getattr(args, "steps_per_dispatch", 1) or 1)
    mode = getattr(args, "chunked_dispatch", "auto")
    chunked = (dev.type == "cuda" or spd > 1) if mode == "auto" else mode == "on"
    max_chunk = spd if spd > 1 else 64
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
                losses = chunk_step(opt.opt_state, np.stack([p[0] for p in pairs]),
                                    np.stack([p[1] for p in pairs]), gen)
                opt.idx = gap + length
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
                loss = loss_and_grads(model, *to_device(bx, by, dev), generator=gen)
                opt.step()
                extra = {}
                if i % args.log_interval == 0 and i > 0:
                    test_loss, test_acc = evaluate(eval_step, x_test, y_test,
                                                   args.test_batch_size, dev)
                    extra = {"test_loss": test_loss, "test_accuracy": test_acc}
                rec = logger.log_step(i, float(loss), **extra)
                if extra:
                    print_eval_line(rec)
        evaluate(eval_step, x_test, y_test, args.test_batch_size, dev, verbose=True)
    opt.finish()
    return model, logger


def run_server(args, transport: Transport) -> ParameterServer:
    """Server-side entry (reference ``init_server``): the central vector
    starts from the seeded model, built on the host — the server never
    touches the card. ``--ckpt-dir``/``--ckpt-every``/``--resume``,
    ``--wal``, ``--admission*`` and ``--staleness-damping`` configure its
    planes."""
    from distributed_ml_pytorch_tpu_torch.models import get_model

    model = get_model(getattr(args, "model", "alexnet"), seed=getattr(args, "seed", 0),
                      device="cpu")
    server = ParameterServer(model, transport=transport, n_workers=args.world_size - 1,
                             worker_timeout=getattr(args, "worker_timeout", 0.0) or None,
                             ckpt_dir=getattr(args, "ckpt_dir", "") or None,
                             ckpt_every=getattr(args, "ckpt_every", 500),
                             staleness_damping=getattr(args, "staleness_damping", 0.0),
                             wal=getattr(args, "wal", False),
                             admission=admission_from_args(args))
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
    transport = make_transport(
        args.rank, args.world_size, args.master, int(args.port),
        kind=getattr(args, "transport", "auto"), reliable=getattr(args, "reliable", False),
        # --wal's log-before-ack: the server defers its acks to the WAL's
        # group commit; workers ack on delivery
        durable_acks=is_server and getattr(args, "wal", False))
    heartbeat = None
    try:
        if is_server:
            server = run_server(args, transport)
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
