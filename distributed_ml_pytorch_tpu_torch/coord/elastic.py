"""The elastic shard server (counterpart of the JAX ``coord/elastic.py``):
a parameter server whose range the coordinator assigns.

:class:`ElasticShardServer` wraps a plain
:class:`~distributed_ml_pytorch_tpu_torch.parallel.async_ps.ParameterServer`:

- it joins the coordination star as a ``shard`` member (which triggers the
  rebalance that gives it a range) and renews its lease with its push count;
- on a newer shard map it resizes, as the map arrives (on the client's
  listener thread, so no frame a worker sent under the new map finds the
  server still on the old one): the overlap of the old and the new range
  keeps its values, the rest is seeded from ``init_params``, and a freshly
  acquired subrange waits for a worker's ``RangeInstall`` (the first install
  wins; pulls are parked until then, so no worker adopts values the server
  never held); under a WAL it checkpoints first, so no log record straddles
  a resize, and its optimizer follows the range;
- stale-map traffic is dropped and counted, never applied: pushes and pull
  replies carry the sender's map version and the absolute range they were
  cut for (``ShardPush``, the stamped ``CompressedUpdate``, ``ShardParams``),
  and the range is the gate, checked before a compressed frame is decoded;
  an unstamped ``GradientUpdate`` is dropped;
- a ``SpeculativeUpdate`` (a backup task's result) applies once per task
  id: the victim's late copy is counted and dropped;
- the snapshot and rollback barriers reach it through two mailboxes: the
  client's listener parks the request, and the serve loop takes it between
  applied updates, under the serve lock. A snapshot commits the WAL group,
  checkpoints and reports (a request for a map version the server has left
  still checkpoints, but reports the server's own version, so the
  coordinator refuses the mixed barrier); a rollback restores this range
  to the manifest at ``manifest_path`` in place
  (``ParameterServer.rollback_restore``) and reports, and a manifest of
  another version or range is a loud no-op. A parked rollback supersedes a
  parked snapshot;
- the scheduler's preempt reaches it through a third mailbox (the newest
  grant wins, a redelivery parks once): the serve loop commits the open WAL
  group, so every acked push is durable, reports ``PreemptDone`` and stops
  serving without a checkpoint or a ``CoordLeave``. A parked life keeps its
  rank, range and membership; the frames left in its inbox are not served
  (they are unacked, and the resumed life takes their retransmissions),
  and its renewals stop;
- :meth:`ElasticShardServer.restore_from_manifest` is the disaster
  recovery: a fresh server installs its range from the manifest and
  restores checkpoint and WAL, and refuses loudly rather than serve zeros
  or a clock behind the manifest's promise.

A :meth:`~ElasticShardServer.crash` is not a stop: the serve loop exits at
once and serves, checkpoints, acks and reports nothing more.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

import numpy as np

from distributed_ml_pytorch_tpu_torch.coord.manifest import FleetManifest, ManifestError
from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient
from distributed_ml_pytorch_tpu_torch.coord.shardmap import ShardMap
from distributed_ml_pytorch_tpu_torch.parallel.async_ps import (
    WAL_GROUP_N,
    ParameterServer,
    _ack_waits_for_wal,
)
from distributed_ml_pytorch_tpu_torch.utils.chaos import gray_injector
from distributed_ml_pytorch_tpu_torch.utils.compress import HEAD_LEN, peek_stamp
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    MessageCode,
    Transport,
    _join16,
    _split16,
)


class ElasticShardServer:
    """A ParameterServer whose range follows the coordinator's shard map.

    ``server_id`` is its rank in the coordinator's world, ``n_params`` the
    whole flat vector's length; ``init_params`` (the whole vector) seeds
    every range it is given. ``staleness_damping``, ``ckpt_dir``,
    ``ckpt_every``, ``wal``, ``admission`` and ``combine`` configure the
    wrapped server, whose WAL group closes at ``wal_group_n`` pending
    pushes; ``optimizer`` (an ``optplane.ShardedOptimizer``) is resized with
    the range on every change; ``manifest_path`` is where the coordinator
    publishes its fleet manifest, which a rollback restores."""

    def __init__(self, server_id: int, n_params: int, transport: Transport,
                 coord: CoordClient, *, init_params: Optional[np.ndarray] = None,
                 staleness_damping: float = 0.0, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 500, wal: bool = False, wal_group_n: int = WAL_GROUP_N,
                 admission=None, manifest_path: Optional[str] = None,
                 combine: str = "add", optimizer=None):
        self.server_id = int(server_id)
        self.n_params = int(n_params)
        self.transport = transport
        self.coord = coord
        self._init_flat = (np.asarray(init_params, np.float32)
                           if init_params is not None else None)
        if self._init_flat is not None and self._init_flat.shape[0] != n_params:
            raise ValueError(f"init_params has {self._init_flat.shape[0]} params, "
                             f"expected {n_params}")
        self.lo = self.hi = 0
        self.map_version = -1
        #: the absolute [lo, hi) awaiting a worker's RangeInstall; pulls are
        #: parked while it is set
        self.pending_install: Optional[tuple] = None
        self.ps = ParameterServer(params=np.zeros(1, np.float32), transport=transport,
                                  ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                                  staleness_damping=staleness_damping, wal=wal,
                                  admission=admission, combine=combine)
        if optimizer is not None:
            # attached after construction: the range is the coordinator's
            optimizer.resize(self.lo, self.hi)
            self.ps.optimizer = optimizer
        self.wal_group_n = int(wal_group_n)
        self.manifest_path = manifest_path
        self._seen_tasks: set = set()
        #: the barrier mailboxes: the client's listener parks a request, the
        #: serve loop takes it between applied updates (newest wins)
        self._box_mu = threading.Lock()
        self._snap_req: Optional[tuple] = None
        self._roll_req: Optional[int] = None
        self._preempt_req: Optional[tuple] = None
        #: set once this life parked under a preempt
        self.parked = False
        if getattr(coord, "on_snapshot", None) is None:
            coord.on_snapshot = self._note_snapshot
        if getattr(coord, "on_rollback", None) is None:
            coord.on_rollback = self._note_rollback
        if getattr(coord, "on_preempt", None) is None:
            coord.on_preempt = self._note_preempt
        self.stats = {"stale_dropped": 0, "parked_pulls": 0, "installs": 0,
                      "dup_installs": 0, "spec_applied": 0, "spec_dropped": 0,
                      "resizes": 0, "rollbacks": 0, "rolled_back_updates": 0}
        #: guards the served state (range, central vector, stats): the serve
        #: loop resizes and applies on its thread while others read
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._crashed = False
        #: a FaultyTransport under this transport, if any: its gray stall
        #: rules slow the serve loop and the WAL commit, and the renewals
        #: carry the evidence
        self._gray = gray_injector(transport)
        self._fsync_spans: list = []
        self._busy_s = 0.0
        self._win_start = 0.0
        self._gray_report_at = 0.0
        self._wire_base = (0, 0, 0.0)
        if getattr(coord, "on_shard_map", None) is None and hasattr(coord, "on_shard_map"):
            coord.on_shard_map = self._apply_map

    def crash(self) -> None:
        """Die silently: the serve loop exits, renewals stop, and no
        ``CoordLeave`` is sent, so the coordinator must find the death by
        lease expiry. A clean shutdown is :meth:`stop`."""
        self._crashed = True
        self.coord.stop()
        self._stop.set()

    # ------------------------------------------------------------------ map
    def _apply_map(self, m: ShardMap) -> None:
        with self._mu:
            if m.version <= self.map_version or self._stop.is_set():
                # a stopped or crashed server resizes and checkpoints no
                # more: a map reaching its listener after the serve loop
                # ended must not write its directory
                return
            self.map_version = m.version
            try:
                self._apply_entry(m)
            finally:
                # every way out re-stamps, an unchanged range too
                self._restamp_reply_head()

    def _restamp_reply_head(self) -> None:
        """Pull replies go out as ``ShardParams`` stamped with the map
        version and the range served; the delta bases are fenced too."""
        self.ps.pull_reply_head = np.asarray(
            [*_split16(max(0, self.map_version)), *_split16(self.lo), *_split16(self.hi)],
            np.float32)
        self.ps.reset_pull_bases()

    def _apply_entry(self, m: ShardMap) -> None:
        e = m.entry_for(self.server_id)
        if e is None:
            # dropped from the map while alive: keep serving; the join retry
            # or the renewals add it back
            print(f"shard {self.server_id}: not in map v{m.version} — keeping current range",
                  file=sys.stderr)
            return
        if (e.lo, e.hi) == (self.lo, self.hi):
            return
        if self.ps.wal is not None and self.hi > self.lo:
            # log records are sized for the range they were applied under:
            # checkpoint (which truncates the log) before the resize
            self.ps.save_checkpoint()
        new_central = np.zeros(e.size, np.float32)
        if self._init_flat is not None:
            new_central[:] = self._init_flat[e.lo:e.hi]
        o_lo, o_hi = max(self.lo, e.lo), min(self.hi, e.hi)
        if o_lo < o_hi and self.hi > self.lo:
            new_central[o_lo - e.lo:o_hi - e.lo] = self.ps.central[o_lo - self.lo:o_hi - self.lo]
        fresh = (e.fresh_lo, e.fresh_hi) if e.needs_install else None
        if fresh is not None and self._init_flat is not None and self.lo == self.hi:
            # a seeded server's first range: the seed is what the workers'
            # construction installs refine, nothing to wait for
            fresh = None
        self.pending_install = fresh
        print(f"shard {self.server_id}: map v{m.version} resize [{self.lo},{self.hi}) -> "
              f"[{e.lo},{e.hi})"
              + (f", awaiting install of [{fresh[0]},{fresh[1]})" if fresh else ""),
              file=sys.stderr)
        self.lo, self.hi = e.lo, e.hi
        self.ps.central = new_central
        if self.ps.optimizer is not None:
            self.ps.optimizer.resize(e.lo, e.hi)
        self.stats["resizes"] += 1

    # ------------------------------------------------------------ barriers
    def _note_snapshot(self, snapshot_id: int, map_version: int) -> None:
        """The client's callback: park the snapshot request for the serve
        loop (a re-request replaces it)."""
        with self._box_mu:
            self._snap_req = (int(snapshot_id), int(map_version))

    def _note_rollback(self, rollback_id: int, phase: int) -> None:
        """The client's callback: park a rollback's start for the serve loop
        (its end needs nothing here: this server restored and reported, or
        refused)."""
        if phase != 0:
            return
        with self._box_mu:
            self._roll_req = int(rollback_id)

    def _take_requests(self):
        """Both mailboxes at once: ``(snapshot, rollback)``. A parked
        rollback supersedes a parked snapshot, which would checkpoint the
        state being discarded at an apply seq past the rollback's target."""
        with self._box_mu:
            snap, roll = self._snap_req, self._roll_req
            self._snap_req = self._roll_req = None
        return (None, roll) if roll is not None else (snap, None)

    def _do_snapshot(self, snapshot_id: int, map_version: int) -> None:
        """The shard's half of the snapshot barrier: commit the WAL group,
        checkpoint, report. A request under another map version still
        checkpoints but reports this server's version."""
        with self._mu:
            if map_version != self.map_version:
                print(f"shard {self.server_id}: snapshot {snapshot_id} asks map "
                      f"v{map_version} but this server serves v{self.map_version} — "
                      "reporting the truth", file=sys.stderr)
            self.ps.commit()
            self.ps.save_checkpoint()
            mv, lo, hi = self.map_version, self.lo, self.hi
            apply_seq, push_count = self.ps._apply_seq, self.ps._push_count
        self.coord.snapshot_done(snapshot_id, mv, lo, hi, apply_seq, push_count)

    def _do_rollback(self, rollback_id: int) -> None:
        """The shard's half of the rollback barrier: restore this range to
        the last good manifest in place and report. A missing or unusable
        manifest, or one of another map version or range, is a loud no-op:
        the coordinator's timeout abandons a barrier this server cannot
        honour."""
        if not self.manifest_path or not os.path.exists(self.manifest_path):
            print(f"shard {self.server_id}: rollback {rollback_id} refused — no manifest at "
                  f"{self.manifest_path!r}", file=sys.stderr)
            return
        try:
            manifest = FleetManifest.load(self.manifest_path)
            entry = manifest.entry_for(self.server_id)
        except ManifestError as e:
            print(f"shard {self.server_id}: rollback {rollback_id} refused — manifest "
                  f"unusable: {e}", file=sys.stderr)
            return
        with self._mu:
            if (manifest.map_version != self.map_version
                    or (entry.lo, entry.hi) != (self.lo, self.hi)):
                print(f"shard {self.server_id}: rollback {rollback_id} refused — manifest is "
                      f"map v{manifest.map_version} [{entry.lo},{entry.hi}), this server "
                      f"serves v{self.map_version} [{self.lo},{self.hi})", file=sys.stderr)
                return
            try:
                discarded = self.ps.rollback_restore(entry.apply_seq)
            except (ValueError, OSError) as e:
                print(f"shard {self.server_id}: rollback {rollback_id} FAILED: {e}",
                      file=sys.stderr)
                return
            self.stats["rollbacks"] += 1
            self.stats["rolled_back_updates"] += discarded
            # authoritative, like a manifest restore: a stale RangeInstall
            # must not stomp it
            self.pending_install = None
            mv, lo, hi, apply_seq = self.map_version, self.lo, self.hi, self.ps._apply_seq
        print(f"shard {self.server_id}: rolled back [{lo},{hi}) to snapshot "
              f"{manifest.snapshot_id} (apply seq {apply_seq}, {discarded} update(s) "
              "discarded)", file=sys.stderr)
        self.coord.rollback_done(rollback_id, mv, lo, hi, apply_seq)

    def _note_preempt(self, grant_id: int, snapshot_id: int) -> None:
        """The client's callback: park the scheduler's preempt for the serve
        loop (the newest grant wins; a redelivery of the same grant parks
        once, since the loop stops at the first)."""
        with self._box_mu:
            self._preempt_req = (int(grant_id), int(snapshot_id))

    def _take_preempt_request(self) -> Optional[tuple]:
        with self._box_mu:
            req, self._preempt_req = self._preempt_req, None
            return req

    def _do_park(self, grant_id: int, snapshot_id: int) -> None:
        """The member's half of a preempt: commit the open WAL group (every
        acked push is then durable, so the parked state is the manifest's
        checkpoint plus an exactly-once replay away), report
        ``PreemptDone`` and stop serving. No checkpoint: the log's tail past
        the barrier is the replay the resume proves. No ``CoordLeave``: a
        parked life keeps its rank and range, and the scheduler exempts its
        lease."""
        with self._mu:
            self.ps.commit()
            lo, hi, apply_seq = self.lo, self.hi, self.ps._apply_seq
        self.coord.preempt_done(grant_id, snapshot_id, lo, hi, apply_seq)
        self.parked = True
        self._stop.set()
        print(f"shard {self.server_id}: PARKED [{lo},{hi}) at apply seq {apply_seq} under "
              f"snapshot {snapshot_id} (grant {grant_id})", file=sys.stderr)

    def restore_from_manifest(self, manifest) -> None:
        """Disaster recovery: install this shard's range from the manifest's
        map, then restore checkpoint and WAL. Refuses loudly (a
        :class:`~.manifest.ManifestError`) when the manifest is invalid,
        mixed or incomplete or omits this server, when nothing restorable
        is on disk, and when the restored apply seq is behind the one the
        manifest promises."""
        manifest.validate()
        entry = manifest.entry_for(self.server_id)
        with self._mu:
            self.lo, self.hi = entry.lo, entry.hi
            self.map_version = manifest.map_version
            central = np.zeros(entry.hi - entry.lo, np.float32)
            if self._init_flat is not None:
                central[:] = self._init_flat[entry.lo:entry.hi]
            self.ps.central = central
            if self.ps.optimizer is not None:
                # sized to the manifest's range before the restore loads
                # the state it checks against that size
                self.ps.optimizer.resize(entry.lo, entry.hi)
            if not self.ps.maybe_restore():
                raise ManifestError(
                    f"shard {self.server_id}: manifest promises a checkpoint for "
                    f"[{entry.lo},{entry.hi}) but nothing restorable exists under "
                    f"{self.ps.ckpt_dir!r}")
            if self.ps._apply_seq < entry.apply_seq:
                raise ManifestError(
                    f"shard {self.server_id}: restored apply seq {self.ps._apply_seq} is "
                    f"BEHIND the manifest's {entry.apply_seq} — checkpoint/WAL lost acked "
                    "state")
            self.pending_install = None
            self._restamp_reply_head()
        print(f"shard {self.server_id}: restored [{entry.lo},{entry.hi}) at apply seq "
              f"{self.ps._apply_seq} ({self.ps.replayed_updates} WAL record(s) replayed)",
              file=sys.stderr)

    # --------------------------------------------------------------- handle
    def handle(self, sender: int, code: MessageCode, payload: np.ndarray,
               envelope: Optional[tuple] = None) -> None:
        with self._mu:
            self.ps._envelope = envelope
            self._handle_locked(sender, code, payload)

    def _handle_locked(self, sender: int, code: MessageCode, payload: np.ndarray) -> None:
        size = self.hi - self.lo
        if code == MessageCode.ShardPush and payload.size >= 7:
            # the range is the gate: a slice cut for other offsets never
            # applies, whatever its size; a version bump that left the range
            # in place stays compatible
            lo = _join16(payload[2], payload[3])
            hi = _join16(payload[4], payload[5])
            values = payload[6:]
            if (lo, hi) != (self.lo, self.hi) or values.shape[0] != size:
                self.stats["stale_dropped"] += 1
                return
            self.ps.handle(sender, MessageCode.GradientUpdate, values)
            self.coord.report(self.ps._push_count, 0, 0.0)
        elif code == MessageCode.CompressedUpdate and payload.size >= HEAD_LEN + 1:
            # the same gate on the stamp, before paying for a decode; an
            # unstamped compressed push is dropped like a GradientUpdate
            stamp = peek_stamp(payload)
            if stamp is None or (stamp[1], stamp[2]) != (self.lo, self.hi):
                self.stats["stale_dropped"] += 1
                return
            self.ps.handle(sender, MessageCode.CompressedUpdate, payload)
            self.coord.report(self.ps._push_count, 0, 0.0)
        elif code in (MessageCode.CompressedUpdate, MessageCode.GradientUpdate):
            # truncated, or a sender without the stamp: never applied
            self.stats["stale_dropped"] += 1
        elif code == MessageCode.ParameterRequest:
            if self.pending_install is not None:
                # a reply now would hand out values this server never held;
                # the worker's next pull after the install is answered
                self.stats["parked_pulls"] += 1
                return
            self.ps.handle(sender, code, payload)
        elif code == MessageCode.ParameterUpdate:
            if payload.shape[0] != size:
                self.stats["stale_dropped"] += 1
                return
            self.ps.handle(sender, code, payload)
            if self.pending_install is not None:
                # a whole-range install covers any pending subrange
                self.pending_install = None
                self.stats["installs"] += 1
        elif code == MessageCode.RangeInstall and payload.size >= 4:
            lo = _join16(payload[0], payload[1])
            hi = _join16(payload[2], payload[3])
            values = payload[4:]
            if values.shape[0] != hi - lo:
                self.stats["stale_dropped"] += 1
                return
            if self.pending_install is None or (lo, hi) != self.pending_install:
                self.stats["dup_installs"] += 1  # the first install won already
                return
            self.ps.central[lo - self.lo:hi - self.lo] = values
            self.pending_install = None
            self.stats["installs"] += 1
            print(f"shard {self.server_id}: range [{lo},{hi}) installed by worker {sender}",
                  file=sys.stderr)
        elif code == MessageCode.SpeculativeUpdate and payload.size >= 8:
            task_id = _join16(payload[0], payload[1])
            lo = _join16(payload[4], payload[5])
            hi = _join16(payload[6], payload[7])
            values = payload[8:]
            if (lo, hi) != (self.lo, self.hi) or values.shape[0] != size:
                self.stats["stale_dropped"] += 1
                return
            if task_id in self._seen_tasks:
                # the race's loser: the dedup that makes a backup task safe
                self.stats["spec_dropped"] += 1
                return
            self._seen_tasks.add(task_id)
            self.ps.handle(sender, MessageCode.GradientUpdate, values)
            self.stats["spec_applied"] += 1

    # ----------------------------------------------------------------- gray
    def _commit_timed(self) -> None:
        """Close the open WAL group, an injected fsync stall inside the
        measured span."""
        t0 = time.monotonic()
        if self._gray is not None:
            d = self._gray.gray_stall("fsync")
            if d > 0.0:
                time.sleep(d)
        with self._mu:
            self.ps.commit()
        span = time.monotonic() - t0
        self._fsync_spans.append(span)
        if len(self._fsync_spans) > 64:
            del self._fsync_spans[:-64]
        self._busy_s += span

    def _report_gray(self, now: float) -> None:
        """Fold the wire's retransmit and blocked-send deltas, the fsync p95
        and the serve loop's busy ratio over the last window into the next
        renewal."""
        if now < self._gray_report_at:
            return
        wall = now - self._win_start if self._win_start else 0.0
        self._gray_report_at = now + 0.25
        self._win_start = now
        st = getattr(self.transport, "stats", None)
        retrans = blocked = 0.0
        if isinstance(st, dict):
            sent = int(st.get("sent", 0))
            retries = int(st.get("retries", 0))
            blk = float(st.get("window_blocked_s", 0.0))
            b_sent, b_retries, b_blk = self._wire_base
            retrans = (retries - b_retries) / max(1, sent - b_sent)
            blocked = max(0.0, blk - b_blk)
            self._wire_base = (sent, retries, blk)
        spans = sorted(self._fsync_spans)
        p95_ms = spans[int(0.95 * (len(spans) - 1))] * 1000.0 if spans else 0.0
        busy = min(1.0, self._busy_s / wall) if wall > 0.05 else 0.0
        self._busy_s = 0.0
        report = getattr(self.coord, "report_gray_health", None)
        if report is not None:
            report(retrans_rate=retrans, blocked_s=blocked, fsync_p95_ms=p95_ms,
                   busy_ratio=busy)

    # ------------------------------------------------------------------ run
    def stop(self) -> None:
        self._stop.set()

    def _serve_one(self, msg) -> None:
        sender, code, payload = msg
        envelope = getattr(self.transport, "last_delivery", None)
        if code in (MessageCode.Heartbeat, MessageCode.WorkerDone):
            # worker lifecycle is the coordinator's here, but an enveloped
            # WorkerDone still owes its deferred ack
            self._commit_timed()
            return
        t0 = time.monotonic()
        try:
            self.handle(sender, code, payload, envelope)
        except (ValueError, IndexError, OverflowError):
            return  # a malformed frame: drop it, never die
        finally:
            self._busy_s += time.monotonic() - t0
        if self.ps.wal is None or not _ack_waits_for_wal(code) \
                or self.ps.wal.pending >= self.wal_group_n:
            self._commit_timed()

    def run(self, timeout: Optional[float] = None) -> None:
        """Join, then serve until :meth:`stop`, a park, the fleet's workers
        are done or ``timeout``. Unless it crashed or parked, the server then
        serves the frames already taken in before it checkpoints and leaves:
        a reliable wire may have acked them, and a worker's final push is
        among them."""
        m = self.coord.join()
        if m is not None:
            self._apply_map(m)
        deadline = None if timeout is None else time.monotonic() + timeout
        self._win_start = time.monotonic()
        while not self._stop.is_set():
            if deadline is not None and time.monotonic() >= deadline:
                break
            if self._gray is not None:
                d = self._gray.gray_stall("serve")
                if d > 0.0:
                    time.sleep(d)  # gray weather: slow, not dead
            self._report_gray(time.monotonic())
            m = self.coord.take_shard_map()
            if m is not None:
                self._apply_map(m)
            snap, roll = self._take_requests()
            if roll is not None:
                self._do_rollback(roll)
            if snap is not None:
                self._do_snapshot(*snap)
            park = self._take_preempt_request()
            if park is not None:
                self._do_park(*park)
                break
            if self.coord.fleet.workers_done():
                break
            # with logged pushes whose acks wait, only look for a frame that
            # is already there: an empty inbox closes the group at once
            held = self.ps.wal is not None and self.ps.wal.pending > 0
            msg = self.transport.recv(timeout=0.0 if held else 0.1)
            if msg is None:
                # idle: close the open WAL group, so no deferred ack waits
                # for traffic that is not there
                self._commit_timed()
                continue
            self._serve_one(msg)
        if self._crashed:
            return  # a silent death: no checkpoint, no leave
        if self.parked:
            # renewals stop, the membership stays: the resume rejoins it
            self.coord.stop()
            return
        while (msg := self.transport.recv(timeout=0.0)) is not None:
            self._serve_one(msg)
        with self._mu:
            self.ps.save_checkpoint()
            self.ps.commit()
        self.coord.close()

    @property
    def central(self) -> np.ndarray:
        """A copy of the served values, taken under the serve lock."""
        with self._mu:
            return np.array(self.ps.central, copy=True)

    def snapshot(self) -> dict:
        """The range, a copy of the values and the counters, read under the
        serve lock, so a resize is never seen half done."""
        with self._mu:
            return {"lo": self.lo, "hi": self.hi, "map_version": self.map_version,
                    "central": np.array(self.ps.central, copy=True),
                    "stats": dict(self.stats)}
