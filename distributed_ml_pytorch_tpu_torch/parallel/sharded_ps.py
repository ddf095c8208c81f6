"""Sharded parameter server, the static world (counterpart of the JAX
``parallel/sharded_ps.py``; the DistBelief layout the reference descends
from).

Sharding is composition over the unsharded pieces. The central vector
splits into k contiguous ranges (:func:`shard_ranges`); shard ``s`` is an
unmodified :class:`~distributed_ml_pytorch_tpu_torch.parallel.async_ps.
ParameterServer` over ``flat[lo_s:hi_s]``, the server of its own transport
star (TCP: ``port + s``). A worker holds one transport per shard and runs the
DownPour cadence against all of them (:class:`ShardedAsynchronous`): a push
sends each server its slice of the accumulator, a pull asks every server,
and whatever slices have arrived are installed at the next step, so a worker
may hold shard A's fresh slice beside shard B's older one (DownPour's
staleness, per shard). There is no new wire format and no new server code,
so a worker of either package trains against shard servers of the other.
A shard server may carry a server-side optimizer over exactly its range
(``parallel/optplane.ShardedOptimizer``, the state a shard holds scaling as
1/k), and a worker may compress its pushes: one error-feedback encoder over
the whole flat vector frames each shard's slice as its own
``CompressedUpdate``.

A shard whose server dies degrades its slice to purely local SGD; the
other shards keep their service, and a pull still goes to the dead shard
as the probe that revives it. The sharded worker runs one step a dispatch:
it has no ``boundary``, as in the JAX package, so ``train_worker`` takes
the per-step path for it.

**The elastic path.** With a coordinator client (``coord``, a
``coord/member.CoordClient``), a ``transport_factory`` and the ``shard_map``
it joined under, the shard set is no longer fixed at launch. When the
coordinator sends a newer map, the next step boundary cuts over
(:meth:`ShardedAsynchronous.apply_shard_map`): the push thread drains under
the old map, servers the map keeps keep their transports, new ones get
theirs from the factory, and every range a server newly acquired is seeded
with this worker's current values (``RangeInstall``; the first worker to
cut over wins). The accumulator is a flat vector over the whole model, so
the map only decides how a push is sliced. Every push is stamped with the
map version and the absolute range it was cut for (``ShardPush``, or the
stamp of a ``CompressedUpdate``), and a pull reply cut for other offsets is
dropped. Each step reports its progress to the coordinator: the inter-step
latency EWMA, open circuit breakers, nacks and the loss and push-norm EWMAs
on the lease renewals, and per shard link the pull requests against the
replies. The shard servers are ``coord/elastic.ElasticShardServer``
(:func:`run_sharded_ps_process` with ``--coord``, ``--manifest-path``
naming the fleet manifest a rollback restores).

**The rollback barrier.** An elastic worker wires its client's
``on_rollback`` to a mailbox; at the next step boundary a parked rollback
drains the push thread (its pushes carry pre-rollback updates), zeroes the
accumulator in place (the push thread's pinned snapshot and a captured
graph read that storage), discards the replies already in the listeners,
pulls every shard, and holds the per-step updates until every shard's
restored slice is installed. ``observe_loss`` feeds a loss the step was not
given into the telemetry the renewals carry (the watchdog's input).

**The scheduler's hold.** While the scheduler has a shard server parked,
:meth:`ShardedAsynchronous.hold_shard` stops all traffic toward it, pulls
included: its slice goes on with purely local SGD, as a down shard's does,
but deliberately and silently (no up/down transitions, no revival probe),
until :meth:`ShardedAsynchronous.release_shard` after the resume. A push
not sent is counted in ``held_pushes``; it was never acked, so the
accounting (acked <= applied) holds through the park. The hold belongs to
the server id and survives a cutover that rebuilds the transports.
"""

from __future__ import annotations

import math
import sys
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from distributed_ml_pytorch_tpu_torch.parallel.async_ps import (
    DownpourClient,
    Listener,
    ParameterServer,
    PushFlusher,
)
from distributed_ml_pytorch_tpu_torch.parallel.optplane import (
    ShardedOptimizer,
    server_opt_from_args,
)
from distributed_ml_pytorch_tpu_torch.utils.health import admission_from_args
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    MessageCode,
    Transport,
    _split16,
    send_message,
)
from distributed_ml_pytorch_tpu_torch.utils.metrics import Ewma
from distributed_ml_pytorch_tpu_torch.utils.serialization import (
    ravel_model_params,
    unravel_model_params,
)


def shard_ranges(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous near-equal [lo, hi) ranges covering ``range(n)`` — the
    first ``n % n_shards`` shards are one element longer."""
    if n_shards < 1 or n_shards > n:
        raise ValueError(f"need 1 <= n_shards <= {n}, got {n_shards}")
    base, extra = divmod(n, n_shards)
    ranges, lo = [], 0
    for s in range(n_shards):
        hi = lo + base + (1 if s < extra else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def make_shard_server(model: Optional[nn.Module] = None, *, shard: int, n_shards: int,
                      params: Optional[np.ndarray] = None,
                      transport: Optional[Transport] = None,
                      n_workers: Optional[int] = None,
                      worker_timeout: Optional[float] = None,
                      ckpt_dir: Optional[str] = None, ckpt_every: int = 500,
                      staleness_damping: float = 0.0, wal: bool = False,
                      admission=None, combine: str = "add",
                      server_opt: Optional[str] = None,
                      server_opt_kw: Optional[dict] = None) -> ParameterServer:
    """A plain :class:`ParameterServer` over shard ``shard``'s slice of the
    flat parameters (``params``, or ``model`` ravelled on the host).
    ``ckpt_dir`` should be the shard's own (``<dir>/shard<s>``): each server
    checkpoints, and with ``wal`` logs, only its slice. ``server_opt``
    (``"sgdm"`` or ``"adam"``, options ``server_opt_kw``) gives the shard an
    optimizer over exactly its ``[lo, hi)``."""
    flat = (np.asarray(params, np.float32) if params is not None
            else ravel_model_params(model).cpu().numpy().astype(np.float32))
    lo, hi = shard_ranges(flat.shape[0], n_shards)[shard]
    optimizer = (ShardedOptimizer(server_opt, lo, hi, **(server_opt_kw or {}))
                 if server_opt else None)
    return ParameterServer(params=flat[lo:hi], transport=transport, n_workers=n_workers,
                           worker_timeout=worker_timeout, ckpt_dir=ckpt_dir,
                           ckpt_every=ckpt_every, staleness_damping=staleness_damping,
                           wal=wal, admission=admission, combine=combine,
                           optimizer=optimizer)


class ShardedAsynchronous(DownpourClient):
    """DownPour client against k shard servers: :class:`~distributed_ml_pytorch_tpu_torch.
    parallel.async_ps.Asynchronous`'s cadence, accumulator, push, resync
    and finish (their :class:`~distributed_ml_pytorch_tpu_torch.parallel.
    async_ps.DownpourClient`), one transport per shard.

    Used like a torch optimizer: after ``loss.backward()``, ``opt.step()``
    installs whatever shard slices have arrived, asks every shard for its
    slice every ``n_pull`` steps, applies the local update while
    accumulating it into one flat accumulator, and every ``n_push`` steps
    hands a snapshot of it to the push thread, which slices it per shard.
    With one transport it is the unsharded client, push for push.

    Construction installs each server's slice of the model (or, with
    ``rejoin``, adopts every shard's slice, each awaited up to
    ``install_timeout`` seconds). ``heartbeats[s]`` (optional) is shard
    ``s``'s ``HeartbeatSender``: its ``peer_down`` degrades the shard before
    a send could block. A nack from any shard's admission gate pulls every
    shard and holds the updates until each has installed. ``step(loss)``
    with a nonfinite loss skips the update, the cadence unchanged.
    ``compress``/``compress_opts`` compress the pushes: one error-feedback
    encoder over the full length, one ``CompressedUpdate`` a shard's slice.

    ``coord``, ``transport_factory(entry)`` and ``shard_map`` (whose entries
    the ``transports`` serve, in order) make it elastic (the module
    docstring); heartbeats are refused then, since shard liveness is the
    coordinator's lease.
    """

    def __init__(self, model: nn.Module, lr: float, n_push: int, n_pull: int, *,
                 transports: Sequence[Transport], tx=None, rejoin: bool = False,
                 install_timeout: float = 5.0, heartbeats: Optional[Sequence] = None,
                 compress: Optional[str] = None, compress_opts: Optional[dict] = None,
                 coord=None, transport_factory=None, shard_map=None):
        if not transports:
            raise ValueError("need at least one shard transport")
        if coord is not None and heartbeats:
            raise ValueError("elastic mode: shard liveness is the coordinator's lease job — "
                             "per-shard heartbeat senders cannot follow a cutover")
        if coord is not None and transport_factory is None:
            raise ValueError("elastic mode needs a transport_factory")
        if heartbeats and len(heartbeats) != len(transports):
            raise ValueError("need one heartbeat sender per shard transport")
        self.coord = coord
        self.transport_factory = transport_factory
        self.map_version = shard_map.version if shard_map is not None else -1
        #: each slot's server id: its coordinator rank in elastic mode, its
        #: position otherwise
        self.server_ids = ([e.server_id for e in shard_map.entries]
                           if shard_map is not None else list(range(len(transports))))
        self._owned: set = set()  # server ids whose transports this client made
        self._last_step_t: Optional[float] = None
        #: the inter-step latency EWMA the renewals carry
        self._ewma = Ewma()
        self._loss_ewma = Ewma()
        self._gnorm_ewma = Ewma()  # the push thread's
        #: per server id, the pull requests sent; and a window of per-link
        #: totals (requests, replies, blocked-send seconds)
        self._pull_reqs: dict = {}
        self._link_hist: list = []
        self.shard_down = [False] * len(transports)
        #: slots held by the scheduler's park, and the pushes not sent there
        self.shard_held = [False] * len(transports)
        self.held_pushes = 0
        #: the rollback mailbox: set on a barrier's start, taken at the next
        #: step boundary
        self._rollback_pending = threading.Event()
        self.rollbacks_seen = 0
        flat = self._setup(model, lr, n_push, n_pull, tx, transports, compress,
                           compress_opts)
        if shard_map is not None:
            if shard_map.n_params != self._flat_n:
                raise ValueError(f"shard map covers {shard_map.n_params} params but the model "
                                 f"ravels to {self._flat_n}")
            if len(shard_map.entries) != len(self.transports):
                raise ValueError(f"shard map has {len(shard_map.entries)} entries but "
                                 f"{len(self.transports)} transports were given")
            self.ranges = shard_map.ranges
        else:
            self.ranges = shard_ranges(self._flat_n, len(self.transports))
        self.heartbeats = list(heartbeats) if heartbeats else []
        self._owned_heartbeats = []  # the caller starts and stops them
        if rejoin:
            self._pull_all()
            for s, listener in enumerate(self.listeners):
                if not listener.wait_for_update(timeout=install_timeout):
                    print(f"worker: rejoin pull to shard {s} unanswered after "
                          f"{install_timeout:.1f}s — that slice starts from local init",
                          file=sys.stderr)
        else:
            for s, (lo, hi) in enumerate(self.ranges):
                self._send(s, MessageCode.ParameterUpdate, flat[lo:hi])
        if coord is not None and getattr(coord, "on_rollback", None) is None:
            coord.on_rollback = self._note_rollback
        # the fetched push vector is sliced per shard on the push thread, so
        # the training thread never waits on a copy or a socket
        self._flusher = PushFlusher(self._push_all)

    def _push_all(self, arr: np.ndarray) -> None:
        """Send every shard its slice of one fetched push vector, dense or
        compressed; elastic slices carry the ``(map version, lo, hi)``
        stamp. The push thread drains before any cutover, so the stamp read
        here always matches the slicing."""
        if self.coord is not None:
            norm = float(np.linalg.norm(arr.astype(np.float64, copy=False)))
            if np.isfinite(norm):
                self._gnorm_ewma.update(norm)
        ver = max(0, self.map_version)
        for s, (lo, hi) in enumerate(self.ranges):
            if self.encoder is not None:
                stamp = (ver, lo, hi) if self.coord is not None else None
                self._sendv(s, MessageCode.CompressedUpdate,
                            self.encoder.encode_range(arr, lo, hi, stamp=stamp))
            elif self.coord is not None:
                head = np.asarray([*_split16(ver), *_split16(lo), *_split16(hi)], np.float32)
                self._send(s, MessageCode.ShardPush, np.concatenate([head, arr[lo:hi]]))
            else:
                self._send(s, MessageCode.GradientUpdate, arr[lo:hi])

    def _held(self, shard: int, code: MessageCode) -> bool:
        """True, counting a push, when the shard is held: nothing is sent to
        a parked server, not even the pull probe."""
        if not self.shard_held[shard]:
            return False
        if code in (MessageCode.GradientUpdate, MessageCode.ShardPush,
                    MessageCode.CompressedUpdate):
            self.held_pushes += 1
        return True

    def _send(self, shard: int, code: MessageCode, payload: np.ndarray) -> None:
        """Send toward one shard server, under :meth:`_guarded_send`."""
        if self._held(shard, code):
            return
        if code == MessageCode.ParameterRequest:
            sid = self.server_ids[shard]
            self._pull_reqs[sid] = self._pull_reqs.get(sid, 0) + 1
        self._guarded_send(shard, code,
                           lambda t: send_message(code, payload, transport=t))

    def _sendv(self, shard: int, code: MessageCode, parts) -> None:
        """A frame of several parts toward one shard server, under
        :meth:`_guarded_send`."""
        if self._held(shard, code):
            return
        self._guarded_send(shard, code, lambda t: t.sendv(code, parts))

    def _guarded_send(self, shard: int, code: MessageCode, do_send) -> None:
        """``do_send(transport)`` toward one shard server; its death
        degrades that slice, never the worker. A down shard still gets
        pulls: the pull cadence is the probe, and the reply of a restarted
        server is what :meth:`_mark_up` revives on."""
        if self.shard_down[shard]:
            if code != MessageCode.ParameterRequest:
                return
            try:
                do_send(self.transports[shard])
            except (OSError, ConnectionError):
                pass  # still down; the next pull probes again
            return
        if self.heartbeats and self.heartbeats[shard].peer_down:
            self._mark_down(shard)
            return
        try:
            do_send(self.transports[shard])
        except (OSError, ConnectionError):
            self._mark_down(shard)

    def _send_link(self, link: int, code: MessageCode, payload) -> None:
        self._send(link, code, payload)

    def _link_down(self, link: int) -> bool:
        return self.shard_down[link]

    def _link_name(self, link: int) -> str:
        return f"shard {self.server_ids[link]}"

    def _mark_down(self, shard: int) -> None:
        if self.shard_down[shard]:
            return
        self.shard_down[shard] = True
        lo, hi = self.ranges[shard]
        print(f"worker: shard {self.server_ids[shard]} state up->down (params [{lo},{hi})) "
              "— that slice continues with purely-local SGD until the server answers again",
              file=sys.stderr)

    def _mark_up(self, shard: int) -> None:
        """A reply from a down shard is evidence of life: resume its
        push/pull service."""
        self.shard_down[shard] = False
        if self.heartbeats:
            # the sender clears this itself on its next good send; clearing
            # here closes the race where the stale flag re-marks the shard
            self.heartbeats[shard].peer_down = False
        lo, hi = self.ranges[shard]
        print(f"worker: shard {self.server_ids[shard]} state down->up (params [{lo},{hi})) "
              "— push/pull service resumes", file=sys.stderr)

    def hold_shard(self, server_id: int) -> None:
        """The scheduler parked ``server_id``: stop all traffic toward it
        until :meth:`release_shard`. The push thread drains first, so no
        push cut before the hold lands after it."""
        self._flusher.drain()
        idx = self.server_ids.index(server_id)
        self.shard_held[idx] = True
        lo, hi = self.ranges[idx]
        print(f"worker: shard {server_id} HELD (parked by the scheduler) — params [{lo},{hi}) "
              "continue with purely-local SGD", file=sys.stderr)

    def release_shard(self, server_id: int) -> None:
        """End the park: push and pull service to ``server_id`` resumes (the
        resumed server answers under the same range)."""
        idx = self.server_ids.index(server_id)
        self.shard_held[idx] = False
        print(f"worker: shard {server_id} RELEASED — push/pull service resumes",
              file=sys.stderr)

    def _install_arrived(self) -> None:
        """Copy whichever shard slices have arrived into the model, in
        place (between steps); the other slices keep their values. A
        stamped reply cut for another range is dropped; so is, in elastic
        mode, a reply of another size (a server that resized in flight). In
        the static world a slice of the wrong size raises: the ranges are
        fixed at launch, so a mismatch is a bug, never traffic to drop."""
        latest = [listener.take_latest_versioned() for listener in self.listeners]
        if all(sl is None for _stamp, sl in latest):
            return
        device = self.accum.device
        flat = ravel_model_params(self.model)
        for s, ((lo, hi), (stamp, sl)) in enumerate(zip(self.ranges, latest)):
            if sl is None:
                continue
            if stamp is not None and stamp[1:] != (lo, hi):
                print(f"worker: dropping shard {self.server_ids[s]} reply for "
                      f"[{stamp[1]},{stamp[2]}) v{stamp[0]} (this slot expects [{lo},{hi}) "
                      f"on v{self.map_version})", file=sys.stderr)
                continue
            if sl.shape[0] != hi - lo:
                if self.coord is None:
                    raise ValueError(f"shard reply of {sl.shape[0]} params for a "
                                     f"[{lo},{hi}) range — shard/worker ranges disagree")
                print(f"worker: dropping shard {self.server_ids[s]} reply of {sl.shape[0]} "
                      f"params for a [{lo},{hi}) range (stale shard-map traffic)",
                      file=sys.stderr)
                continue
            if self.shard_down[s]:
                self._mark_up(s)
            flat[lo:hi] = torch.from_numpy(sl).to(device)
            if self._hold_updates:
                self._fresh_installed.add(s)
        unravel_model_params(self.model, flat, unravel=self._unravel)

    # ------------------------------------------------------------ elastic
    def step(self, loss=None) -> None:
        """:meth:`DownpourClient.step`, after the coordinator report and a
        parked rollback; a finite ``loss`` also feeds the loss EWMA the
        renewals carry."""
        if loss is not None and math.isfinite(float(loss)):
            self._loss_ewma.update(float(loss))
        self._report_progress()
        self._maybe_rollback()
        super().step(loss)

    def observe_loss(self, loss: float) -> None:
        """Fold a loss into the renewals' telemetry without gating a step: a
        nonfinite one counts (the watchdog's hard signal), a finite one
        feeds the EWMA."""
        if not math.isfinite(float(loss)):
            self.bad_losses += 1
            return
        self._loss_ewma.update(float(loss))

    def _note_rollback(self, rollback_id: int, phase: int) -> None:
        """The client's callback: park a barrier's start for the next step
        boundary."""
        if phase == 0:
            self._rollback_pending.set()

    def _maybe_rollback(self) -> None:
        """Take a parked rollback: drain the pushes in flight (they must not
        land after the restore), zero the accumulator in place, discard the
        replies already taken in, pull every shard and hold the updates
        until each has installed its restored slice."""
        if not self._rollback_pending.is_set():
            return
        self._rollback_pending.clear()
        self.rollbacks_seen += 1
        self._flusher.drain()
        self.accum.zero_()
        self._hold_updates = True
        self._fresh_installed = set()
        # the loss telemetry described the regime being discarded
        self._loss_ewma.reset()
        print("worker: fleet ROLLBACK barrier — dropped the in-flight accumulator, pulling "
              "restored params from every shard", file=sys.stderr)
        for listener in self.listeners:
            listener.take_latest_versioned()
        self._pull_all()

    def _report_progress(self) -> None:
        """The coordinator's view of this worker, once a step: the
        inter-step gap's EWMA (the whole loop, what a straggler costs the
        fleet), open circuit breakers, nacks, nonfinite losses, the loss
        and push-norm EWMAs, and the per-link evidence."""
        if self.coord is None:
            return
        now = time.monotonic()
        if self._last_step_t is not None:
            self._ewma.update((now - self._last_step_t) * 1e3)
        self._last_step_t = now
        wire_open = sum(t.open_breakers() for t in self.transports
                        if hasattr(t, "open_breakers"))
        self.coord.report(self.idx // self.n_push, self.idx, self._ewma.value,
                          wire_open=wire_open, nacks=self.nacks, bad_loss=self.bad_losses,
                          loss_ewma=self._loss_ewma.value, gnorm_ewma=self._gnorm_ewma.value)
        self.coord.report_gray_health(links=self._gray_links())

    def _gray_links(self) -> tuple:
        """Per shard link, over a window of the last 8 steps: the share of
        pull requests left unanswered (two outstanding tolerated) and the
        reliable wire's blocked-send seconds — the one witness of a one-way
        partition, whose shard still renews its lease."""
        snap = {}
        for s, sid in enumerate(self.server_ids):
            st = getattr(self.transports[s], "stats", None)
            blocked = float(st.get("window_blocked_s", 0.0)) if isinstance(st, dict) else 0.0
            snap[sid] = (self._pull_reqs.get(sid, 0), int(self.listeners[s].replies), blocked)
        self._link_hist.append(snap)
        if len(self._link_hist) > 9:
            del self._link_hist[:-9]
        base = self._link_hist[0]
        links = []
        for sid, (reqs, reps, blocked) in snap.items():
            b = base.get(sid)
            if b is None:
                continue  # joined within the window: no baseline yet
            req_w = reqs - b[0]
            rep_w = max(0, reps - b[1])
            miss = (max(0, req_w - rep_w - 2) / req_w) if req_w > 0 else 0.0
            if req_w > 0:
                links.append((sid, miss, max(0.0, blocked - b[2])))
        return tuple(links)

    def _at_boundary(self) -> None:
        """Adopt a newer coordinator map at this step boundary."""
        if self.coord is None:
            return
        m = self.coord.take_shard_map()
        if m is not None and m.version > self.map_version:
            self.apply_shard_map(m)

    def apply_shard_map(self, m) -> None:
        """Cut over to map version ``m.version``: drain the push thread, so
        every push in flight lands under the old map; retire the slots of
        servers the map dropped (their listeners stop; their transports
        close only if this client made them); open slots for new servers
        from the factory, each listener before any send; then seed every
        freshly acquired range with this worker's current values
        (``RangeInstall``)."""
        self._flusher.drain()
        old = {sid: (t, listener, down, held) for sid, t, listener, down, held
               in zip(self.server_ids, self.transports, self.listeners, self.shard_down,
                      self.shard_held)}
        transports, listeners, down, held = [], [], [], []
        for e in m.entries:
            if e.server_id in old:
                t, listener, d, h = old.pop(e.server_id)
            else:
                t = self.transport_factory(e)
                self._owned.add(e.server_id)
                listener = Listener(transport=t)
                listener.start()
                d = h = False
            transports.append(t)
            listeners.append(listener)
            down.append(d)
            held.append(h)
        for sid, (t, listener, _d, _h) in old.items():
            listener.stop()
            if sid in self._owned:
                self._owned.discard(sid)
                t.close()
        print("worker: shard map v{} adopted — {} shard(s): {}".format(
            m.version, len(m.entries),
            ", ".join(f"s{e.server_id}=[{e.lo},{e.hi})" for e in m.entries) or "none"),
            file=sys.stderr)
        self.transports, self.listeners, self.shard_down = transports, listeners, down
        self.shard_held = held
        self.ranges = m.ranges
        self.server_ids = [e.server_id for e in m.entries]
        self.map_version = m.version
        # stale by at most one pull cadence: DownPour's staleness, against
        # losing the range
        flat = ravel_model_params(self.model).cpu().numpy()
        for s, e in enumerate(m.entries):
            if e.needs_install:
                head = np.asarray([*_split16(e.fresh_lo), *_split16(e.fresh_hi)], np.float32)
                self._send(s, MessageCode.RangeInstall,
                           np.concatenate([head, flat[e.fresh_lo:e.fresh_hi]]))

    def push_speculative(self, task_id: int, flat_update) -> None:
        """Push one backup task's result, the accumulated update of a
        straggler's remaining batches, under the coordinator's ``task_id``:
        the victim and its backup both call this with the same id and each
        shard server applies the first to arrive. Stamped like every
        elastic push."""
        head_tv = (*_split16(int(task_id)), *_split16(max(0, self.map_version)))
        flat_update = np.asarray(flat_update, np.float32).ravel()
        for s, (lo, hi) in enumerate(self.ranges):
            head = np.asarray([*head_tv, *_split16(lo), *_split16(hi)], np.float32)
            self._send(s, MessageCode.SpeculativeUpdate,
                       np.concatenate([head, flat_update[lo:hi]]))


def run_sharded_ps_process(args) -> int:
    """CLI entry for one process of the sharded world (``--n-servers K``):
    global ranks 0..K-1 are shard servers, K.. are workers. Shard ``s``'s
    star is its own transport world on ``port + s`` (its server is star
    rank 0, worker ``r`` star rank ``r − K + 1``). Shard servers build
    their slice on the host and never touch the card; with ``--wal`` they
    ack a push only after the log's fsync, and ``--ckpt-dir`` lands in
    ``<dir>/shard<s>``. ``--combine`` and ``--server-opt`` reach every shard
    server, ``--compress`` every worker. With ``--coord HOST:PORT`` the
    ranks join that coordinator instead (:func:`_run_elastic_ps_process`)."""
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.utils.messaging import make_transport

    k = int(args.n_servers)
    n_workers = args.world_size - k
    if args.rank is None:
        raise SystemExit("--rank is required for distributed --mode ps runs")
    if n_workers < 1:
        raise SystemExit(f"--n-servers {k} leaves no workers in --world-size "
                         f"{args.world_size}")
    kind = getattr(args, "transport", "auto")
    reliable = getattr(args, "reliable", False)
    coord_addr = getattr(args, "coord", "") or ""
    if coord_addr:
        return _run_elastic_ps_process(args, k, n_workers, kind, reliable, coord_addr)
    if args.rank >= k:
        return _run_static_worker(args, k, n_workers, kind, reliable)
    shard = args.rank
    model = get_model(getattr(args, "model", "alexnet"), seed=getattr(args, "seed", 0),
                      device="cpu")
    ckpt_dir = getattr(args, "ckpt_dir", "") or None
    # built before it listens, as run_ps_process's server is
    opt_kind, opt_kw = server_opt_from_args(args)
    server = make_shard_server(
        model, shard=shard, n_shards=k, n_workers=n_workers,
        worker_timeout=getattr(args, "worker_timeout", 0.0) or None,
        ckpt_dir=f"{ckpt_dir}/shard{shard}" if ckpt_dir else None,
        ckpt_every=getattr(args, "ckpt_every", 500),
        staleness_damping=getattr(args, "staleness_damping", 0.0),
        # unmasked: --wal without --ckpt-dir raises in ParameterServer
        wal=getattr(args, "wal", False), admission=admission_from_args(args),
        combine=getattr(args, "combine", "add") or "add", server_opt=opt_kind,
        server_opt_kw=opt_kw)
    transport = make_transport(0, n_workers + 1, args.master, int(args.port) + shard,
                               kind=kind, reliable=reliable,
                               durable_acks=getattr(args, "wal", False))
    server.transport = transport
    try:
        if getattr(args, "resume", False) and server.maybe_restore():
            print(f"shard server {shard}: resumed central params")
        server.run()
        print(f"shard server {shard}: done ({server.central.shape[0]} params held)")
    finally:
        transport.close()
    return 0


def _run_static_worker(args, k: int, n_workers: int, kind: str, reliable: bool) -> int:
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import train_worker
    from distributed_ml_pytorch_tpu_torch.utils.compress import compress_from_args
    from distributed_ml_pytorch_tpu_torch.utils.messaging import make_transport

    star_rank = args.rank - k + 1
    transports = [make_transport(star_rank, n_workers + 1, args.master, int(args.port) + s,
                                 kind=kind, reliable=reliable)
                  for s in range(k)]
    heartbeats = []
    try:
        if args.heartbeat_interval > 0:
            # one sender per shard star, started before the model is built:
            # each shard's failure detector sees liveness from the start
            from distributed_ml_pytorch_tpu_torch.utils.failure import HeartbeatSender

            for t in transports:
                hb = HeartbeatSender(t, interval=args.heartbeat_interval)
                hb.start()
                heartbeats.append(hb)

        def factory(model, tx):
            return ShardedAsynchronous(model, lr=args.lr, n_push=args.num_push,
                                       n_pull=args.num_pull, tx=tx, transports=transports,
                                       rejoin=getattr(args, "rejoin", False),
                                       heartbeats=heartbeats or None,
                                       **compress_from_args(args))

        _model, logger = train_worker(args, transports[0], device=args.backend,
                                      opt_factory=factory)
        # worker CSVs keep the unsharded node1..N names whatever the number
        # of server ranks before them
        print("wrote", logger.to_csv("node{}.csv".format(star_rank)))
        print("Finished Training")
    finally:
        for hb in heartbeats:
            hb.stop()
        for t in transports:
            t.close()
    return 0


def _run_elastic_ps_process(args, k: int, n_workers: int, kind: str, reliable: bool,
                            coord_addr: str) -> int:
    """``--coord HOST:PORT``: one rank of the elastic world. Shard rank
    ``r`` (< K) serves as a ``coord/elastic.ElasticShardServer`` with server
    id ``r + 1`` on its own star (``port + r``, which is how a worker's
    factory resolves a map entry: ``port + server_id − 1``), accepting
    workers whenever they dial (``wait_for=0``: the map waits for its join,
    the workers for the map). A worker rank joins, waits up to 120 s for a
    map with a shard in it, and trains with an elastic
    :class:`ShardedAsynchronous` that adopts each newer map at a step
    boundary. Coordination ranks are ``global rank + 1`` (the coordinator
    is 0); that star is plain TCP: joins retry, renewals repeat."""
    from distributed_ml_pytorch_tpu_torch.coord.elastic import ElasticShardServer
    from distributed_ml_pytorch_tpu_torch.coord.member import CoordClient
    from distributed_ml_pytorch_tpu_torch.models import get_model
    from distributed_ml_pytorch_tpu_torch.parallel.async_ps import train_worker
    from distributed_ml_pytorch_tpu_torch.utils.compress import compress_from_args
    from distributed_ml_pytorch_tpu_torch.utils.messaging import (
        ReliableTransport,
        TCPTransport,
        make_transport,
    )

    host, _, cport = coord_addr.partition(":")
    coord_transport = TCPTransport(rank=args.rank + 1, world_size=64,
                                   master=host or "localhost", port=int(cport or 29700))
    client = None
    try:
        if args.rank < k:
            model = get_model(getattr(args, "model", "alexnet"), seed=getattr(args, "seed", 0),
                              device="cpu")
            flat = ravel_model_params(model).cpu().numpy().astype(np.float32)
            opt_kind, opt_kw = server_opt_from_args(args)
            # the coordinator assigns the range: the optimizer starts empty
            # and resizes on the first map, as the central slice does
            optimizer = ShardedOptimizer(opt_kind, 0, 0, **opt_kw) if opt_kind else None
            client = CoordClient(coord_transport, "shard")
            star = TCPTransport(0, n_workers + 1, args.master, int(args.port) + args.rank,
                                wait_for=0)
            if reliable:
                # with --wal the acks of pushes wait for the log's fsync
                star = ReliableTransport(star, ack_on_delivery=not getattr(args, "wal", False))
            ckpt_dir = getattr(args, "ckpt_dir", "") or None
            server = ElasticShardServer(
                server_id=args.rank + 1, n_params=flat.shape[0], transport=star,
                coord=client, init_params=flat,
                staleness_damping=getattr(args, "staleness_damping", 0.0),
                ckpt_dir=f"{ckpt_dir}/shard{args.rank}" if ckpt_dir else None,
                ckpt_every=getattr(args, "ckpt_every", 500),
                # unmasked: --wal without --ckpt-dir raises in ParameterServer
                wal=getattr(args, "wal", False), admission=admission_from_args(args),
                manifest_path=getattr(args, "manifest_path", "") or None,
                combine=getattr(args, "combine", "add") or "add", optimizer=optimizer)
            try:
                server.run()
                print(f"elastic shard server {args.rank}: done (range [{server.lo},"
                      f"{server.hi}), map v{server.map_version}, stats {server.stats})")
            finally:
                star.close()
            return 0
        star_rank = args.rank - k + 1
        client = CoordClient(coord_transport, "worker")
        m = client.join(timeout=10)
        # an empty map only means no shard server has joined yet
        deadline = time.monotonic() + 120
        while (m is None or not m.entries) and time.monotonic() < deadline:
            time.sleep(0.5)
            m = client.current_map()
        if m is None or not m.entries:
            raise SystemExit(f"worker: no populated shard map from the coordinator at "
                             f"{coord_addr} after 120s — is coord.cli running and did any "
                             "shard rank join?")
        created = []

        def factory(entry):
            t = make_transport(star_rank, n_workers + 1, args.master,
                               int(args.port) + entry.server_id - 1, kind=kind,
                               reliable=reliable)
            created.append(t)
            return t

        try:
            initial = [factory(e) for e in m.entries]

            def opt_factory(model, tx):
                return ShardedAsynchronous(
                    model, lr=args.lr, n_push=args.num_push, n_pull=args.num_pull, tx=tx,
                    transports=initial, coord=client, transport_factory=factory,
                    shard_map=m, rejoin=getattr(args, "rejoin", False),
                    **compress_from_args(args))

            _model, logger = train_worker(args, initial[0], device=args.backend,
                                          opt_factory=opt_factory)
            print("wrote", logger.to_csv("node{}.csv".format(star_rank)))
            print("Finished Training")
        finally:
            for t in created:
                t.close()
        return 0
    finally:
        if client is not None:
            client.close()
        coord_transport.close()
