"""Request/response transport for the serving engine over the messaging
layer (``utils/messaging.py``) — counterpart of the JAX
``serving/frontend.py``.

The same tagged-float32 star topology that carries the DownPour control
plane carries inference traffic: clients dial the engine's rank-0 hub over
either transport (:class:`InProcessTransport` for tests and single-process
demos, :class:`TCPTransport` for real processes — the frontend never sees
which). The codes:

- ``SubmitRequest``  client → engine: ``[id, max_new, temperature, top_k,
  top_p, seed, eos, *prompt]`` (``eos < 0`` means none);
- ``SubmitRequestV2`` client → engine: the same head extended with the
  overload plane's metadata ``[..., priority, deadline_ms, session,
  *prompt]`` — priority orders who gets shed first under overload,
  ``deadline_ms`` (0 = none, relative to submit) bounds how long the
  request may wait before it is shed with an explicit reject, and
  ``session`` is the fleet router's affinity hint. V1 frames keep working
  (priority 0, no deadline);
- ``StreamTokens``   engine → client: ``[id, done_flag, start_index,
  *tokens]`` — one frame per stream advance (admission's first token, then
  block shares); ``start_index`` is how many tokens of this request were
  emitted before the frame, so the client can detect dropped/duplicated/
  reordered frames by simple arithmetic;
- ``ServeReject``    engine → client: ``[id]`` — queue full, or a resume
  for a request the engine no longer knows;
- ``CancelRequest``  client → engine: ``[id]``;
- ``StreamAck``      client → engine: ``[id, n_received]`` — progress +
  liveness (the engine reaps requests whose client goes silent);
- ``ResumeStream``   client → engine: ``[id, n_received]`` — re-send the
  stream from that offset (gap recovery AND reconnect-and-resume: the
  frontend keeps each live request's emitted tokens, so a client that
  reconnects can replay from wherever it left off by request id).

Token ids and metadata ride float32 exactly (< 2^24), so the serving plane
uses the parameter server's wire format unchanged.

Request ids are client-assigned and namespaced by sender rank on the
engine side, so concurrent clients can't collide.

Fault model: stream frames are fire-and-forget; recovery is end-to-end
(client-driven resume against the frontend's per-request history) rather
than per-frame, so a lossy wire costs retransmits but never corrupts a
stream — under injected frame loss the collected tokens stay identical to
a standalone ``generate()``. Requests whose client
goes silent past ``client_deadline`` are cancelled and their slot, queues
and history freed — a disconnected or abandoned TCP client cannot leak
engine state.

The coordinator hold: with ``fleet=`` (a ``coord.member.FleetView`` or
anything with ``engine_up()`` and optionally ``rollback_active()``), new
submits are held in arrival order while the engine fleet is down or a PS
rollback barrier is in flight, up to ``hold_queue`` of them (past that a
``ServeReject``), and the sweep re-admits them on recovery.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from distributed_ml_pytorch_tpu_torch.serving.engine import (
    QueueFullError,
    ServingEngine,
)
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    SERVER_RANK,
    MessageCode,
    Transport,
)


#: sentinel ``_Route.engine_id``: the fleet router parked this route because
#: no healthy engine existed at submit or migration time; the sweep
#: resubmits it when a member revives. Parked routes are sheddable.
ORPHANED_ENGINE = -2


class RequestRejected(RuntimeError):
    """Client-side face of engine backpressure (a ``ServeReject`` frame)."""


_WIRE_EXACT = 1 << 24  # largest contiguous integer range float32 carries


def _check_wire_exact(request_id, seed, max_new_tokens, top_k, eos_token,
                      **extra) -> None:
    # integers ride float32, which is exact only below 2^24 — a silently
    # rounded seed would break the cross-transport determinism contract
    # (the remote engine would fold a DIFFERENT key schedule), so reject
    # out-of-range values loudly here
    for name, val in (("request_id", request_id), ("seed", seed),
                      ("max_new_tokens", max_new_tokens), ("top_k", top_k),
                      ("eos_token", eos_token or 0), *extra.items()):
        if not -_WIRE_EXACT < int(val) < _WIRE_EXACT:
            raise ValueError(
                f"{name}={val} does not fit the float32 wire exactly "
                f"(|value| must be < 2^24)")


def encode_submit(request_id: int, prompt, max_new_tokens: int, *,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0, seed: int = 0,
                  eos_token: Optional[int] = None) -> np.ndarray:
    _check_wire_exact(request_id, seed, max_new_tokens, top_k, eos_token)
    head = [float(request_id), float(max_new_tokens), float(temperature),
            float(top_k), float(top_p), float(seed),
            float(-1 if eos_token is None else eos_token)]
    return np.concatenate(
        [np.asarray(head, np.float32),
         np.asarray(prompt, np.float32).reshape(-1)])


def encode_submit_v2(request_id: int, prompt, max_new_tokens: int, *,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0, seed: int = 0,
                     eos_token: Optional[int] = None, priority: int = 0,
                     deadline_ms: int = 0, session: int = 0) -> np.ndarray:
    """The overload-plane submit frame: V1's head + ``[priority,
    deadline_ms, session]`` before the prompt tail."""
    _check_wire_exact(request_id, seed, max_new_tokens, top_k, eos_token,
                      priority=priority, deadline_ms=deadline_ms,
                      session=session)
    head = [float(request_id), float(max_new_tokens), float(temperature),
            float(top_k), float(top_p), float(seed),
            float(-1 if eos_token is None else eos_token),
            float(priority), float(deadline_ms), float(session)]
    return np.concatenate(
        [np.asarray(head, np.float32),
         np.asarray(prompt, np.float32).reshape(-1)])


def decode_submit(payload: np.ndarray) -> Tuple[int, dict, np.ndarray]:
    if payload.size < 8:
        raise ValueError(f"malformed SubmitRequest frame (size {payload.size})")
    rid = int(payload[0])
    eos = int(payload[6])
    kwargs = dict(
        max_new_tokens=int(payload[1]), temperature=float(payload[2]),
        top_k=int(payload[3]), top_p=float(payload[4]), seed=int(payload[5]),
        eos_token=None if eos < 0 else eos)
    prompt = payload[7:].astype(np.int32)
    return rid, kwargs, prompt


def decode_submit_v2(
        payload: np.ndarray) -> Tuple[int, dict, np.ndarray, int, int, int]:
    """Returns ``(rid, engine_kwargs, prompt, priority, deadline_ms,
    session)`` for a ``SubmitRequestV2`` frame."""
    if payload.size < 11:
        raise ValueError(
            f"malformed SubmitRequestV2 frame (size {payload.size})")
    rid = int(payload[0])
    eos = int(payload[6])
    kwargs = dict(
        max_new_tokens=int(payload[1]), temperature=float(payload[2]),
        top_k=int(payload[3]), top_p=float(payload[4]), seed=int(payload[5]),
        eos_token=None if eos < 0 else eos)
    priority = int(payload[7])
    deadline_ms = max(0, int(payload[8]))
    session = int(payload[9])
    prompt = payload[10:].astype(np.int32)
    return rid, kwargs, prompt, priority, deadline_ms, session


@dataclasses.dataclass
class _Route:
    """Engine-side state of one transport client's request: where to send
    frames, the full emitted-token history (the resume source, and the
    migration source: the fleet router re-prefills ``prompt + tokens`` on a
    surviving engine), liveness, and the overload plane's metadata."""

    rank: int
    rid: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    done_at: float = 0.0
    last_active: float = 0.0
    reaping: bool = False  # cancel already issued for client silence
    #: the submitted work itself, kept so a dead engine's stream can be
    #: resubmitted elsewhere (prompt + generated-so-far, remaining budget)
    prompt: Optional[np.ndarray] = None
    kwargs: dict = dataclasses.field(default_factory=dict)
    #: overload plane: higher priority wins admission under shed pressure;
    #: ``deadline`` is an absolute monotonic instant (0.0 = none) past
    #: which WAITING work is shed with an explicit reject
    priority: int = 0
    deadline: float = 0.0
    session: int = 0
    #: live engine Request handle of the current serving attempt (lets the
    #: sweep tell waiting work from running work), and which fleet member
    #: serves it (-1 = the frontend's single local engine)
    req: Optional[object] = None
    engine_id: int = -1
    #: monotonic instant service was lost (engine death detected, or parked
    #: with no survivor; 0.0 = in service): the migration MTTR's anchor
    service_lost_at: float = 0.0


class ServingFrontend:
    """Bridges one :class:`ServingEngine` to a rank-0 transport hub.

    A listener thread drains inbound frames into the engine; the engine's
    ``on_tokens`` callback streams results back to whichever rank submitted
    the request. :meth:`serve_forever` runs the scheduling loop in the
    calling thread (the engine itself stays single-threaded on the data
    plane); :meth:`stop` unblocks it.

    Reliability: each route keeps the request's emitted tokens so
    ``ResumeStream`` can replay from any offset; any frame from a client
    refreshes its requests' liveness, and a sweeper cancels + frees requests
    whose client has been silent past ``client_deadline`` seconds (slot,
    queue entry, route and history all released — the stream-state-leak
    fix). Finished histories are kept ``done_ttl`` seconds for late resumes,
    then dropped.
    """

    def __init__(self, engine: Optional[ServingEngine], transport: Transport,
                 *, client_deadline: float = 30.0, done_ttl: float = 60.0,
                 fleet=None, hold_queue: int = 64, slo_ttft_ms: float = 0.0,
                 shed_occupancy: float = 0.0, brownout_occupancy: float = 0.0,
                 brownout_max_new: int = 0):
        if engine is not None:
            if engine.on_tokens is not None:
                raise ValueError("engine already has an on_tokens consumer")
            engine.on_tokens = self._on_tokens
        self.engine = engine
        self.transport = transport
        self.client_deadline = float(client_deadline)
        self.done_ttl = float(done_ttl)
        # --- overload plane: graceful degradation knobs ----------------
        #: TTFT SLO in ms (0 = off): recent TTFT above it reads as overload
        self.slo_ttft_ms = float(slo_ttft_ms)
        #: pressure = (busy slots + queued) / total slots; at or above
        #: ``shed_occupancy`` (0 = off) new work admits only by displacing
        #: strictly-lower-priority WAITING work — whichever side loses is
        #: shed with an explicit ServeReject, never silently dropped
        self.shed_occupancy = float(shed_occupancy)
        #: brownout band (0 = off): at or above this pressure (but before
        #: shedding) incoming max_new_tokens is capped at
        #: ``brownout_max_new`` — degrade output length first, shed second
        self.brownout_occupancy = float(brownout_occupancy)
        self.brownout_max_new = int(brownout_max_new)
        self.shed = 0        # requests rejected by the overload plane
        self.brownouts = 0   # requests whose max_new was brownout-capped
        #: engine-side request key -> live route state. Keys start far above
        #: the engine's own id counter so locally submitted requests can
        #: never alias a transport route.
        self._routes: Dict[int, _Route] = {}
        self._by_client: Dict[Tuple[int, int], int] = {}
        self._routes_lock = threading.Lock()
        self._route_ids = itertools.count(1 << 32)
        self.reaped = 0  # requests cancelled for client silence
        #: the coordinator's fleet view: while it reports the engine fleet
        #: down or a rollback in flight, new submits are held in arrival
        #: order, up to ``hold_queue`` (past that: ServeReject); the sweep
        #: re-admits them on recovery. ``fleet=None``: no hold.
        self.fleet = fleet
        self.hold_queue = int(hold_queue)
        # appended by the pump thread, drained by the sweep thread, so every
        # access holds _held_lock; entries keep their arrival time, so a
        # deadline stays anchored to when the client submitted
        self._held: List[Tuple[int, MessageCode, np.ndarray, float]] = []
        self._held_lock = threading.Lock()
        self.held_peak = 0
        self._stop = threading.Event()
        self._listener = threading.Thread(target=self._pump, daemon=True)
        self._listener.start()

    def _pump(self) -> None:
        while not self._stop.is_set():
            msg = self.transport.recv(timeout=0.1)
            if msg is None:
                continue
            sender, code, payload = msg
            try:
                self._handle(sender, code, payload)
            except (ValueError, IndexError, OverflowError):
                # malformed frame (bad layout, or non-finite floats whose
                # int() conversion overflows): drop it, like the PS server
                # does — the pump thread must never die on client garbage
                continue

    def _route_of(self, sender: int, rid: int) -> Optional[_Route]:
        with self._routes_lock:
            key = self._by_client.get((sender, rid))
            return None if key is None else self._routes.get(key)

    def _drop_route(self, key: int) -> None:
        with self._routes_lock:
            route = self._routes.pop(key, None)
            if route is not None:
                self._by_client.pop((route.rank, route.rid), None)

    def _install_route(self, key: int, route: _Route) -> None:
        """Bind an engine key to a route (a fresh submit, or a migration's
        rebind under a new key) atomically."""
        with self._routes_lock:
            self._routes[key] = route
            self._by_client[(route.rank, route.rid)] = key

    def _routes_where(self, pred) -> List[Tuple[int, "_Route"]]:
        """A consistent snapshot of the (key, route) pairs matching ``pred``."""
        with self._routes_lock:
            return [(k, r) for k, r in self._routes.items() if pred(r)]

    def _take_routes_where(self, pred) -> List[Tuple[int, "_Route"]]:
        """Retire every live route matching ``pred`` atomically and return
        them (the migration path): a straggler ``on_tokens`` callback of the
        old engine then finds nothing, so the token history stays frozen
        until the route is reinstalled."""
        with self._routes_lock:
            taken = [(k, r) for k, r in self._routes.items() if pred(r)]
            for k, r in taken:
                del self._routes[k]
                self._by_client.pop((r.rank, r.rid), None)
        return taken

    def _handle(self, sender: int, code: MessageCode,
                payload: np.ndarray) -> None:
        now = time.monotonic()
        if code in (MessageCode.SubmitRequest, MessageCode.SubmitRequestV2):
            self._on_submit(sender, code, payload, now, arrived=now)
        elif code == MessageCode.CancelRequest and payload.size >= 1:
            rid = int(payload[0])
            with self._routes_lock:
                key = self._by_client.get((sender, rid))
                route = self._routes.get(key) if key is not None else None
            if route is not None:
                route.last_active = now
                self._cancel_route(key, route)
        elif code in (MessageCode.StreamAck, MessageCode.ResumeStream) \
                and payload.size >= 2:
            rid, n_have = int(payload[0]), max(0, int(payload[1]))
            route = self._route_of(sender, rid)
            if route is None:
                if code == MessageCode.ResumeStream:
                    with self._held_lock:
                        is_held = any(s == sender and p.size >= 1 and int(p[0]) == rid
                                      for s, _c, p, _t in self._held)
                    if is_held:
                        return  # held across an engine outage: not an error
                    # resume for a request the engine no longer knows
                    # (history expired, or never submitted): tell the
                    # client instead of letting it poll forever
                    self._send_to(sender, MessageCode.ServeReject,
                                  np.asarray([rid], np.float32))
                return
            route.last_active = now
            if code == MessageCode.ResumeStream:
                # snapshot under the lock: the engine thread (or a fleet
                # migration) may be appending concurrently
                with self._routes_lock:
                    toks, done = list(route.tokens), route.done
                if len(toks) > n_have or done:
                    self._send_frame(route, start=n_have,
                                     tokens=toks[n_have:], done=done)

    def _fleet_holding(self) -> bool:
        """True while new submits must be held: the coordinator reports the
        engine fleet down, or a PS rollback barrier is in flight (admitting
        work mid-restore would serve the state being discarded). The
        rollback hold fails open through the fleet view's TTL."""
        if self.fleet is None:
            return False
        if not self.fleet.engine_up():
            return True
        rollback = getattr(self.fleet, "rollback_active", None)
        return bool(rollback()) if rollback is not None else False

    def _on_submit(self, sender: int, code: MessageCode, payload: np.ndarray,
                   now: float, arrived: float) -> None:
        """One submit frame (fresh from the wire, or re-admitted from the
        held queue with its original arrival time)."""
        if self._fleet_holding():
            with self._held_lock:
                held_room = len(self._held) < self.hold_queue
                if held_room:
                    self._held.append((sender, code, np.array(payload, copy=True), arrived))
                    self.held_peak = max(self.held_peak, len(self._held))
            if not held_room and payload.size >= 1:
                self._send_to(sender, MessageCode.ServeReject,
                              np.asarray([payload[0]], np.float32))
            return
        try:
            if code == MessageCode.SubmitRequestV2:
                rid, kwargs, prompt, priority, deadline_ms, session = \
                    decode_submit_v2(payload)
            else:
                rid, kwargs, prompt = decode_submit(payload)
                priority = deadline_ms = session = 0
        except (ValueError, IndexError, OverflowError):
            # malformed submit: reject loudly when the frame at least
            # carries an id — silently dropping it would leave the
            # client blocked until its stream timeout
            if payload.size >= 1:
                self._send_to(
                    sender, MessageCode.ServeReject,
                    np.asarray([payload[0]], np.float32))
            return
        live = self._route_of(sender, rid)
        if live is not None:
            # duplicate submit (wire-level retry, or a reconnected
            # client re-driving the same id): never double-submit —
            # replay the stream from the top instead
            live.last_active = now
            with self._routes_lock:
                toks, done = list(live.tokens), live.done
            self._send_frame(live, start=0, tokens=toks, done=done)
            return
        deadline = (arrived + deadline_ms / 1e3) if deadline_ms > 0 else 0.0
        if deadline and now > deadline:
            # it outlived its own deadline (e.g. held across an outage):
            # an explicit shed, never a silent drop
            self.shed += 1
            self._send_to(sender, MessageCode.ServeReject,
                          np.asarray([rid], np.float32))
            return
        # overload plane: brownout degrades output length FIRST …
        if self._brownout_active():
            capped = min(int(kwargs["max_new_tokens"]),
                         max(1, self.brownout_max_new))
            if capped < int(kwargs["max_new_tokens"]):
                kwargs["max_new_tokens"] = capped
                self.brownouts += 1
        # … and only past the harder shed condition does work get dropped:
        # a new submit then admits only by displacing strictly-lower-
        # priority waiting work (whichever side loses gets the reject)
        if self._overloaded() and not self._displace_for(priority):
            self.shed += 1
            self._send_to(sender, MessageCode.ServeReject,
                          np.asarray([rid], np.float32))
            return
        key = next(self._route_ids)
        route = _Route(rank=sender, rid=rid, last_active=now,
                       prompt=np.array(prompt, copy=True),
                       kwargs=dict(kwargs), priority=priority,
                       deadline=deadline, session=session)
        self._install_route(key, route)
        if not self._submit_route(key, route):
            self._drop_route(key)
            self._send_to(sender, MessageCode.ServeReject,
                          np.asarray([rid], np.float32))

    # ------------------------------------------------------ engine dispatch
    # The fleet router (serving/fleet.py) overrides these two hooks; the
    # base frontend is the single-local-engine case.

    def _submit_route(self, key: int, route: _Route) -> bool:
        """Hand a fresh route to an engine; False = reject the client."""
        try:
            route.req = self.engine.submit(
                route.prompt, request_id=key, **route.kwargs)
            return True
        except (QueueFullError, ValueError):
            return False

    def _cancel_route(self, key: int, route: _Route) -> None:
        self.engine.cancel(key)

    # -------------------------------------------------------- overload plane
    def _wire_pressure(self) -> float:
        """Transport backpressure, 0..1, for a transport that reports it
        (``pressure()``): the wire is part of serving capacity."""
        gauge = getattr(self.transport, "pressure", None)
        return float(gauge()) if gauge is not None else 0.0

    def _pressure(self) -> float:
        """max(engine, wire) pressure; the fleet router overrides the engine
        half with the healthy members' aggregate."""
        if self.engine is None:
            return self._wire_pressure()
        busy, slots, queued = self.engine.pressure()
        return max((busy + queued) / max(1, slots), self._wire_pressure())

    def _ttft_now_ms(self) -> float:
        return self.engine.recent_ttft_ms() if self.engine is not None else 0.0

    def _overloaded(self) -> bool:
        if self.shed_occupancy > 0 and self._pressure() >= self.shed_occupancy:
            return True
        return (self.slo_ttft_ms > 0
                and self._ttft_now_ms() > self.slo_ttft_ms)

    def _brownout_active(self) -> bool:
        return (self.brownout_occupancy > 0 and self.brownout_max_new > 0
                and self._pressure() >= self.brownout_occupancy)

    def _waiting_routes(self) -> List[Tuple[int, _Route]]:
        """Routes submitted but not yet admitted to a slot (the sheddable
        set: nothing has streamed yet, so a reject is still honest)."""
        with self._routes_lock:
            items = list(self._routes.items())
        out = []
        for key, route in items:
            if route.done:
                continue
            req = route.req
            if req is None:
                if route.engine_id == ORPHANED_ENGINE:
                    out.append((key, route))  # parked: nothing streamed yet
                continue
            if req.slot is None and not req.done and not req.cancelled:
                out.append((key, route))
        return out

    def _displace_for(self, priority: int) -> bool:
        """Shed the lowest-priority waiting request iff it is strictly
        below ``priority`` (ties keep the incumbent). True = room made."""
        waiting = self._waiting_routes()
        if not waiting:
            return False
        key, victim = min(waiting, key=lambda kv: (kv[1].priority, -kv[0]))
        if victim.priority >= priority:
            return False
        self._shed_route(key, victim)
        return True

    def _shed_route(self, key: int, route: _Route) -> None:
        """Explicitly reject one waiting request (overload/deadline shed)."""
        self._cancel_route(key, route)
        self._drop_route(key)
        self.shed += 1
        self._send_to(route.rank, MessageCode.ServeReject,
                      np.asarray([route.rid], np.float32))

    def _send_to(self, rank: int, code: MessageCode,
                 payload: np.ndarray) -> bool:
        """Send toward one client; a dead transport peer must never take
        down the pump or scheduling thread."""
        try:
            self.transport.send(code, payload, dst=rank)
            return True
        except (OSError, ConnectionError, KeyError):
            return False

    def _send_frame(self, route: _Route, start: int, tokens: List[int],
                    done: bool) -> bool:
        frame = np.concatenate(
            [np.asarray([route.rid, 1.0 if done else 0.0, float(start)],
                        np.float32),
             np.asarray(tokens, np.float32)])
        return self._send_to(route.rank, MessageCode.StreamTokens, frame)

    def _on_tokens(self, req, new_tokens: List[int], done: bool) -> None:
        # the route table is rewired by the pump/sweep threads (submit,
        # drop, reap) and by a fleet migration while this engine-thread
        # callback streams: lookup and append both ride the lock, so a
        # resume's or a migration's snapshot never tears (a dead engine's
        # late callback finds its retired key gone)
        with self._routes_lock:
            route = self._routes.get(req.request_id)
            if route is None:
                return  # locally-submitted request (no transport client)
            start = len(route.tokens)
            route.tokens.extend(int(t) for t in new_tokens)
            if done:
                route.done = True
                route.done_at = time.monotonic()
        self._send_frame(route, start=start, tokens=new_tokens, done=done)

    def _readmit_held(self) -> None:
        """Re-admit the submits held across an engine outage or a rollback
        barrier, in arrival order."""
        if self._fleet_holding():
            return
        with self._held_lock:
            held, self._held = self._held, []
        for sender, code, payload, arrived in held:
            self._on_submit(sender, code, payload, time.monotonic(), arrived=arrived)

    def _sweep(self, now: float) -> None:
        """Re-admit held submits; free state for silent clients (cancel live
        requests; forget finished histories past their resume TTL); shed
        waiting work that outlived its deadline."""
        self._readmit_held()
        for key, route in self._waiting_routes():
            if route.deadline and now > route.deadline:
                self._shed_route(key, route)
        with self._routes_lock:
            items = list(self._routes.items())
        for key, route in items:
            if route.done:
                if now - route.done_at > self.done_ttl:
                    self._drop_route(key)
            elif not route.reaping and (
                    now - route.last_active > self.client_deadline):
                route.reaping = True  # count + cancel once per request
                self.reaped += 1
                self._cancel_route(key, route)  # eviction frees the slot/
                # queue row; the resulting done callback marks the route
                # finished and the TTL pass above forgets it

    def serve_forever(self, idle_sleep: float = 0.002,
                      sweep_every: float = 0.25) -> None:
        next_sweep = time.monotonic() + sweep_every
        while not self._stop.is_set():
            worked = self.engine.step()
            now = time.monotonic()
            if now >= next_sweep:
                self._sweep(now)
                next_sweep = now + sweep_every
            if not worked:
                time.sleep(idle_sleep)

    def stop(self) -> None:
        self._stop.set()


class ServingClient:
    """Submit prompts and stream tokens back over any Transport.

    Single-threaded: frames are drained on demand by the stream/generate
    calls and demultiplexed by request id, so one client can hold several
    streams open at once.

    Reliability: frames carry ``start_index``, so the client
    reassembles exactly the emitted sequence — duplicates are arithmetic
    no-ops, a gap (or ``resume_after`` seconds of silence) triggers a
    ``ResumeStream`` retransmit request, and every processed frame is
    acknowledged with ``StreamAck`` (which doubles as liveness, keeping the
    engine's silent-client reaper away). ``resume_from`` reattaches to a
    request a previous client (same transport rank) left behind — the
    reconnect-and-resume path.
    """

    def __init__(self, transport: Transport, server_rank: int = SERVER_RANK,
                 resume_after: float = 1.0):
        self.transport = transport
        self.server_rank = server_rank
        self.resume_after = float(resume_after)
        self._ids = itertools.count(1)
        self._buffers: Dict[int, "queue.Queue[Tuple[int, List[int], bool]]"] = {}
        self._rejected: set = set()

    def submit(self, prompt, max_new_tokens: int, *, priority: int = 0,
               deadline_ms: int = 0, session: int = 0, **kwargs) -> int:
        """Submit one prompt. ``priority``/``deadline_ms``/``session`` ride
        the V2 frame (overload plane and routing affinity); when all are 0
        the plain V1 frame is sent, so old servers keep working."""
        rid = next(self._ids)
        self._buffers[rid] = queue.Queue()
        if priority or deadline_ms or session:
            frame = encode_submit_v2(
                rid, prompt, max_new_tokens, priority=priority,
                deadline_ms=deadline_ms, session=session, **kwargs)
            code = MessageCode.SubmitRequestV2
        else:
            frame = encode_submit(rid, prompt, max_new_tokens, **kwargs)
            code = MessageCode.SubmitRequest
        self.transport.send(code, frame, dst=self.server_rank)
        return rid

    def cancel(self, request_id: int) -> None:
        self.transport.send(
            MessageCode.CancelRequest,
            np.asarray([request_id], np.float32), dst=self.server_rank)

    def resume_from(self, request_id: int, n_have: int = 0) -> int:
        """Reattach to an in-flight (or recently finished) request by its
        id — e.g. after this process reconnected — and stream the tokens
        from ``n_have`` on via the normal :meth:`stream` call."""
        self._buffers.setdefault(request_id, queue.Queue())
        self._send_resume(request_id, n_have)
        return request_id

    def _send_resume(self, request_id: int, n_have: int) -> None:
        self.transport.send(
            MessageCode.ResumeStream,
            np.asarray([request_id, n_have], np.float32),
            dst=self.server_rank)

    def _drain_one(self, timeout: float) -> bool:
        msg = self.transport.recv(timeout=timeout)
        if msg is None:
            return False
        _sender, code, payload = msg
        if payload.size < 1:
            return True
        rid = int(payload[0])
        if code == MessageCode.ServeReject:
            self._rejected.add(rid)
        elif code == MessageCode.StreamTokens and payload.size >= 3:
            buf = self._buffers.get(rid)
            if buf is not None:
                buf.put((int(payload[2]),
                         payload[3:].astype(np.int32).tolist(),
                         bool(payload[1])))
        return True

    def stream(self, request_id: int, timeout: float = 60.0,
               n_have: int = 0) -> Iterator[int]:
        """Yield the request's tokens (from ``n_have`` on) as frames
        arrive; raises :class:`RequestRejected` on backpressure or a
        resume the engine cannot serve, ``TimeoutError`` when the engine
        stays silent for ``timeout`` seconds despite retransmit requests."""
        buf = self._buffers[request_id]
        deadline = time.monotonic() + timeout
        n = int(n_have)  # tokens of this request fully consumed so far
        next_poke = time.monotonic() + self.resume_after
        done = False
        try:
            while not done:
                if request_id in self._rejected:
                    self._rejected.discard(request_id)
                    raise RequestRejected(
                        f"request {request_id} rejected (queue full or "
                        "unknown to the engine)")
                now = time.monotonic()
                try:
                    start, tokens, fdone = buf.get_nowait()
                except queue.Empty:
                    if now >= deadline:
                        raise TimeoutError(
                            f"no frames for request {request_id} in {timeout}s")
                    if now >= next_poke:
                        # silence: the engine may have streamed into a lossy
                        # wire (even the done frame can drop) — ask for a
                        # retransmit from where we stand
                        self._send_resume(request_id, n)
                        next_poke = now + self.resume_after
                    self._drain_one(timeout=0.05)
                    continue
                deadline = now + timeout
                if start > n:
                    # gap: a frame was lost ahead of us; drop this one and
                    # request the missing range (the retransmit covers both)
                    self._send_resume(request_id, n)
                    next_poke = now + self.resume_after
                    continue
                fresh = tokens[n - start:]  # dedup any overlap
                if fresh:
                    n += len(fresh)
                    self.transport.send(
                        MessageCode.StreamAck,
                        np.asarray([request_id, n], np.float32),
                        dst=self.server_rank)
                if fdone and start + len(tokens) <= n:
                    done = True
                for t in fresh:
                    yield int(t)
        finally:
            # every exit path — completion, reject, timeout, an abandoned
            # generator — must release the demux buffer, or late frames
            # accumulate in an orphaned queue for the client's lifetime
            self._buffers.pop(request_id, None)

    def generate(self, prompt, max_new_tokens: int, timeout: float = 60.0,
                 **kwargs) -> List[int]:
        """Blocking submit + full stream collection."""
        rid = self.submit(prompt, max_new_tokens, **kwargs)
        return list(self.stream(rid, timeout=timeout))
