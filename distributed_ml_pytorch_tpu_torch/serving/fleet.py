"""Fleet serving: N engine replicas behind one router, degrading instead of
dying (counterpart of the JAX ``serving/fleet.py``).

One engine behind one frontend loses every in-flight stream when the engine
dies. This module is the serving analogue of the elastic PS plane
(``coord/``): the frontend becomes a **router** over N
:class:`EngineMember` replicas, each a lease-holding fleet member, and the
three failure answers compose:

- **Routing.** New requests go to the healthy engine with the most free
  KV-slot capacity (occupancy = busy slots + queued, the pressure signal
  the overload plane sheds on); a ``session`` hint in the V2 submit frame
  pins a session's requests to one engine while it stays healthy (prefix
  locality without cache introspection). An engine on gray probation
  (:meth:`FleetRouter.note_gray`) stays routable but scores as if it had
  half its free capacity.
- **Health.** Every sweep checks each member's serve-loop heartbeat, marks
  it down after ``probe_timeout`` of silence, logs the up/down transition
  and revives it on the next beat. A coordinator adds the second detection
  path: members renew leases (occupancy and TTFT ride the renewals), the
  ``FleetState`` broadcast carries the live engine ranks, and a rank that
  vanishes from it (lease expiry) is treated like a failed probe.
- **Migration.** The router holds every stream's full token history. When
  an engine dies, each of its in-flight routes is resubmitted on a survivor
  as ``prompt + tokens-so-far`` with ``gen_offset = len(tokens)``: the
  engine continues the request's own sampling-key schedule (the key of
  generated token ``g`` depends on its position in the stream, not on the
  engine), so the resumed stream is token-identical to the one the dead
  engine would have produced, greedy or sampled. The handoff crosses a
  ``KvMigrate`` frame (the token history in the exact tok16 packing, the
  dead slot's KV lane on the plane's int8 rung), and the resubmission
  re-prefills from the decoded tokens. The dead attempt's engine key is
  retired under the route lock, so a straggler callback from a
  not-quite-dead engine cannot corrupt the stream.

Overload (shed, brownout, deadline) is inherited from
:class:`~.frontend.ServingFrontend`, with ``_pressure()`` aggregated over
the healthy members only: a half-dead fleet sheds sooner.

:class:`FleetAutoscaler` closes the coordinator's engine-scaling advice
(``Coordinator(on_scale=...)``): up spawns a replica, down retires the
emptiest one after migrating its streams.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from distributed_ml_pytorch_tpu_torch.serving.engine import QueueFullError, ServingEngine
from distributed_ml_pytorch_tpu_torch.serving.frontend import (
    ORPHANED_ENGINE,
    ServingFrontend,
    _Route,
)
from distributed_ml_pytorch_tpu_torch.utils import codecs
from distributed_ml_pytorch_tpu_torch.utils.compress import (
    CODEC_DENSE,
    CompressionError,
    body_crc,
)
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    MessageCode,
    Transport,
    _join16,
    _split16,
)


class EngineMember:
    """One engine replica of the serving fleet.

    Owns the engine's scheduling thread (an ``engine.step()`` loop) and,
    optionally, a :class:`~..coord.member.CoordClient` lease: the member
    joins the coordination star as an ``engine`` and reports its occupancy
    and TTFT on every renewal (``report(occupancy_pct, queue_depth,
    ttft_ms)``, the numbers the coordinator's engine-scaling advice reads).

    ``crash()`` is the chaos hook: the serve loop halts at the next block
    boundary and the renewals stop without a leave, so the coordinator must
    detect the death by lease expiry and the router by its probe.
    """

    def __init__(self, engine_id: int, engine: ServingEngine, *,
                 coord=None, report_interval: float = 0.25,
                 idle_sleep: float = 0.002, throttle: float = 0.0):
        self.engine_id = int(engine_id)
        self.engine = engine
        self.coord = coord
        self.report_interval = float(report_interval)
        self.idle_sleep = float(idle_sleep)
        #: seconds slept after every scheduling round that worked: emulates
        #: a slower accelerator (load shaping for overload and lease-expiry
        #: scenarios)
        self.throttle = float(throttle)
        self._stop = threading.Event()
        self._crashed = False
        #: the serve loop's heartbeat the router's probe reads: monotonic
        #: stamp of the last completed scheduling round
        self.last_beat = time.monotonic()
        self._thread: Optional[threading.Thread] = None

    @property
    def coord_rank(self) -> Optional[int]:
        return None if self.coord is None else self.coord.transport.rank

    @property
    def alive(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self._crashed)

    def start(self) -> "EngineMember":
        if self.coord is not None:
            self.coord.join(timeout=5.0)
        self._thread = threading.Thread(
            target=self._serve, name=f"engine-{self.engine_id}", daemon=True)
        self._thread.start()
        return self

    def _serve(self) -> None:
        next_report = time.monotonic()
        while not self._stop.is_set():
            worked = self.engine.step()
            now = time.monotonic()
            self.last_beat = now
            if self.coord is not None and now >= next_report:
                busy, slots, queued = self.engine.pressure()
                occ_pct = int(100 * (busy + queued) / max(1, slots))
                self.coord.report(min(occ_pct, 10_000), queued,
                                  self.engine.recent_ttft_ms())
                next_report = now + self.report_interval
            if not worked:
                time.sleep(self.idle_sleep)
            elif self.throttle:
                time.sleep(self.throttle)

    def pressure(self) -> Tuple[int, int, int]:
        return self.engine.pressure()

    def stop(self) -> None:
        """Clean shutdown: stop serving and leave the coordination star."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.coord is not None:
            self.coord.close()

    def crash(self) -> None:
        """Silent scripted death (no leave, no further renewals): the
        lease-expiry detection path, like ``ElasticShardServer.crash``."""
        self._crashed = True
        self._stop.set()
        if self.coord is not None:
            self.coord.stop()


class FleetRouter(ServingFrontend):
    """The frontend as a router over N :class:`EngineMember` replicas.

    The wire protocol and client are :class:`ServingFrontend`'s; the engine
    behind a request is a routing decision, made again on engine death.

    ``fleet`` (optional) is the control-plane view: anything with
    ``engine_up()`` (the inherited hold and re-admit) and optionally
    ``live_engine_ranks()``: a member whose coordinator rank disappears from
    the live set (lease expiry) is marked down and its streams migrate, even
    before the local probe fires. ``fleet=None`` fails open: the router
    serves on its own probe alone.

    ``serve_forever`` only sweeps (re-admit, reap, probe, migrate); the
    members' own threads decode, so N replicas decode in parallel.
    """

    def __init__(self, transport: Transport, members: List[EngineMember], *,
                 probe_timeout: float = 2.0, session_affinity: bool = True,
                 **kw):
        if not members:
            raise ValueError("FleetRouter needs at least one EngineMember")
        self.members: Dict[int, EngineMember] = {}
        for m in members:
            if m.engine_id in self.members:
                raise ValueError(f"duplicate engine_id {m.engine_id}")
            if m.engine.on_tokens is not None:
                raise ValueError(f"engine {m.engine_id} already has an on_tokens consumer")
            self.members[m.engine_id] = m
        self.probe_timeout = float(probe_timeout)
        self.session_affinity = bool(session_affinity)
        #: engine_id -> the router's health verdict (True = routable); a
        #: down marking heals on the next good probe
        self._member_up: Dict[int, bool] = {m.engine_id: True for m in members}
        #: coordinator ranks the fleet view ever showed live: lease expiry is
        #: "was there, now is not", never "has not joined yet"
        self._seen_ranks: set = set()
        #: engines the gray plane put on probation: still routable (the
        #: member is alive) but scored with a capacity penalty, so fresh
        #: streams bend away while it recovers (``GrayHealth(on_probation=,
        #: on_clear=)`` drive :meth:`note_gray` and :meth:`clear_gray`)
        self._gray_penalized: set = set()
        self._affinity: Dict[Tuple[int, int], int] = {}
        self.migrations = 0          # streams moved across an engine death
        self.migration_failures = 0  # a healthy survivor refused the stream
        #: an optional flight recorder (``utils/obs.SpanRecorder``): each
        #: migration window lands on the serving timeline beside the
        #: engines' spans; it only observes
        self.recorder = None
        self.parked = 0              # submits parked awaiting any engine
        #: per-death seconds (detection -> resumed), a ring
        self._mttr = collections.deque(maxlen=256)
        #: decoded handoffs parked by the loopback receiver, keyed by the
        #: dying stream's old route key: (token ids, KV lane or None)
        self._handoffs: Dict[int, Tuple[List[int], Optional[np.ndarray]]] = {}
        self.handoffs = 0            # KvMigrate frames shipped and decoded
        self.handoff_drops = 0       # malformed or failed handoff frames
        #: float32 the handoff bodies would cost dense, against what the
        #: coded wire carried (head and body)
        self.handoff_dense_floats = 0
        self.handoff_wire_floats = 0
        for m in members:
            m.engine.on_tokens = self._on_tokens
        super().__init__(None, transport, **kw)

    # --------------------------------------------------------------- routing
    def note_gray(self, engine_id: int) -> None:
        """The gray plane's probation actuator: penalize this engine in the
        routing scores without marking it down. Idempotent; undone by
        :meth:`clear_gray`."""
        self._gray_penalized.add(int(engine_id))

    def clear_gray(self, engine_id: int) -> None:
        self._gray_penalized.discard(int(engine_id))

    def _healthy_members(self) -> List[EngineMember]:
        return [m for eid, m in sorted(self.members.items())
                if self._member_up.get(eid, False)]

    def _pick_engine(self, route: _Route) -> Optional[EngineMember]:
        """Most free KV-slot capacity among the healthy members, with
        session affinity while the pinned engine is healthy and has room."""
        healthy = self._healthy_members()
        if not healthy:
            return None
        scored = []
        for m in healthy:
            busy, slots, queued = m.pressure()
            free = slots - busy - queued
            if m.engine_id in self._gray_penalized:
                # gray probation: half the free capacity, floored at a
                # strict loss so a tie routes elsewhere; with every other
                # engine full the suspect still takes the stream
                free = min(free - 1, free // 2)
            scored.append((free, -m.engine_id, m))
        scored.sort(reverse=True)
        best = scored[0][2]
        if self.session_affinity and route.session:
            pin = self._affinity.get((route.rank, route.session))
            if pin is not None and self._member_up.get(pin, False):
                m = self.members[pin]
                busy, slots, queued = m.pressure()
                if busy + queued < slots:  # the pinned engine has a free slot
                    return m
            if len(self._affinity) > 65536:
                self._affinity.clear()  # bounded: re-pinned on next use
            self._affinity[(route.rank, route.session)] = best.engine_id
        return best

    def _submit_route(self, key: int, route: _Route) -> bool:
        """Route a fresh or a resumed route. ``route.prompt`` and
        ``route.kwargs`` always hold the original request; the submission
        derives from the tokens already streamed, so a stream can migrate
        any number of times and stay anchored to its origin."""
        member = self._pick_engine(route)
        if member is None:
            # no healthy engine right now: park instead of reject, and the
            # sweep resubmits when a member revives (deadline and overload
            # shedding still apply; the client-silence sweep bounds it)
            route.engine_id = ORPHANED_ENGINE
            route.req = None
            self.parked += 1
            return True
        # stable without a lock: a fresh route has no engine yet, and a
        # migrating route was retired first (_take_routes_where)
        had = list(route.tokens)
        kwargs = dict(route.kwargs)
        kwargs["max_new_tokens"] = int(kwargs["max_new_tokens"]) - len(had)
        if had:
            kwargs["gen_offset"] = len(had)
            prompt = np.concatenate([np.asarray(route.prompt, np.int32),
                                     np.asarray(had, np.int32)])
        else:
            prompt = route.prompt
        try:
            route.req = member.engine.submit(prompt, request_id=key, **kwargs)
        except (QueueFullError, ValueError):
            return False
        route.engine_id = member.engine_id
        return True

    def _cancel_route(self, key: int, route: _Route) -> None:
        member = self.members.get(route.engine_id)
        if member is not None:
            member.engine.cancel(key)

    # --------------------------------------------------------- overload plane
    def _pressure(self) -> float:
        busy = queued = slots = 0
        for m in self._healthy_members():
            b, s, q = m.pressure()
            busy, slots, queued = busy + b, slots + s, queued + q
        if slots == 0:
            return 1.0  # no healthy engine: maximally loaded
        return max((busy + queued) / slots, self._wire_pressure())

    def _ttft_now_ms(self) -> float:
        samples = [m.engine.recent_ttft_ms() for m in self._healthy_members()]
        samples = [s for s in samples if s > 0]
        return float(np.mean(samples)) if samples else 0.0

    # ------------------------------------------------------- health, probes
    def _probe(self, now: float) -> None:
        """Liveness over the members: serve-loop beats (the local probe)
        and the coordinator's lease view (the fleet probe)."""
        lease_live = None
        ranks = getattr(self.fleet, "live_engine_ranks", None)
        if ranks is not None:
            lease_live = ranks()
            if lease_live is not None:
                self._seen_ranks |= set(lease_live)
        for eid, m in sorted(self.members.items()):
            up = m.alive and (now - m.last_beat) <= self.probe_timeout
            if up and lease_live is not None and m.coord_rank is not None \
                    and m.coord_rank not in lease_live \
                    and m.coord_rank in self._seen_ranks:
                # the coordinator expired this member's lease: trust it, even
                # if the probe still sees beats
                up = False
            was = self._member_up.get(eid, True)
            if up != was:
                print(f"fleet: engine {eid} state {'down->up' if up else 'up->down'}",
                      file=sys.stderr)
                self._member_up[eid] = up
            if not up:
                # every sweep, not just the transition: a submit racing the
                # up->down edge can land on the dead engine after the
                # transition's snapshot (idempotent: no routes, no work)
                self._migrate_from(eid, now)

    def _migrate_from(self, dead_id: int, now: float) -> None:
        """Move every in-flight stream off a dead engine: retire the old
        engine keys under the route lock, then resubmit each route under a
        fresh key (``_submit_route`` re-prefills prompt + generated-so-far
        with the matching ``gen_offset``)."""
        moving = self._take_routes_where(lambda r: r.engine_id == dead_id and not r.done)
        dead = self.members.get(dead_id)
        resumed = 0
        for old_key, route in moving:
            # the stream's state crosses the KvMigrate wire first (the slot
            # still holds the KV lane until the cancel), and the resubmission
            # re-prefills from the decoded tokens: the tok16 packing is exact
            self._ship_handoff(old_key, route, dead)
            if dead is not None:
                dead.engine.cancel(old_key)  # free its state if it revives
            handoff = self._handoffs.pop(old_key, None)
            if handoff is not None:
                route.tokens = handoff[0]
            new_key = next(self._route_ids)
            if not route.service_lost_at:
                route.service_lost_at = now  # MTTR anchors at detection
            n_had = len(route.tokens)
            if n_had >= int(route.kwargs["max_new_tokens"]):
                # everything was generated; only the done frame is owed
                route.done = True
                route.done_at = now
                self._install_route(new_key, route)
                self._send_frame(route, start=n_had, tokens=[], done=True)
                continue
            self._install_route(new_key, route)
            if not self._submit_route(new_key, route):
                # a healthy survivor refused it: an explicit reject (no
                # survivor at all parks it instead)
                self.migration_failures += 1
                self._drop_route(new_key)
                self._send_to(route.rank, MessageCode.ServeReject,
                              np.asarray([route.rid], np.float32))
            elif route.engine_id != ORPHANED_ENGINE:
                resumed += 1
                self._note_resumed(route)
        if self.recorder is not None and moving:
            self.recorder.event("migrate", corr=0, dead_engine=dead_id, moved=len(moving),
                                resumed=resumed,
                                window_ms=round((time.monotonic() - now) * 1e3, 3))
        if resumed:
            print(f"fleet: migrated {resumed}/{len(moving)} stream(s) off engine {dead_id} "
                  f"in {(time.monotonic() - now) * 1e3:.1f} ms", file=sys.stderr)

    # ------------------------------------------------------ KvMigrate wire
    def _ship_handoff(self, old_key: int, route: _Route,
                      dead: Optional[EngineMember]) -> None:
        """Encode one dying stream's resumable state as a ``KvMigrate``
        frame and put it on the loopback wire: the token history in the
        exact tok16 packing (two u16 ids a float; the resubmission
        re-prefills from it), and the dead engine's KV lane on the plane's
        ``kv_quant`` rung (int8 per-block absmax), named by the head's codec
        field."""
        tokens = np.asarray(route.tokens, np.float32)
        try:
            tok_body = (codecs.Tok16Codec().encode(tokens)
                        if tokens.size else np.zeros(0, np.float32))
        except (CompressionError, ValueError):
            self.handoff_drops += 1
            return
        kv = None
        if dead is not None:
            try:
                kv = dead.engine.kv_lane(old_key)
            except Exception:  # noqa: BLE001 — a dying engine may throw
                kv = None
        if kv is not None and kv.size and np.isfinite(kv).all():
            cid, kv_body = codecs.encode_body(MessageCode.KvMigrate, kv)
            n_kv = int(kv.size)
        else:
            cid, kv_body, n_kv = CODEC_DENSE, np.zeros(0, np.float32), 0
        body = np.concatenate([tok_body, kv_body])
        crc = body_crc(body)
        head = np.asarray([float(cid), *_split16(old_key), *_split16(int(tokens.size)),
                           *_split16(n_kv), *_split16(crc)], np.float32)
        self.handoff_dense_floats += int(tokens.size) + n_kv
        self.handoff_wire_floats += int(head.size) + int(body.size)
        self._send_handoff(MessageCode.KvMigrate, np.concatenate([head, body]))

    def _send_handoff(self, code: MessageCode, frame: np.ndarray) -> None:
        """The handoff wire is an in-process loopback (migrations stay
        inside the router), but the frame is real: everything the resumed
        stream needs crosses it encoded."""
        self._on_handoff(0, code, frame)

    def _on_handoff(self, sender: int, code: MessageCode, payload: np.ndarray) -> None:
        if code == MessageCode.KvMigrate and payload.size >= 10:
            if not np.isfinite(payload[:9]).all():
                self.handoff_drops += 1
                return
            cid = int(payload[0])
            key = _join16(payload[1], payload[2])
            n_tok = _join16(payload[3], payload[4])
            n_kv = _join16(payload[5], payload[6])
            crc = _join16(payload[7], payload[8])
            body = payload[9:]
            # the integrity gate before paying for a decode
            if body_crc(body) != crc:
                self.handoff_drops += 1
                return
            tw = codecs.Tok16Codec().wire_floats(n_tok)
            try:
                toks = codecs.Tok16Codec().decode(body[:tw], n_tok, 0)
                kv = (codecs.decode_body(MessageCode.KvMigrate, cid, body[tw:], n_kv)
                      if n_kv else None)
            except CompressionError:
                self.handoff_drops += 1
                return
            if kv is not None and not np.isfinite(kv).all():
                self.handoff_drops += 1
                return
            self._handoffs[key] = ([int(t) for t in toks], kv)
            self.handoffs += 1

    def _note_resumed(self, route: _Route) -> None:
        """Close one stream's outage window: count the migration and record
        detection -> back in service as its MTTR sample."""
        self.migrations += 1
        if route.service_lost_at:
            self._mttr.append(time.monotonic() - route.service_lost_at)
            route.service_lost_at = 0.0

    def mttr_s(self) -> Optional[float]:
        """Mean seconds from death detection to the stream resubmitted (None
        until a migration happened): the migration MTTR."""
        return float(np.mean(self._mttr)) if self._mttr else None

    def _retry_parked(self) -> None:
        """Resubmit the routes parked while no engine was healthy. A route
        that stays parked waits for the next sweep; a healthy engine
        refusing the work (queue full, unfittable) is a real reject."""
        if not self._healthy_members():
            return
        parked = self._routes_where(lambda r: r.engine_id == ORPHANED_ENGINE and not r.done)
        for key, route in parked:
            in_flight = bool(route.tokens)
            if not self._submit_route(key, route):
                self.migration_failures += 1
                self._drop_route(key)
                self._send_to(route.rank, MessageCode.ServeReject,
                              np.asarray([route.rid], np.float32))
            elif in_flight and route.engine_id != ORPHANED_ENGINE:
                # an in-flight stream back in service: its MTTR sample spans
                # the whole outage
                self._note_resumed(route)

    # ----------------------------------------------------- elastic membership
    def add_member(self, member: EngineMember) -> None:
        """Admit a new replica mid-run (the autoscaler's scale-up): the
        constructor's wiring (a unique id, the router owns ``on_tokens``),
        healthy until a probe says otherwise. The member should already be
        started."""
        if member.engine_id in self.members:
            raise ValueError(f"duplicate engine_id {member.engine_id}")
        if member.engine.on_tokens is not None:
            raise ValueError(f"engine {member.engine_id} already has an on_tokens consumer")
        member.engine.on_tokens = self._on_tokens
        self.members[member.engine_id] = member
        self._member_up[member.engine_id] = True
        print(f"fleet: engine {member.engine_id} admitted (scale-up)", file=sys.stderr)

    def remove_member(self, engine_id: int) -> Optional[EngineMember]:
        """Retire a replica mid-run (scale-down, slot revoke): mark it down,
        migrate its in-flight streams to survivors first, then stop it
        cleanly. The removed member, or None for an unknown id."""
        member = self.members.get(engine_id)
        if member is None:
            return None
        now = time.monotonic()
        self._member_up[engine_id] = False
        self._migrate_from(engine_id, now)
        member.stop()
        del self.members[engine_id]
        self._member_up.pop(engine_id, None)
        print(f"fleet: engine {engine_id} retired (scale-down)", file=sys.stderr)
        return member

    # ------------------------------------------------------------------ loop
    def _sweep(self, now: float) -> None:
        self._probe(now)
        self._retry_parked()
        super()._sweep(now)

    def serve_forever(self, idle_sleep: float = 0.02, sweep_every: float = 0.1) -> None:
        """The sweep loop only: decoding runs on the members' own threads."""
        while not self._stop.is_set():
            self._sweep(time.monotonic())
            time.sleep(min(idle_sleep, sweep_every))

    def stop(self) -> None:
        super().stop()
        for m in self.members.values():
            if m.alive:
                m.stop()

    def fleet_summary(self) -> dict:
        """Router-level counters for benches and the CLI's exit report."""
        return {
            "engines": {eid: {"up": self._member_up.get(eid, False), "alive": m.alive,
                              "pressure": m.pressure()}
                        for eid, m in sorted(self.members.items())},
            "migrations": self.migrations,
            "migration_failures": self.migration_failures,
            "handoffs": self.handoffs,
            "handoff_drops": self.handoff_drops,
            "handoff_dense_floats": self.handoff_dense_floats,
            "handoff_wire_floats": self.handoff_wire_floats,
            "parked": self.parked,
            "mttr_s": self.mttr_s(),
            "shed": self.shed,
            "brownouts": self.brownouts,
            "reaped": self.reaped,
            "held_peak": self.held_peak,
        }


class FleetAutoscaler:
    """The serving side's actuator of the coordinator's engine-scaling
    advice (``check_engine_scaling``).

    Wire :meth:`on_scale` as the coordinator's ``on_scale`` callback (or
    call it from a node agent's ``SlotGrant`` handler): **up** spawns a
    replica through ``member_factory`` (an unstarted ``EngineMember``),
    starts it and admits it to the router; **down** retires the emptiest
    replica (its streams migrate first). ``min_engines`` and
    ``max_engines`` bound the fleet.

    Scale-up MTTR (advice fired -> the new replica's serve loop beating) is
    sampled per spawn in ``scale_up_mttr_s`` at the next :meth:`poll`.
    """

    def __init__(self, router: FleetRouter, member_factory, *,
                 min_engines: int = 1, max_engines: int = 8,
                 clock=time.monotonic):
        self.router = router
        self.member_factory = member_factory  # () -> EngineMember (unstarted)
        self.min_engines = int(min_engines)
        self.max_engines = int(max_engines)
        self._clock = clock
        self.scaled_up = 0
        self.scaled_down = 0
        self.refused = 0
        self.scale_up_mttr_s = collections.deque(maxlen=256)
        self._pending_up: List[Tuple[float, int, float]] = []  # (t0, eid, beat0)
        self._spawning = 0  # scale-ups in flight, counted toward the max
        self._retiring = 0
        self._workers: List[threading.Thread] = []
        self._mu = threading.Lock()

    def on_scale(self, direction: str, detail: dict) -> None:
        """The coordinator's ``on_scale`` callback. It runs on the
        coordinator's serve thread, and a spawn is slow (the model build and
        the coordinator join, which waits on that very thread), so this only
        admits the decision under the bounds; the work runs on a short-lived
        thread that :meth:`quiesce` joins."""
        with self._mu:
            n = len(self.router.members)
            if direction == "up":
                if n + self._spawning >= self.max_engines:
                    self.refused += 1
                    return
                self._spawning += 1
                worker = threading.Thread(target=self._spawn, args=(self._clock(),),
                                          name="fleet-scale-up", daemon=True)
            elif direction == "down":
                victim = self._emptiest()
                if n - self._retiring <= self.min_engines or victim is None:
                    self.refused += 1
                    return
                self._retiring += 1
                worker = threading.Thread(target=self._retire, args=(victim.engine_id,),
                                          name="fleet-scale-down", daemon=True)
            else:
                return
            self._workers.append(worker)
        worker.start()

    def _spawn(self, t0: float) -> None:
        try:
            member = self.member_factory()
            member.start()
            with self._mu:
                self.router.add_member(member)
                self.scaled_up += 1
                self._pending_up.append((t0, member.engine_id, member.last_beat))
        finally:
            with self._mu:
                self._spawning -= 1

    def _retire(self, engine_id: int) -> None:
        try:
            if self.router.remove_member(engine_id) is not None:
                with self._mu:
                    self.scaled_down += 1
        finally:
            with self._mu:
                self._retiring -= 1

    def quiesce(self, timeout: float = 10.0) -> bool:
        """Join the outstanding spawn and retire threads."""
        deadline = time.monotonic() + timeout
        while True:
            with self._mu:
                self._workers = [w for w in self._workers if w.is_alive()]
                live = list(self._workers)
            if not live:
                return True
            if time.monotonic() >= deadline:
                return False
            live[0].join(timeout=0.05)

    def _emptiest(self) -> Optional[EngineMember]:
        """The least-loaded member (retiring it migrates the fewest
        streams); never the only member."""
        candidates = []
        for eid, m in sorted(self.router.members.items()):
            busy, _slots, queued = m.pressure()
            candidates.append((busy + queued, eid, m))
        if len(candidates) <= 1:
            return None
        candidates.sort()
        return candidates[0][2]

    def poll(self) -> None:
        """Close the pending scale-up MTTR samples: a spawned member whose
        serve loop has beaten since the spawn is in service."""
        with self._mu:
            still = []
            for t0, eid, beat0 in self._pending_up:
                m = self.router.members.get(eid)
                if m is None:
                    continue  # retired before it ever served
                if m.last_beat > beat0:
                    self.scale_up_mttr_s.append(m.last_beat - t0)
                else:
                    still.append((t0, eid, beat0))
            self._pending_up = still

    def summary(self) -> dict:
        self.poll()
        with self._mu:
            return {
                "scaled_up": self.scaled_up,
                "scaled_down": self.scaled_down,
                "refused": self.refused,
                "scale_up_mttr_s": list(self.scale_up_mttr_s),
                "n_engines": len(self.router.members),
            }
