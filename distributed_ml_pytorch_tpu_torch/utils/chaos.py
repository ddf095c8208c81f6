"""Deterministic fault injection for the PS and coordinator planes
(counterpart of the JAX ``utils/chaos.py``; numpy and threads only).

- :class:`FaultRule` / :class:`ChaosPlan` — a fault script matched per
  ``(src, dst, MessageCode)`` channel: drop, delay, duplicate, reorder,
  corrupt, each with its own probability, optionally windowed to a range of
  that channel's send indices (``after``/``until``); :class:`WeatherRule`
  (latency, jitter, a bandwidth cap), :class:`SDCRule` (silent corruption
  of the numeric payload, re-stamped so the wire cannot see it) and
  :class:`GrayRule` (one-way partitions, lossy links, injected stalls).
- :class:`FaultyTransport` — wraps any transport and applies the plan on
  the send path. Every channel owns its own seeded generator
  (``SeedSequence([seed, src, dst, code])``) and draws the same number of
  uniforms per send, so the decision for channel send #i is a pure function
  of the plan, whatever the threads do — and the same bits as the JAX
  package's for the same plan.
- :class:`ChaosLog` — which faults fired, as ``(src, dst, code,
  channel_index, kind)``; :meth:`ChaosLog.lines` renders them sorted by
  channel and index, so two runs of one seeded scenario give byte-identical
  logs.

A scenario whose per-channel send sequences are deterministic (fixed step
counts and cadences) therefore has a deterministic fault log.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    SERVER_RANK,
    MessageCode,
    Transport,
)


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One matcher + fault mix. ``None`` fields are wildcards; ``after`` /
    ``until`` window the rule to that channel's send indices [after, until).
    The first matching rule of a plan wins (rules are an ordered script)."""

    src: Optional[int] = None
    dst: Optional[int] = None
    code: Optional[int] = None          # MessageCode value, or None = any
    drop: float = 0.0                   # P(frame never forwarded)
    dup: float = 0.0                    # P(frame forwarded twice)
    reorder: float = 0.0                # P(frame held until the channel's next send)
    corrupt: float = 0.0                # P(payload bytes corrupted in flight)
    delay: float = 0.0                  # seconds each delayed frame is held
    delay_p: float = 0.0                # P(frame delayed by `delay`)
    after: int = 0
    until: Optional[int] = None

    def matches(self, src: int, dst: int, code: int, index: int) -> bool:
        if self.src is not None and src != self.src:
            return False
        if self.dst is not None and dst != self.dst:
            return False
        if self.code is not None and code != int(self.code):
            return False
        if index < self.after:
            return False
        if self.until is not None and index >= self.until:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class WeatherRule:
    """Network weather on one direction of a link: latency with
    jitter, and a bandwidth cap that serializes frames through the link.

    Matching is directional (``src -> dst``), so a ONE-WAY degraded link —
    the asymmetry that RTT estimators and circuit breakers must survive —
    is just a rule on one direction. ``None`` fields are wildcards;
    ``after``/``until`` window the rule to the channel's send indices, like
    :class:`FaultRule`. Weather composes with fault rules: loss/dup/corrupt
    come from the fault mix, latency/bandwidth from here.

    Determinism: each frame's latency is ``latency + jitter * u`` with
    ``u ~ U(-1, 1)`` drawn from a per-channel seeded stream SEPARATE from
    the fault stream (``SeedSequence([seed, src, dst, code, _WEATHER_NS])``)
    so adding weather never perturbs an existing plan's fault decisions.
    The drawn delay is recorded in the :class:`ChaosLog` quantized to
    milliseconds — byte-identical logs prove the DRAWS replay, not just
    the match counts. Bandwidth queueing delay depends on wall-clock
    arrival times and is deliberately NOT logged.
    """

    src: Optional[int] = None
    dst: Optional[int] = None
    code: Optional[int] = None          # MessageCode value, or None = any
    latency: float = 0.0                # base one-way delay, seconds
    jitter: float = 0.0                 # +/- uniform jitter, seconds
    bandwidth: float = 0.0              # bytes/second cap; 0 = unlimited
    after: int = 0
    until: Optional[int] = None

    def matches(self, src: int, dst: int, code: int, index: int) -> bool:
        if self.src is not None and src != self.src:
            return False
        if self.dst is not None and dst != self.dst:
            return False
        if self.code is not None and code != int(self.code):
            return False
        if index < self.after:
            return False
        if self.until is not None and index >= self.until:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class SDCRule:
    """Silent data corruption of the NUMERIC payload on one channel:
    bit-flip / scale / NaN injection that the wire layer CANNOT catch.

    Unlike :class:`FaultRule.corrupt` — which mangles the frame in flight
    so the reliability CRC drops it and the retry heals it — an SDC rule
    models corruption in the *sender's memory*, upstream of the envelope:
    it is applied AFTER envelope stamping and the envelope checksum is
    re-computed over the corrupted body, so the frame arrives bit-perfect
    on the wire and only the receiver's admission gate / the health plane
    can see it. ``code`` matches the INNER message code (the
    ``ReliableFrame`` envelope is looked through); plain un-enveloped
    frames are corrupted directly.

    ``skip`` preserves the first N floats of the inner payload (protocol
    stamps — e.g. 6 for ``ShardPush``'s version/range head): the model is
    a corrupted gradient *buffer*, not a corrupted protocol header.

    Determinism: for enveloped frames the decision + draws are a pure
    function of ``(plan.seed, src, dst, inner_code, envelope_seq)`` — a
    retransmission re-derives the SAME corruption (the poison lives in the
    sender's pending buffer) and is logged once, so the :class:`ChaosLog`
    stays byte-identical however retries interleave. Plain frames use a
    per-channel counter like fault rules. Either way the draws come from
    their own seeded stream (``_SDC_NS``), so adding SDC rules never
    perturbs an existing plan's fault or weather decisions.

    Note: assumes the default reliability envelope checksum; a
    ``legacy_envelope=True`` transport pair would drop the re-stamped
    frame (and the SDC would degrade into ordinary wire corruption).
    """

    src: Optional[int] = None
    dst: Optional[int] = None
    code: Optional[int] = None          # INNER MessageCode, or None = any
    p: float = 0.0                      # P(payload silently corrupted)
    kind: str = "bitflip"               # "bitflip" | "scale" | "nan"
    factor: float = -4.0                # scale multiplier (kind="scale")
    skip: int = 0                       # head floats left untouched
    after: int = 0
    until: Optional[int] = None

    def __post_init__(self):
        if self.kind not in ("bitflip", "scale", "nan"):
            raise ValueError(f"unknown SDC kind: {self.kind!r}")

    def matches(self, src: int, dst: int, code: int, index: int) -> bool:
        if self.src is not None and src != self.src:
            return False
        if self.dst is not None and dst != self.dst:
            return False
        if self.code is not None and code != int(self.code):
            return False
        if index < self.after:
            return False
        if self.until is not None and index >= self.until:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class GrayRule:
    """A scheduled GRAY failure: the member stays alive and keeps
    renewing its lease while its data plane rots. Three kinds:

    - ``"partition"`` — a windowed ONE-WAY partition: every matching frame
      vanishes (the rule form of the imperative
      :meth:`FaultyTransport.partition`, so asymmetric partitions are
      schedulable in ChaosPlan JSON and replayable from counterexamples).
    - ``"lossy"`` — a sustained drop-rate link: each matching frame is
      dropped with probability ``p`` (a flaky NIC, not a dead one).
    - ``"stall"`` — an injected serve-side stall (fsync, serve-loop):
      matched not on a wire channel but on a per-``(rank, site)`` operation
      counter via :meth:`FaultyTransport.gray_stall`; each matching op
      sleeps ``stall_ms`` with probability ``p``. ``src`` is the stalled
      rank (``None`` = any), ``dst``/``code`` are ignored.

    Determinism: gray drop decisions come from their own per-channel seeded
    stream (``SeedSequence([seed, src, dst, code, _GRAY_NS])``) and stall
    draws from a per-``(rank, site)`` stream, so adding gray rules never
    perturbs an existing plan's fault/weather/SDC decisions — the logs of plans
    without gray rules stay byte-identical. ``after``/``until`` window on the
    channel's send index (or the site's op index for stalls), like every
    other rule kind.
    """

    kind: str = "partition"             # "partition" | "lossy" | "stall"
    src: Optional[int] = None
    dst: Optional[int] = None
    code: Optional[int] = None          # MessageCode value, or None = any
    p: float = 1.0                      # drop/stall probability
    stall_ms: float = 0.0               # sleep per stalled op (kind="stall")
    site: str = ""                      # stall site label, e.g. "fsync"
    after: int = 0
    until: Optional[int] = None

    def __post_init__(self):
        if self.kind not in ("partition", "lossy", "stall"):
            raise ValueError(f"unknown gray kind: {self.kind!r}")

    def matches(self, src: int, dst: int, code: int, index: int) -> bool:
        if self.src is not None and src != self.src:
            return False
        if self.dst is not None and dst != self.dst:
            return False
        if self.code is not None and code != int(self.code):
            return False
        if index < self.after:
            return False
        if self.until is not None and index >= self.until:
            return False
        return True


#: namespace tag separating the weather RNG stream from the fault stream
_WEATHER_NS = 0x57454154  # "WEAT"

#: namespace tag for the SDC draw stream (separate from faults AND weather)
_SDC_NS = 0x53444331  # "SDC1"

#: namespace tag for the gray-failure draw stream (separate from all three)
_GRAY_NS = 0x47524159  # "GRAY"


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """An ordered fault script plus the seed every channel RNG derives
    from; ``weather`` adds link-level latency/jitter/bandwidth rules,
    ``sdc`` adds payload-numeric silent-corruption rules, and
    ``gray`` adds gray-failure rules — one-way partitions, sustained-loss
    links, injected stalls."""

    rules: Tuple[FaultRule, ...] = ()
    seed: int = 0
    weather: Tuple[WeatherRule, ...] = ()
    sdc: Tuple[SDCRule, ...] = ()
    gray: Tuple[GrayRule, ...] = ()

    def __init__(self, rules: Sequence[FaultRule] = (), seed: int = 0,
                 weather: Sequence[WeatherRule] = (),
                 sdc: Sequence[SDCRule] = (),
                 gray: Sequence[GrayRule] = ()):
        object.__setattr__(self, "rules", tuple(rules))
        object.__setattr__(self, "seed", int(seed))
        object.__setattr__(self, "weather", tuple(weather))
        object.__setattr__(self, "sdc", tuple(sdc))
        object.__setattr__(self, "gray", tuple(gray))

    def rule_for(self, src: int, dst: int, code: int, index: int) -> Optional[FaultRule]:
        for rule in self.rules:
            if rule.matches(src, dst, code, index):
                return rule
        return None

    def weather_for(self, src: int, dst: int, code: int,
                    index: int) -> Optional[WeatherRule]:
        for rule in self.weather:
            if rule.matches(src, dst, code, index):
                return rule
        return None

    def sdc_for(self, src: int, dst: int, code: int,
                index: int) -> Optional[SDCRule]:
        for rule in self.sdc:
            if rule.matches(src, dst, code, index):
                return rule
        return None

    def gray_for(self, src: int, dst: int, code: int,
                 index: int) -> Optional[GrayRule]:
        """First matching WIRE gray rule (partition/lossy); stall rules
        match op counters, not send channels — see :meth:`stall_for`."""
        for rule in self.gray:
            if rule.kind != "stall" and rule.matches(src, dst, code, index):
                return rule
        return None

    def stall_for(self, rank: int, site: str,
                  index: int) -> Optional[GrayRule]:
        """First matching stall rule for op #``index`` at ``(rank, site)``."""
        for rule in self.gray:
            if (rule.kind == "stall" and rule.site == site
                    and (rule.src is None or rule.src == rank)
                    and index >= rule.after
                    and (rule.until is None or index < rule.until)):
                return rule
        return None


#: rule kinds of a serialized plan, in field order — the JSON round-trip
#: is what lets a plan travel between the two packages, and between a
#: counterexample and a replay, as plain JSON
_RULE_KINDS = (("rules", FaultRule), ("weather", WeatherRule),
               ("sdc", SDCRule), ("gray", GrayRule))


def plan_to_json(plan: ChaosPlan) -> dict:
    """A :class:`ChaosPlan` as a plain-JSON dict (dataclass fields only,
    defaults omitted) — the counterexample interchange format. Inverse of
    :func:`plan_from_json`; ``plan_from_json(plan_to_json(p)) == p``."""
    out: dict = {"seed": plan.seed}
    for key, cls in _RULE_KINDS:
        rows = []
        for rule in getattr(plan, key):
            row = {}
            for f in dataclasses.fields(cls):
                val = getattr(rule, f.name)
                if val != f.default:
                    row[f.name] = val
            rows.append(row)
        if rows:
            out[key] = rows
    return out


def plan_from_json(data: dict) -> ChaosPlan:
    """Rebuild a :class:`ChaosPlan` from :func:`plan_to_json` output.
    Unknown keys fail loudly (a typo'd field must not silently weaken a
    replayed counterexample into a no-op plan)."""
    known = {key for key, _cls in _RULE_KINDS} | {"seed"}
    extra = set(data) - known
    if extra:
        raise ValueError(f"unknown ChaosPlan fields: {sorted(extra)}")
    kw: dict = {"seed": int(data.get("seed", 0))}
    for key, cls in _RULE_KINDS:
        rows = data.get(key, [])
        names = {f.name for f in dataclasses.fields(cls)}
        rules = []
        for row in rows:
            bad = set(row) - names
            if bad:
                raise ValueError(
                    f"unknown {cls.__name__} fields: {sorted(bad)}")
            rules.append(cls(**row))
        kw[key] = tuple(rules)
    return ChaosPlan(kw["rules"], kw["seed"], kw["weather"], kw["sdc"],
                     kw["gray"])


class ChaosLog:
    """Thread-safe record of every fault that fired.

    Events are ``(src, dst, code, channel_index, kind)``. :meth:`lines`
    sorts them canonically — by channel then index — so the rendering is a
    pure function of WHICH faults fired, not of when threads ran, so
    two runs of one seeded scenario render byte-identical logs.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Tuple[int, int, int, int, str]] = []

    def record(self, src: int, dst: int, code: int, index: int, kind: str) -> None:
        with self._lock:
            self._events.append((src, dst, int(code), index, kind))

    def events(self) -> List[Tuple[int, int, int, int, str]]:
        with self._lock:
            return list(self._events)

    def lines(self) -> str:
        rows = sorted(self.events())
        out = []
        for src, dst, code, index, kind in rows:
            try:
                name = MessageCode(code).name
            except ValueError:
                name = str(code)
            out.append(f"{src}->{dst} {name} #{index} {kind}")
        return "\n".join(out) + ("\n" if out else "")

    def counts(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for *_chan, kind in self.events():
            c[kind] = c.get(kind, 0) + 1
        return c

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


class _WorldState:
    """Shared across one world's wrappers: which ranks are scripted dead."""

    def __init__(self):
        self.crashed: set = set()
        self.lock = threading.Lock()


class _Channel:
    __slots__ = ("index", "rng", "weather_rng", "gray_rng", "held")

    def __init__(self, seed: int, src: int, dst: int, code: int):
        self.index = 0
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed & 0xFFFFFFFF, src, dst, code]))
        #: separate stream for weather draws: adding weather to a plan must
        #: never perturb the fault decisions an existing seed produces
        self.weather_rng = np.random.default_rng(
            np.random.SeedSequence(
                [seed & 0xFFFFFFFF, src, dst, code, _WEATHER_NS]))
        #: separate stream for gray drop draws — same contract
        self.gray_rng = np.random.default_rng(
            np.random.SeedSequence(
                [seed & 0xFFFFFFFF, src, dst, code, _GRAY_NS]))
        #: reorder buffer: (payload, weather_u, fault_index) of the held frame
        self.held: Optional[tuple] = None


class FaultyTransport(Transport):
    """A :class:`Transport` that injects the plan's faults on ``send``.

    Faults apply on the SEND side, which makes a one-way partition natural
    (each endpoint owns its outbound direction) and keeps the receive path
    byte-honest — what arrives is exactly what the faulted wire delivered.
    """

    def __init__(
        self,
        inner: Transport,
        plan: ChaosPlan,
        log: Optional[ChaosLog] = None,
        world: Optional[_WorldState] = None,
    ):
        self.inner = inner
        self.rank = inner.rank
        self.plan = plan
        self.log = log if log is not None else ChaosLog()
        self._world = world if world is not None else _WorldState()
        self._channels: Dict[Tuple[int, int, int], _Channel] = {}
        #: SDC bookkeeping: per-(inner-code) counters for PLAIN
        #: frames, and the already-logged frame identities so an enveloped
        #: frame's retransmits re-derive the same corruption without
        #: re-logging (the log must not depend on retry timing)
        self._sdc_counts: Dict[Tuple[int, int, int], int] = {}
        self._sdc_logged: set = set()
        #: gray stall bookkeeping: per-site op counters + draw
        #: streams, keyed by the stall site label ("fsync", "serve", ...)
        self._stall_counts: Dict[str, int] = {}
        self._stall_rngs: Dict[str, np.random.Generator] = {}
        self._lock = threading.Lock()
        self._partitioned: set = set()  # dsts this endpoint cannot reach
        self._link_busy: Dict[int, float] = {}  # bandwidth-cap serialization
        self._delayed: list = []        # heap of (deliver_at, tiebreak, code, frame, dst)
        self._delay_seq = 0
        self._delay_wake = threading.Event()
        self._closed = False
        self._delay_thread: Optional[threading.Thread] = None

    @classmethod
    def wrap_world(
        cls,
        world: Dict[int, Transport],
        plan: ChaosPlan,
        log: Optional[ChaosLog] = None,
    ) -> Tuple[Dict[int, "FaultyTransport"], ChaosLog]:
        """Wrap every rank of an in-process world with one shared log and
        one shared crash-script state; returns ``(wrapped_world, log)``."""
        log = log if log is not None else ChaosLog()
        state = _WorldState()
        return (
            {r: cls(t, plan, log=log, world=state) for r, t in world.items()},
            log,
        )

    # ------------------------------------------------------ chaos scripting
    def sibling(self, inner: Transport) -> "FaultyTransport":
        """Wrap a LATE-JOINING member's transport with this wrapper's plan,
        log and crash-script state — the elastic-membership analog
        of :meth:`wrap_world`, for worlds whose membership is elastic: a
        worker that joins mid-run gets the same seeded fault regime and is
        visible to the same ``crash_rank`` scripting as everyone else."""
        return FaultyTransport(inner, self.plan, log=self.log,
                               world=self._world)

    def crash_rank(self, rank: int) -> None:
        """Script a crash of ANY rank of this world (not just this
        endpoint): coordinator-aware chaos scripts crash members by id from
        one place instead of needing each member's own wrapper in hand."""
        with self._world.lock:
            self._world.crashed.add(rank)

    def restart_rank(self, rank: int) -> None:
        with self._world.lock:
            self._world.crashed.discard(rank)

    def partition(self, dst: int) -> None:
        """One-way partition: this endpoint's frames toward ``dst`` vanish
        (logged); the reverse direction is untouched."""
        self._partitioned.add(dst)

    def heal(self, dst: int) -> None:
        self._partitioned.discard(dst)

    def crash(self) -> None:
        """Scripted crash of THIS endpoint: its sends raise
        ``ConnectionError`` (like a dead TCP socket), peers' sends to it
        raise too, and its ``recv`` returns ``None``."""
        with self._world.lock:
            self._world.crashed.add(self.rank)

    def restart(self) -> None:
        """Scripted restart: the endpoint serves again (rejoin flows —
        worker ``rejoin=True`` pulls, server ``maybe_restore`` — are the
        caller's script)."""
        with self._world.lock:
            self._world.crashed.discard(self.rank)

    def _is_crashed(self, rank: int) -> bool:
        with self._world.lock:
            return rank in self._world.crashed

    # ----------------------------------------------------------- gray stalls
    def gray_stall(self, site: str) -> float:
        """Gray stall injection point (kind="stall"): serve loops
        and fsync paths call this once per operation; the op increments a
        per-``(rank, site)`` counter, a matching stall rule fires with
        probability ``p`` on its own seeded stream, and the caller sleeps
        the returned seconds (0.0 = no stall). Fired stalls are logged as
        ``gray-stall-<site>`` events with code ``-1`` (no wire channel),
        quantized to the rule's scripted ``stall_ms`` — so for scripts
        whose op sequences are deterministic the log replays exactly.

        Determinism caveat: op indices are deterministic only where the op
        SEQUENCE is (fixed step counts / cadences). Wall-clock-paced serve
        loops should pin stall determinism in direct-call unit tests and
        use partition/lossy rules for byte-identical drill acceptance."""
        if not self.plan.gray:
            return 0.0
        with self._lock:
            i = self._stall_counts.get(site, 0)
            self._stall_counts[site] = i + 1
            rng = self._stall_rngs.get(site)
            if rng is None:
                tag = int.from_bytes(
                    site.encode()[:4].ljust(4, b"\0"), "big")
                rng = self._stall_rngs[site] = np.random.default_rng(
                    np.random.SeedSequence(
                        [self.plan.seed & 0xFFFFFFFF, self.rank, tag,
                         _GRAY_NS]))
            su = float(rng.uniform())
        rule = self.plan.stall_for(self.rank, site, i)
        if rule is None or su >= rule.p or rule.stall_ms <= 0:
            return 0.0
        self.log.record(self.rank, self.rank, -1, i, f"gray-stall-{site}")
        return rule.stall_ms / 1000.0

    # --------------------------------------------------------------- faults
    def _channel(self, dst: int, code: int) -> _Channel:
        key = (self.rank, dst, code)
        with self._lock:
            chan = self._channels.get(key)
            if chan is None:
                chan = self._channels[key] = _Channel(
                    self.plan.seed, self.rank, dst, code)
            return chan

    def _corrupted(self, payload: np.ndarray, chan: _Channel) -> np.ndarray:
        arr = np.array(payload, dtype=np.float32, copy=True).ravel()
        if arr.size == 0:
            # an empty frame corrupts into one garbage element — detectable
            # (CRC) and harmful (a parser expecting emptiness sees bytes)
            return np.asarray([np.float32(np.nan)], np.float32)
        k = chan.index % arr.size
        bits = arr.view(np.uint32).copy()
        bits[k] ^= np.uint32(0x5A5A5A5A)
        return bits.view(np.float32)

    def send(self, code: MessageCode, payload: np.ndarray, dst: int = SERVER_RANK) -> None:
        if self._is_crashed(self.rank):
            raise ConnectionError(f"chaos: rank {self.rank} is crashed")
        if self._is_crashed(dst):
            raise ConnectionError(f"chaos: peer {dst} is crashed")
        code = MessageCode(code)
        if self.plan.sdc:
            # silent data corruption rides FIRST — it models the sender's
            # memory going bad before the wire, and its draws live on their
            # own stream so it never perturbs the fault/weather decisions
            payload = self._maybe_sdc(code, payload, dst)
        chan = self._channel(dst, int(code))
        with self._lock:
            i = chan.index
            chan.index += 1
            # fixed draw schedule: every send consumes the same number of
            # uniforms, so decision i is independent of earlier outcomes;
            # the weather draw rides the same critical section so frame i's
            # latency is paired with frame i regardless of thread timing
            u = chan.rng.uniform(size=5)
            wu = (float(chan.weather_rng.uniform(-1.0, 1.0))
                  if self.plan.weather else 0.0)
            # the gray draw is conditional on the plan carrying gray rules
            # (like weather): a plan without gray rules consumes
            # exactly the uniforms it would without this draw, so its logs stay byte-identical
            gu = (float(chan.gray_rng.uniform())
                  if self.plan.gray else 1.0)
        if dst in self._partitioned:
            self.log.record(self.rank, dst, int(code), i, "partition-drop")
            return
        gray = (self.plan.gray_for(self.rank, dst, int(code), i)
                if self.plan.gray else None)
        if gray is not None:
            if gray.kind == "partition":
                self.log.record(self.rank, dst, int(code), i,
                                "gray-partition")
                return
            if gu < gray.p:  # kind == "lossy"
                self.log.record(self.rank, dst, int(code), i, "gray-drop")
                return
        rule = self.plan.rule_for(self.rank, dst, int(code), i)
        if rule is None:
            self._forward(code, payload, dst, chan, wu, i)
            return
        if u[0] < rule.drop:
            self.log.record(self.rank, dst, int(code), i, "drop")
            return
        if u[3] < rule.corrupt:
            self.log.record(self.rank, dst, int(code), i, "corrupt")
            payload = self._corrupted(payload, chan)
        if u[4] < rule.delay_p and rule.delay > 0:
            # an explicit fault delay supersedes weather for this frame
            # (its delay is already scripted and logged)
            self.log.record(self.rank, dst, int(code), i, "delay")
            self._schedule_delayed(code, payload, dst, rule.delay)
            return
        if u[2] < rule.reorder:
            # hold this frame; it rides out right after the channel's next
            # send (an adjacent swap — the minimal, deterministic reorder)
            self.log.record(self.rank, dst, int(code), i, "reorder-hold")
            with self._lock:
                prev, chan.held = chan.held, (np.array(
                    payload, dtype=np.float32, copy=True).ravel(), wu, i)
            if prev is not None:
                self._transmit(code, prev[0], dst, prev[1], prev[2])
            return
        self._forward(code, payload, dst, chan, wu, i)
        if u[1] < rule.dup:
            self.log.record(self.rank, dst, int(code), i, "dup")
            # the duplicate shares frame i's weather draw (one latency per
            # decision keeps the log a pure function of the seed)
            self._transmit(code, payload, dst, wu, i, log_weather=False)

    def _maybe_sdc(self, code: MessageCode, payload, dst: int):
        """Apply the first matching :class:`SDCRule` (see its docstring):
        corrupt the inner numeric payload, re-stamp the reliability
        envelope's checksum when there is one, log once per frame
        identity. Returns the (possibly corrupted) payload."""
        from distributed_ml_pytorch_tpu_torch.utils.messaging import (
            _frame_crc,
            _join16,
            _split16,
        )

        arr = np.asarray(payload, np.float32).ravel()
        enveloped = (code == MessageCode.ReliableFrame and arr.size >= 10
                     and bool(np.isfinite(arr[:9]).all()))
        if enveloped:
            inner = int(arr[6])
            body_off = 9  # 9-field envelope incl. the corr id
            # the envelope seq IS the frame identity: retransmits re-derive
            # the same decision/draws instead of rolling fresh ones
            index = _join16(arr[2], arr[3])
        else:
            inner = int(code)
            body_off = 0
            with self._lock:
                key = (self.rank, dst, inner)
                index = self._sdc_counts.get(key, 0)
                self._sdc_counts[key] = index + 1
        rule = self.plan.sdc_for(self.rank, dst, inner, index)
        if rule is None:
            return payload
        lo = body_off + max(0, int(rule.skip))
        n = arr.size - lo
        if n <= 0:
            return payload
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.plan.seed & 0xFFFFFFFF, self.rank, dst, inner,
             index, _SDC_NS]))
        u = rng.uniform(size=3)
        if u[0] >= rule.p:
            return payload
        out = np.array(arr, copy=True)
        if rule.kind == "scale":
            with np.errstate(over="ignore"):
                # huge factors (the compressed-poison schedules use 1e30)
                # overflowing to inf IS the modeled corruption
                out[lo:] *= np.float32(rule.factor)
        elif rule.kind == "nan":
            out[lo + int(u[1] * n) % n] = np.float32(np.nan)
        else:  # bitflip
            bits = out.view(np.uint32)
            bits[lo + int(u[1] * n) % n] ^= np.uint32(1) << np.uint32(
                int(u[2] * 32) % 32)
        if inner == int(MessageCode.CompressedUpdate):
            # the compressed frame carries its OWN body CRC:
            # SDC models corruption in the sender's memory BEFORE the
            # frame was stamped, so the injector must re-stamp it (rules
            # should skip the 12-float head — compress.HEAD_LEN — so the
            # poison lands in the body, not the protocol fields) or the
            # decoder would reject the frame as detectably corrupt and
            # the "silent" corruption would heal itself
            from distributed_ml_pytorch_tpu_torch.utils.compress import (
                restamp_crc,
            )

            restamp_crc(out, body_off)
        if enveloped:
            # re-stamp: the corruption happened "before" the envelope, so
            # the frame must arrive CRC-clean — bit-perfect on the wire,
            # numerically poisonous (only the admission gate can see it)
            inc = _join16(out[0], out[1])
            corr = _join16(out[7], out[8])
            crc = _frame_crc(inc, index, inner, out[9:], corr)
            out[4], out[5] = _split16(crc)
        log_key = (self.rank, dst, inner, index)
        with self._lock:
            first = log_key not in self._sdc_logged
            self._sdc_logged.add(log_key)
        if first:
            self.log.record(self.rank, dst, inner, index, f"sdc-{rule.kind}")
        return out

    def _forward(self, code: MessageCode, payload, dst: int, chan: _Channel,
                 wu: float, i: int) -> None:
        self._transmit(code, payload, dst, wu, i)
        with self._lock:
            held, chan.held = chan.held, None
        if held is not None:
            self._transmit(code, held[0], dst, held[1], held[2])

    def _transmit(self, code: MessageCode, payload, dst: int, wu: float,
                  i: int, log_weather: bool = True) -> None:
        """The physical link: apply any matching weather rule (latency +
        jitter + bandwidth serialization), then hand the frame to the inner
        transport — directly, or through the delay scheduler."""
        w = self.plan.weather_for(self.rank, dst, int(code), i)
        if w is None:
            self.inner.send(code, payload, dst=dst)
            return
        lat = max(0.0, w.latency + w.jitter * wu)
        if log_weather and (w.latency or w.jitter):
            self.log.record(self.rank, dst, int(code), i,
                            f"weather+{int(round(lat * 1000))}ms")
        delay = lat
        if w.bandwidth > 0:
            arr = np.asarray(payload, np.float32)
            xmit = arr.nbytes / float(w.bandwidth)
            with self._lock:
                now = time.monotonic()
                start = max(now, self._link_busy.get(dst, 0.0))
                self._link_busy[dst] = start + xmit
                delay = (start + xmit) - now + lat
        if delay <= 0:
            self.inner.send(code, payload, dst=dst)
            return
        self._schedule_delayed(code, payload, dst, delay)

    # --------------------------------------------------------------- delay
    def _schedule_delayed(self, code, payload, dst: int, delay: float) -> None:
        frame = np.array(payload, dtype=np.float32, copy=True).ravel()
        with self._lock:
            self._delay_seq += 1
            heapq.heappush(
                self._delayed,
                (time.monotonic() + delay, self._delay_seq, int(code), frame, dst),
            )
            if self._delay_thread is None:
                self._delay_thread = threading.Thread(
                    target=self._delay_loop, name="chaos-delay", daemon=True)
                self._delay_thread.start()
        self._delay_wake.set()

    def _delay_loop(self) -> None:
        while not self._closed:
            with self._lock:
                head = self._delayed[0] if self._delayed else None
            now = time.monotonic()
            if head is None:
                self._delay_wake.wait(0.05)
                self._delay_wake.clear()
                continue
            if head[0] > now:
                self._delay_wake.wait(min(0.05, head[0] - now))
                self._delay_wake.clear()
                continue
            with self._lock:
                _at, _seq, code, frame, dst = heapq.heappop(self._delayed)
            try:
                self.inner.send(MessageCode(code), frame, dst=dst)
            except (OSError, ConnectionError, KeyError):
                pass  # the peer died while the frame was in flight

    # ---------------------------------------------------------------- recv
    def recv(self, timeout: Optional[float] = None):
        if self._is_crashed(self.rank):
            # a crashed endpoint hears nothing (bounded: honor the timeout)
            if timeout:
                time.sleep(min(timeout, 0.05))
            return None
        return self.inner.recv(timeout=timeout)

    def close(self) -> None:
        self._closed = True
        self._delay_wake.set()
        # a reorder-held frame whose channel never sent again would turn
        # the logged "reorder-hold" into a silent drop — flush it now so
        # the log's accounting matches what was actually delivered
        with self._lock:
            held = [((src, dst, code), chan.held)
                    for (src, dst, code), chan in self._channels.items()
                    if chan.held is not None]
            for (_src, _dst, _code), _frame in held:
                self._channels[(_src, _dst, _code)].held = None
        for (_src, dst, code), (frame, _wu, _i) in held:
            try:
                # straight to the inner transport: the delay scheduler is
                # shutting down, so weather would strand the frame
                self.inner.send(MessageCode(code), frame, dst=dst)
            except (OSError, ConnectionError, KeyError):
                pass  # the peer is already gone; nothing left to reorder to
        self.inner.close()


def gray_injector(transport) -> Optional[FaultyTransport]:
    """Walk a transport's ``.inner`` wrapper chain (ReliableTransport →
    FaultyTransport → ...) to the :class:`FaultyTransport`, if any — how
    serve loops find their ``gray_stall`` injection point without the
    harness having to thread the wrapper through every constructor."""
    seen = 0
    t = transport
    while t is not None and seen < 8:
        if isinstance(t, FaultyTransport):
            return t
        t = getattr(t, "inner", None)
        seen += 1
    return None
