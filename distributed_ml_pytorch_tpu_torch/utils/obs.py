"""The flight recorder and correlation ids (counterpart of the JAX
``utils/obs.py``, field for field).

- :class:`SpanRecorder`: a bounded ring of typed spans and instant events
  for one fleet member: monotonic-ns host timestamps, the thread id, a
  plane tag and a **correlation id**, so that one unit of work (a push, an
  MPMD microbatch, a serving request) can be followed across members. It
  exports compact JSONL (the input of ``analysis/timeline.py``, which the
  JAX analyzer reads too) and Chrome-trace JSON (``ui.perfetto.dev``).
- Correlation ids: :func:`next_corr` allocates process-unique 32-bit ids
  (they ride the reliable envelope as two uint16 halves); :func:`set_corr`,
  :func:`current_corr` and :class:`corr_scope` carry the active one in a
  thread-local, so a handler on the receiving thread inherits the id the
  sender stamped.
- :class:`StateClock`: exclusive-state attribution of a serve loop (compute,
  wait-act, wait-grad, wire-blocked, ckpt, idle): its per-state seconds sum
  to the loop's wall time by construction.
- :class:`BoundedEvents`: the coordinator's capped decision log.
- :func:`flight_dump`: every stage death and rollback writes its recorders
  to disk, so an MTTR ships with the timeline that explains it.

Times are the host's clocks only: a span never synchronizes the device
(device time is ``utils/devtime`` and ``utils/devprof``'s). The recorder
reads clocks and thread ids, never an RNG or a payload, and never steers
control flow, so a chaos log is the same byte for byte with it on.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional

__all__ = [
    "BoundedEvents",
    "SpanRecorder",
    "StateClock",
    "corr_scope",
    "current_corr",
    "flight_dump",
    "next_corr",
    "set_corr",
]

#: process-global correlation-id allocator: 32 bits, 0 means "none";
#: ``itertools.count`` is atomic under the interpreter lock
_CORR_COUNTER = itertools.count(1)

_TLS = threading.local()


def next_corr() -> int:
    """A fresh process-unique correlation id (nonzero, wraps at 2^32)."""
    c = next(_CORR_COUNTER) & 0xFFFFFFFF
    return c if c else next(_CORR_COUNTER) & 0xFFFFFFFF


def set_corr(corr: int) -> None:
    """Install ``corr`` as this thread's active correlation id (0 clears).
    ``ReliableTransport`` calls this on every delivery, so handler code
    running on the receiving thread inherits the sender's id."""
    _TLS.corr = int(corr) & 0xFFFFFFFF


def current_corr() -> int:
    """This thread's active correlation id (0 when none)."""
    return getattr(_TLS, "corr", 0)


class corr_scope:
    """``with corr_scope(cid):`` — install a correlation id for a block and
    restore the previous one on exit (nested units of work compose)."""

    __slots__ = ("corr", "_prev")

    def __init__(self, corr: Optional[int] = None):
        self.corr = next_corr() if corr is None else int(corr)

    def __enter__(self) -> int:
        self._prev = current_corr()
        set_corr(self.corr)
        return self.corr

    def __exit__(self, *exc) -> None:
        set_corr(self._prev)


#: span tuple layout inside the ring (kept a plain tuple — cheapest thing
#: the GIL can append): (name, state, t0_ns, t1_ns, tid, corr, meta|None)
_SPAN_FIELDS = ("name", "state", "t0_ns", "t1_ns", "tid", "corr", "meta")


class SpanRecorder:
    """Bounded in-memory flight recorder for ONE fleet member.

    ``member`` names the process/thread-group on a timeline ("stage1",
    "ps0", "driver"); ``plane`` tags which subsystem's vocabulary its
    states use ("mpmd", "ps", "wire", "serving", "coord") — the analyzer
    surfaces unknown planes instead of dropping them. ``capacity`` bounds
    memory: the deque drops the OLDEST spans (a flight recorder keeps the
    most recent window, which is the one that explains a crash);
    ``dropped`` counts what the ring forgot.
    """

    __slots__ = ("member", "plane", "capacity", "enabled", "_ring",
                 "_total", "meta")

    def __init__(self, member: str, plane: str, *, capacity: int = 65536,
                 enabled: bool = True, **meta):
        self.member = str(member)
        self.plane = str(plane)
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._ring: "collections.deque" = collections.deque(
            maxlen=self.capacity)
        self._total = 0
        self.meta = dict(meta)

    # ------------------------------------------------------------ recording
    def record(self, name: str, state: str, t0_ns: int, t1_ns: int,
               corr: Optional[int] = None, meta: Optional[dict] = None,
               ) -> None:
        """Append one finished span. ``corr=None`` adopts the thread's
        active correlation id (the envelope-riding default)."""
        if not self.enabled:
            return
        self._total += 1  # GIL-atomic enough for telemetry; ring is exact
        self._ring.append((
            name, state, int(t0_ns), int(t1_ns),
            threading.get_ident() & 0xFFFFFFFF,
            current_corr() if corr is None else int(corr), meta))

    def event(self, name: str, corr: Optional[int] = None, **meta) -> None:
        """Instant (zero-duration) event."""
        if not self.enabled:
            return
        now = time.monotonic_ns()
        self.record(name, "event", now, now, corr=corr,
                    meta=meta or None)

    def span(self, name: str, state: Optional[str] = None,
             corr: Optional[int] = None, **meta) -> "_SpanCtx":
        """``with recorder.span("apply", state="compute"):`` — times the
        block; records even when the body raises (the crash window is the
        part worth keeping)."""
        return _SpanCtx(self, name, state or name, corr, meta or None)

    # ------------------------------------------------------------ accessors
    @property
    def total(self) -> int:
        """Spans ever recorded (ring drops count against this)."""
        return self._total

    @property
    def dropped(self) -> int:
        return max(0, self._total - len(self._ring))

    def snapshot(self) -> List[dict]:
        """The retained spans as dicts, oldest first (a point-in-time copy;
        safe while other threads keep appending)."""
        out = []
        for row in list(self._ring):
            d = dict(zip(_SPAN_FIELDS, row))
            if d["meta"] is None:
                del d["meta"]
            out.append(d)
        return out

    def clear(self) -> None:
        self._ring.clear()
        self._total = 0

    # ------------------------------------------------------------ exporters
    def header(self) -> dict:
        return {
            "kind": "meta", "member": self.member, "plane": self.plane,
            "capacity": self.capacity, "total": self._total,
            "dropped": self.dropped, **self.meta,
        }

    def dump_jsonl(self, path: str) -> str:
        """Compact JSONL: one ``kind: meta`` header line, then one span per
        line — the merge format ``analysis/timeline.py`` consumes."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as fh:
            fh.write(json.dumps(self.header()) + "\n")
            for span in self.snapshot():
                fh.write(json.dumps(span) + "\n")
        return path

    def chrome_trace(self, path: str) -> str:
        """Chrome-trace JSON (perfetto / chrome://tracing viewable): spans
        as complete ``ph: X`` events, instants as ``ph: i``, one pid per
        member, correlation id in args."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        events = []
        for s in self.snapshot():
            args = {"corr": s["corr"], "state": s["state"],
                    "plane": self.plane}
            if s.get("meta"):
                args.update(s["meta"])
            ev = {
                "name": s["name"], "pid": self.member, "tid": s["tid"],
                "ts": s["t0_ns"] / 1e3, "args": args,
            }
            if s["t1_ns"] > s["t0_ns"]:
                ev["ph"] = "X"
                ev["dur"] = (s["t1_ns"] - s["t0_ns"]) / 1e3
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        with open(path, "w") as fh:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, fh)
        return path


class _SpanCtx:
    __slots__ = ("rec", "name", "state", "corr", "meta", "_t0")

    def __init__(self, rec: SpanRecorder, name: str, state: str,
                 corr: Optional[int], meta: Optional[dict]):
        self.rec = rec
        self.name = name
        self.state = state
        self.corr = corr
        self.meta = meta

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.rec.record(self.name, self.state, self._t0,
                        time.monotonic_ns(), corr=self.corr, meta=self.meta)


# ------------------------------------------------------------- state clock

class StateClock:
    """Exclusive-state wall-clock attribution for one serve loop.

    The loop is in exactly ONE state at any instant; :meth:`set` switches
    states (closing the previous contiguous stretch as a span and
    accumulating its seconds), :meth:`carve` re-attributes a slice of the
    CURRENT stretch to another state (e.g. the blocked portion of a send
    carved out of "compute" into "wire-blocked" — the carved span is
    recorded by whoever measured it, here only the totals move), and
    :meth:`flush` closes the open stretch and emits one ``attribution``
    summary event (state -> seconds). Because states are exclusive and the
    clock never pauses, ``sum(seconds.values())`` equals the wall time
    between construction and flush — attribution sums to 1 by
    construction, which is the analyzer's acceptance bar.

    Single-threaded by design (one serve loop owns it); no lock.
    """

    __slots__ = ("rec", "seconds", "_state", "_t0_ns", "_carved_ns",
                 "min_span_ns", "started_ns")

    def __init__(self, rec: Optional[SpanRecorder], initial: str = "idle",
                 *, min_span_us: float = 50.0):
        self.rec = rec
        self.seconds: Dict[str, float] = {}
        self._state = initial
        self._t0_ns = time.monotonic_ns()
        self.started_ns = self._t0_ns
        self._carved_ns = 0
        #: stretches shorter than this are accumulated but not recorded as
        #: spans — a 0.02 s poll loop flapping idle<->wait would otherwise
        #: fill the ring with noise while the totals stay exact
        self.min_span_ns = int(min_span_us * 1e3)

    @property
    def state(self) -> str:
        return self._state

    def set(self, state: str, corr: Optional[int] = None) -> None:
        if state == self._state:
            return
        self._close(corr)
        self._state = state

    def carve(self, state: str, seconds: float) -> None:
        """Move ``seconds`` of the current open stretch into ``state`` —
        totals only; the carved span itself is recorded at the measuring
        site (the transport's own wire-blocked span)."""
        if seconds <= 0:
            return
        ns = int(seconds * 1e9)
        self._carved_ns += ns
        self.seconds[state] = self.seconds.get(state, 0.0) + seconds

    def _close(self, corr: Optional[int] = None) -> None:
        now = time.monotonic_ns()
        span_ns = max(0, now - self._t0_ns - self._carved_ns)
        self.seconds[self._state] = (
            self.seconds.get(self._state, 0.0) + span_ns / 1e9)
        if self.rec is not None and span_ns >= self.min_span_ns:
            self.rec.record(self._state, self._state, self._t0_ns, now,
                            corr=corr)
        self._t0_ns = now
        self._carved_ns = 0

    def flush(self) -> Dict[str, float]:
        """Close the open stretch and emit the attribution summary event;
        returns the per-state seconds."""
        self._close()
        if self.rec is not None:
            self.rec.event(
                "attribution", corr=0,
                wall_s=(time.monotonic_ns() - self.started_ns) / 1e9,
                **{k: round(v, 6) for k, v in self.seconds.items()})
        return dict(self.seconds)


class BoundedEvents:
    """A decision log as a capped ring with a total counter.

    It takes ``append``, iterates, has ``len`` and a truth value, and
    indexes and slices over the retained window as a list does
    (``events[-20:]``). ``total`` counts every event ever appended and
    ``dropped`` those the ring has forgotten."""

    __slots__ = ("_ring", "total")

    def __init__(self, maxlen: int = 1024, items: Iterable[str] = ()):
        self._ring: "collections.deque" = collections.deque(maxlen=maxlen)
        self.total = 0
        for it in items:
            self.append(it)

    @property
    def maxlen(self) -> int:
        return self._ring.maxlen

    @property
    def dropped(self) -> int:
        return max(0, self.total - len(self._ring))

    def append(self, item: str) -> None:
        self._ring.append(item)
        self.total += 1

    def __iter__(self):
        return iter(list(self._ring))

    def __len__(self) -> int:
        return len(self._ring)

    def __bool__(self) -> bool:
        return bool(self._ring)

    def __getitem__(self, idx):
        return list(self._ring)[idx]

    def __repr__(self) -> str:
        return (f"BoundedEvents(total={self.total}, "
                f"retained={len(self._ring)}, maxlen={self.maxlen})")


def flight_dump(recorders, out_dir: str, reason: str) -> List[str]:
    """Dump one or more recorders' rings to ``out_dir`` as JSONL flight
    files — the automatic black-box write on stage death and rollback.
    File names carry member + reason; an existing file for the same
    (member, reason) is overwritten (the newest window wins). Returns the
    written paths; IO failures are swallowed (a full disk must never turn
    a fault dump into a second fault)."""
    if recorders is None:
        recorders = ()
    elif isinstance(recorders, SpanRecorder):
        recorders = (recorders,)
    paths = []
    safe_reason = "".join(
        c if c.isalnum() or c in "-_" else "-" for c in str(reason))
    for rec in recorders:
        if rec is None:
            continue
        name = "".join(
            c if c.isalnum() or c in "-_" else "-" for c in rec.member)
        path = os.path.join(out_dir, f"flight_{name}_{safe_reason}.jsonl")
        try:
            rec.meta.setdefault("reason", str(reason))
            paths.append(rec.dump_jsonl(path))
        except OSError:
            pass
    return paths
