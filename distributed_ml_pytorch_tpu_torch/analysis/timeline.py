"""Timeline analyzer: merges per-member flight-recorder dumps and says
where the wall clock went (a copy of the JAX ``analysis/timeline.py``; its
report over a directory of dumps equals the JAX analyzer's).

Input: a directory of ``flight_*.jsonl`` dumps written by
``utils/obs.SpanRecorder.dump_jsonl`` or ``flight_dump``: one ``kind:
meta`` header line (member, plane, drop accounting), then one span per
line. Producers: the MPMD stages and driver (``parallel/mpmd.py``), the
coordinator (``coord/coordinator.py``), any ``ReliableTransport`` with a
recorder, the parameter server and the serving engine.

Outputs (one dict; :func:`render` for people, ``--json`` for programs):

- **bubble attribution**: each stage member's fraction of its wall clock
  in each exclusive state (compute, wait-act, wait-grad, wire-blocked,
  ckpt, idle; they sum to about 1 by ``StateClock``'s construction), and
  the stage-seconds aggregate whose ``1 - compute`` is the bench's bubble
  fraction, decomposed;
- **wire attribution**: from each member's last ``wire-stats`` event, the
  retransmit share (retries / sent), ack frames per data frame and the
  seconds sends were blocked at the window;
- **correlation journeys**: spans stitched on the correlation id that rode
  the reliable envelope: how many units of work crossed members, and the
  longest first-touch to last-touch.

Torn or partial lines are tolerated and counted (a dump written during a
crash may lose its tail); unknown plane tags are reported, never dropped; a
member without an ``attribution`` summary falls back to summing its state
spans.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

#: exclusive serve-loop states the analyzer knows how to attribute, per
#: plane tag (``SpanRecorder.plane``). An unfamiliar plane still gets its
#: per-state numbers — it is just listed in ``unknown_planes`` so a new
#: subsystem's dumps are never silently half-read.
KNOWN_PLANES: Dict[str, tuple] = {
    "mpmd": ("compute", "wait-act", "wait-grad", "wire-blocked", "ckpt",
             "idle"),
    "ps": ("apply", "wal", "idle"),
    "serving": ("prefill", "decode", "idle"),
    "wire": ("wire-blocked",),
    "coord": (),
}

#: the states whose summed fraction is "the pipeline is waiting" — the
#: decomposition of the bubble (everything except compute)
MPMD_WAIT_STATES = ("wait-act", "wait-grad", "wire-blocked", "ckpt", "idle")


def load_dump(path: str) -> dict:
    """Parse one JSONL flight dump, tolerating torn lines.

    Returns ``{member, plane, reason, spans, events, torn_lines, meta}``.
    A line that fails to parse (truncated write mid-crash) increments
    ``torn_lines`` and is skipped — a dump is evidence, not a contract.
    A file with no parseable meta header still yields its spans under
    ``member=<filename>`` / ``plane="?"``.
    """
    member = os.path.basename(path)
    plane = "?"
    meta: dict = {}
    spans: List[dict] = []
    events: List[dict] = []
    torn = 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                torn += 1
                continue
            if not isinstance(row, dict):
                torn += 1
                continue
            if row.get("kind") == "meta":
                meta = row
                member = str(row.get("member", member))
                plane = str(row.get("plane", plane))
                continue
            if not {"name", "t0_ns", "t1_ns"} <= set(row):
                torn += 1
                continue
            (events if row.get("state") == "event" else spans).append(row)
    return {
        "path": path, "member": member, "plane": plane,
        "reason": str(meta.get("reason", "")), "meta": meta,
        "spans": spans, "events": events, "torn_lines": torn,
    }


def load_dir(dump_dir: str) -> List[dict]:
    """Every ``*.jsonl`` dump in a directory, sorted by file name."""
    if not os.path.isdir(dump_dir):
        raise FileNotFoundError(f"no such dump directory: {dump_dir}")
    out = []
    for name in sorted(os.listdir(dump_dir)):
        if name.endswith(".jsonl"):
            out.append(load_dump(os.path.join(dump_dir, name)))
    return out


def _member_attribution(dump: dict) -> Optional[dict]:
    """Per-state seconds + fractions for one member dump.

    Prefers the member's own ``attribution`` summary event (the
    StateClock flush: exact, survives ring drops of early spans); falls
    back to summing the retained state spans when none exists (a death
    dump taken before any flush)."""
    attr_events = [e for e in dump["events"] if e["name"] == "attribution"]
    seconds: Dict[str, float] = {}
    wall = 0.0
    if attr_events:
        ev = attr_events[-1]  # the final flush wins
        m = ev.get("meta") or {}
        wall = float(m.get("wall_s", 0.0))
        seconds = {k: float(v) for k, v in m.items()
                   if k != "wall_s" and isinstance(v, (int, float))}
    elif dump["spans"]:
        t0 = min(s["t0_ns"] for s in dump["spans"])
        t1 = max(s["t1_ns"] for s in dump["spans"])
        wall = max(0.0, (t1 - t0) / 1e9)
        for s in dump["spans"]:
            state = str(s.get("state", s["name"]))
            seconds[state] = seconds.get(state, 0.0) \
                + max(0, s["t1_ns"] - s["t0_ns"]) / 1e9
    if wall <= 0.0:
        return None
    known = KNOWN_PLANES.get(dump["plane"], ())
    fractions = {k: v / wall for k, v in seconds.items()}
    return {
        "member": dump["member"],
        "plane": dump["plane"],
        "reason": dump["reason"],
        "wall_s": round(wall, 6),
        "seconds": {k: round(v, 6) for k, v in sorted(seconds.items())},
        "fractions": {k: round(v, 6) for k, v in sorted(fractions.items())},
        #: how much of the wall the named states explain — the acceptance
        #: bar is >= 0.95 per stage on a bench run
        "accounted": round(sum(fractions.values()), 6),
        "unknown_states": sorted(k for k in seconds if known
                                 and k not in known),
    }


def _wire_attribution(dumps: List[dict]) -> dict:
    """Aggregate the members' final ``wire-stats`` events into the wire's
    share of the story: retransmit share, ack frames per data frame, and
    credit-block seconds."""
    totals: Dict[str, float] = {}
    members = 0
    for d in dumps:
        stats_events = [e for e in d["events"] if e["name"] == "wire-stats"]
        if not stats_events:
            continue
        members += 1
        m = stats_events[-1].get("meta") or {}  # teardown emission wins
        for k, v in m.items():
            if isinstance(v, (int, float)):
                totals[k] = totals.get(k, 0.0) + float(v)
    sent = totals.get("sent", 0.0)
    acked = totals.get("acked", 0.0)
    out = {
        "members_reporting": members,
        "sent": int(sent),
        "retries": int(totals.get("retries", 0)),
        "retransmit_share": round(totals.get("retries", 0.0) / sent, 6)
        if sent else 0.0,
        "ack_frames": int(totals.get("acks_tx", 0)
                          + totals.get("cum_acks_tx", 0)),
        "acks_per_data_frame": round(
            (totals.get("acks_tx", 0.0) + totals.get("cum_acks_tx", 0.0))
            / acked, 6) if acked else 0.0,
        "credit_block_s": round(totals.get("window_blocked_s", 0.0), 6),
        "window_blocked_events": int(totals.get("window_blocked", 0)),
        "breaker_opens": int(totals.get("breaker_opens", 0)),
        "crc_dropped": int(totals.get("crc_dropped", 0)),
        "dup_dropped": int(totals.get("dup_dropped", 0)),
    }
    return out


def _journeys(dumps: List[dict], top_n: int = 5) -> dict:
    """Stitch spans/events on correlation ids across members."""
    by_corr: Dict[int, List[tuple]] = {}
    for d in dumps:
        for s in d["spans"] + d["events"]:
            corr = int(s.get("corr", 0))
            if corr:
                by_corr.setdefault(corr, []).append(
                    (d["member"], s["t0_ns"], s["t1_ns"], s["name"]))
    cross = {c: rows for c, rows in by_corr.items()
             if len({m for m, *_ in rows}) > 1}
    longest = sorted(
        ((max(r[2] for r in rows) - min(r[1] for r in rows)) / 1e9, c)
        for c, rows in cross.items())[-top_n:]
    return {
        "correlated_units": len(by_corr),
        "cross_member_units": len(cross),
        "longest": [
            {"corr": c, "duration_s": round(dur, 6),
             "members": sorted({m for m, *_ in cross[c]}),
             "hops": len(cross[c])}
            for dur, c in reversed(longest)
        ],
    }


def analyze(dump_dir: str) -> dict:
    """The whole report over one dump directory (see module docstring)."""
    dumps = load_dir(dump_dir)
    members = []
    unknown_planes = sorted({d["plane"] for d in dumps
                             if d["plane"] not in KNOWN_PLANES})
    torn = sum(d["torn_lines"] for d in dumps)
    dropped = sum(int(d["meta"].get("dropped", 0)) for d in dumps)
    for d in dumps:
        attr = _member_attribution(d)
        if attr is not None:
            members.append(attr)

    # stage-seconds aggregate over the pipeline members: the bench's
    # bubble fraction, decomposed
    stages = [m for m in members if m["plane"] == "mpmd"
              and m["member"].startswith("stage")]
    bubble = None
    if stages:
        wall = sum(m["wall_s"] for m in stages)
        agg: Dict[str, float] = {}
        for m in stages:
            for k, v in m["seconds"].items():
                agg[k] = agg.get(k, 0.0) + v
        fractions = {k: round(v / wall, 6) for k, v in sorted(agg.items())}
        bubble = {
            "stages": len(stages),
            "stage_seconds": round(wall, 6),
            "fractions": fractions,
            "bubble_fraction": round(
                1.0 - fractions.get("compute", 0.0), 6),
            "wait_fraction": round(
                sum(fractions.get(k, 0.0) for k in MPMD_WAIT_STATES), 6),
        }

    return {
        "dump_dir": dump_dir,
        "n_dumps": len(dumps),
        "torn_lines": torn,
        "ring_dropped_spans": dropped,
        "unknown_planes": unknown_planes,
        "members": members,
        "bubble_attribution": bubble,
        "wire_attribution": _wire_attribution(dumps),
        "journeys": _journeys(dumps),
    }


def render(report: dict) -> str:
    """Human-readable rendering of :func:`analyze`'s report."""
    lines = [
        f"timeline: {report['n_dumps']} dump(s) in {report['dump_dir']}"
        + (f", {report['torn_lines']} torn line(s) tolerated"
           if report["torn_lines"] else "")
        + (f", {report['ring_dropped_spans']} span(s) aged out of rings"
           if report["ring_dropped_spans"] else ""),
    ]
    if report["unknown_planes"]:
        lines.append(
            "  WARNING: unknown plane tag(s) "
            f"{report['unknown_planes']} — attributed generically, "
            "teach analysis/timeline.KNOWN_PLANES about them")
    for m in report["members"]:
        fr = ", ".join(f"{k} {v:.1%}" for k, v in m["fractions"].items())
        lines.append(
            f"  {m['member']} [{m['plane']}] wall {m['wall_s']:.3f}s "
            f"(accounted {m['accounted']:.1%}): {fr}")
        if m["unknown_states"]:
            lines.append(
                f"    unknown state(s) for this plane: "
                f"{m['unknown_states']}")
    b = report["bubble_attribution"]
    if b:
        fr = ", ".join(f"{k} {v:.1%}" for k, v in b["fractions"].items())
        lines.append(
            f"  bubble: {b['bubble_fraction']:.1%} of "
            f"{b['stages']}-stage seconds not compute — {fr}")
    w = report["wire_attribution"]
    if w["members_reporting"]:
        lines.append(
            f"  wire: retransmit share {w['retransmit_share']:.2%}, "
            f"{w['acks_per_data_frame']:.2f} ack frames/data frame, "
            f"credit-block {w['credit_block_s']:.3f}s, "
            f"{w['breaker_opens']} breaker open(s)")
    j = report["journeys"]
    lines.append(
        f"  correlation: {j['correlated_units']} unit(s), "
        f"{j['cross_member_units']} crossed members")
    for leg in j["longest"]:
        lines.append(
            f"    corr {leg['corr']}: {leg['duration_s']:.3f}s over "
            f"{len(leg['members'])} member(s) {leg['members']} "
            f"({leg['hops']} span/event(s))")
    return "\n".join(lines)
