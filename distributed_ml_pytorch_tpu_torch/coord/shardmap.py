"""Versioned shard maps (counterpart of the JAX ``coord/shardmap.py``): how
the central flat vector splits across the live shard servers.

A :class:`ShardMap` is immutable and versioned: every membership change
that moves shard servers makes the next version, and its consumers (the
workers' ``ShardedAsynchronous`` clients and the shard servers) cut over to
it at a step boundary. Every elastic push, pull reply and speculative
update carries the sender's map version and the absolute ``[lo, hi)`` its
slice was cut for; a receiver applies only traffic cut for the range it
serves now. So two versions that give a server equal-sized ranges at other
offsets cannot mix, while a version bump that left the ranges in place
stays compatible.

Each entry also names the subrange its owner newly acquired in that version
(``fresh_lo``/``fresh_hi``): the server has no values of its own there, and
the first worker to cut over installs its local values for exactly that
subrange (``RangeInstall``; the first install wins).

The map rides the float32 wire as ``ShardMapUpdate``, every integer split
into float32-exact 16-bit halves, byte for byte the JAX package's frame.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from distributed_ml_pytorch_tpu_torch.parallel.sharded_ps import shard_ranges
from distributed_ml_pytorch_tpu_torch.utils.messaging import _join16, _split16


@dataclasses.dataclass(frozen=True)
class ShardEntry:
    """One shard server's assignment in a map version. ``server_id`` is the
    member's rank in the coordinator's world, which a transport factory
    resolves to an endpoint (over TCP: ``port + server_id - 1``)."""

    server_id: int
    lo: int
    hi: int
    fresh_lo: int = 0   # the subrange newly acquired in this version, empty
    fresh_hi: int = 0   # when the owner already held all of [lo, hi)

    @property
    def size(self) -> int:
        return self.hi - self.lo

    @property
    def needs_install(self) -> bool:
        return self.fresh_hi > self.fresh_lo


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """An immutable, versioned assignment of the flat vector to servers."""

    version: int
    n_params: int
    entries: Tuple[ShardEntry, ...] = ()

    def __init__(self, version: int, n_params: int, entries: Sequence[ShardEntry] = ()):
        object.__setattr__(self, "version", int(version))
        object.__setattr__(self, "n_params", int(n_params))
        object.__setattr__(self, "entries", tuple(entries))

    @property
    def ranges(self) -> List[Tuple[int, int]]:
        return [(e.lo, e.hi) for e in self.entries]

    def entry_for(self, server_id: int) -> Optional[ShardEntry]:
        for e in self.entries:
            if e.server_id == server_id:
                return e
        return None

    def encode(self) -> np.ndarray:
        """``[n_entries, version(2), n_params(2)]`` then nine floats an
        entry: ``server_id, lo(2), hi(2), fresh_lo(2), fresh_hi(2)``."""
        head = [float(len(self.entries)), *_split16(self.version), *_split16(self.n_params)]
        body: List[float] = []
        for e in self.entries:
            body += [float(e.server_id), *_split16(e.lo), *_split16(e.hi),
                     *_split16(e.fresh_lo), *_split16(e.fresh_hi)]
        return np.asarray(head + body, np.float32)

    @classmethod
    def decode(cls, payload: np.ndarray) -> "ShardMap":
        if payload.size < 5 or not np.isfinite(payload[:5]).all():
            raise ValueError(f"malformed ShardMap frame (size {payload.size})")
        k = int(payload[0])
        version = _join16(payload[1], payload[2])
        n_params = _join16(payload[3], payload[4])
        if k < 0 or payload.size < 5 + 9 * k:
            raise ValueError(f"ShardMap frame declares {k} entries but carries "
                             f"{payload.size} floats")
        entries = []
        for i in range(k):
            f = payload[5 + 9 * i: 5 + 9 * (i + 1)]
            if not np.isfinite(f).all():
                raise ValueError("non-finite ShardMap entry")
            entries.append(ShardEntry(server_id=int(f[0]), lo=_join16(f[1], f[2]),
                                      hi=_join16(f[3], f[4]), fresh_lo=_join16(f[5], f[6]),
                                      fresh_hi=_join16(f[7], f[8])))
        return cls(version, n_params, entries)


def rebalance(prev: ShardMap, live_server_ids: Sequence[int]) -> ShardMap:
    """The next map version: contiguous near-equal ranges over the live
    servers, sorted by id (so the assignment is a function of the set
    alone), each entry's fresh subrange the part of its new range the
    server did not hold. A range that grows on both flanks (neighbours gone
    on both sides) installs the whole range."""
    ids = sorted(set(int(s) for s in live_server_ids))
    if not ids:
        return ShardMap(prev.version + 1, prev.n_params, ())
    ranges = shard_ranges(prev.n_params, len(ids))
    prev_by_id = {e.server_id: e for e in prev.entries}
    entries = []
    for sid, (lo, hi) in zip(ids, ranges):
        held = prev_by_id.get(sid)
        if held is None:
            fresh = (lo, hi)  # a new server: all of it is new to it
        else:
            o_lo, o_hi = max(lo, held.lo), min(hi, held.hi)
            if o_lo >= o_hi:
                fresh = (lo, hi)  # the range moved entirely
            elif lo < o_lo:
                fresh = (lo, o_lo) if hi == o_hi else (lo, hi)
            elif hi > o_hi:
                fresh = (o_hi, hi)
            else:
                fresh = (0, 0)
        entries.append(ShardEntry(sid, lo, hi, fresh[0], fresh[1]))
    return ShardMap(prev.version + 1, prev.n_params, entries)
