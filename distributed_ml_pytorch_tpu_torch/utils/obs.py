"""Request correlation ids and the coordinator's decision log (counterpart
of the JAX ``utils/obs.py``: ``next_corr``, ``set_corr``, ``current_corr``
and :class:`BoundedEvents` only; the flight recorder waits for the
observability plane)."""

from __future__ import annotations

import collections
import itertools
import threading
from typing import Iterable

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
