"""Request correlation ids (counterpart of the JAX ``utils/obs.py``,
``next_corr``, ``set_corr`` and ``current_corr`` only; the flight recorder
waits for the observability plane)."""

from __future__ import annotations

import itertools
import threading

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
