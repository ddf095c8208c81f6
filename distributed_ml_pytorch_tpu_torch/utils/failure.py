"""Failure detection for the async-PS control plane (counterpart of the JAX
``utils/failure.py``; numpy and threads only).

- :class:`FailureDetector` — per-rank last-seen timestamps with a timeout;
  ``expired()`` reports newly-dead ranks exactly once.
- :class:`HeartbeatSender` — a worker-side daemon sending periodic
  ``MessageCode.Heartbeat`` frames, so liveness does not depend on the
  push/pull cadence.
- :class:`StalenessAuditor` — the server's version stamp and the per-push
  staleness distribution (versions applied since the pusher's last pull).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, Optional, Set

import numpy as np


class FailureDetector:
    """Timeout-based liveness tracking over a set of ranks."""

    def __init__(
        self,
        timeout: float,
        ranks: Iterable[int] = (),
        clock: Callable[[], float] = time.monotonic,
    ):
        if timeout <= 0:
            raise ValueError(f"timeout must be positive, got {timeout}")
        self.timeout = float(timeout)
        self._clock = clock
        now = self._clock()
        self._last_seen: Dict[int, float] = {int(r): now for r in ranks}
        self.failed: Set[int] = set()

    def watch(self, rank: int) -> None:
        """Start tracking a rank (no-op if already tracked or failed)."""
        if rank not in self._last_seen and rank not in self.failed:
            self._last_seen[rank] = self._clock()

    def note(self, rank: int) -> None:
        """Record evidence of life. A failed rank that speaks again rejoins."""
        self.failed.discard(rank)
        self._last_seen[rank] = self._clock()

    def forget(self, rank: int) -> None:
        """Stop tracking a rank (it finished cleanly)."""
        self._last_seen.pop(rank, None)

    def expired(self) -> Set[int]:
        """Ranks newly past the timeout; each is reported exactly once."""
        now = self._clock()
        newly = {r for r, seen in self._last_seen.items() if now - seen > self.timeout}
        for r in newly:
            del self._last_seen[r]
        self.failed |= newly
        return newly

    def alive(self) -> Set[int]:
        return set(self._last_seen)


class HeartbeatSender(threading.Thread):
    """Worker-side daemon: send a Heartbeat frame every ``interval`` seconds.

    A failed send sets :attr:`peer_down`; a later successful one clears it.
    Heartbeats skip the reliable envelope, so over a ``ReliableTransport`` a
    socket that takes the write is no proof of life: there the server's
    circuit breaker (fed by unacked data frames) decides. The thread never
    takes the process down."""

    def __init__(self, transport, interval: float = 1.0):
        super().__init__(daemon=True)
        from distributed_ml_pytorch_tpu_torch.utils.messaging import MessageCode

        self._code = MessageCode.Heartbeat
        self.transport = transport
        self.interval = float(interval)
        self.peer_down = False
        self._stop = threading.Event()

    def run(self) -> None:
        from distributed_ml_pytorch_tpu_torch.utils.messaging import SERVER_RANK

        empty = np.zeros(0, np.float32)
        breaker = getattr(self.transport, "breaker_open", None)
        while not self._stop.wait(self.interval):
            try:
                self.transport.send(self._code, empty)
                self.peer_down = breaker is not None and breaker(SERVER_RANK)
            except (OSError, ConnectionError, KeyError):
                self.peer_down = True

    def stop(self) -> None:
        self._stop.set()


class StalenessAuditor:
    """The server's version (one increment per applied push) and, per worker
    push, how many versions elapsed since that worker last pulled."""

    def __init__(self):
        self.version = 0
        self._pulled_at: Dict[int, int] = {}
        self.per_worker: Dict[int, list] = {}

    def on_pull(self, rank: int) -> None:
        self._pulled_at[rank] = self.version

    def on_push(self, rank: int) -> int:
        staleness = self.version - self._pulled_at.get(rank, 0)
        self.per_worker.setdefault(rank, []).append(staleness)
        self.version += 1
        return staleness

    def summary(self) -> Optional[dict]:
        all_s = sorted(s for v in self.per_worker.values() for s in v)
        if not all_s:
            return None
        n = len(all_s)
        return {
            "pushes": n,
            "versions": self.version,
            "mean": sum(all_s) / n,
            "max": all_s[-1],
            "p50": all_s[n // 2],
        }

    def report(self) -> Optional[str]:
        s = self.summary()
        if s is None:
            return None
        return (
            "gradient staleness over {pushes} pushes: mean {mean:.1f}, "
            "p50 {p50}, max {max} versions".format(**s)
        )
