"""Shared jittered-backoff policy for the retry loops of the wire
(counterpart of the JAX ``utils/backoff.py``, the same policy value for
value).

One policy object fixes the shape of a retry loop once:

- exponential growth ``base * factor**attempt`` capped at ``cap``;
- multiplicative jitter drawn from a SEEDED ``random.Random`` stream, so two
  peers created with different seeds (rank, port, …) desynchronize while a
  single endpoint stays reproducible run to run;
- :meth:`attempts` drives deadline-bounded retry loops (the TCP connect
  poll) without any literal ``time.sleep`` at the call site.

Hard-coded retry constants are how retry storms synchronize: every sender
that timed out together retries together, forever.
"""

from __future__ import annotations

import random
import time
from typing import Iterator, Optional


class Backoff:
    """One retry policy: capped exponential growth with seeded jitter.

    ``delay(attempt)`` is pure given the construction seed — attempt ``k``
    always maps to the same jittered value for one instance, so timing-
    sensitive tests stay deterministic while distinct instances (seeded by
    rank/port) spread their retries apart.
    """

    def __init__(
        self,
        base: float,
        cap: float,
        *,
        factor: float = 2.0,
        jitter: float = 0.25,
        seed: Optional[int] = None,
    ):
        if base <= 0 or cap <= 0:
            raise ValueError(f"base/cap must be positive, got {base}/{cap}")
        if not (0.0 <= jitter < 1.0):
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.base = float(base)
        self.cap = float(cap)
        self.factor = float(factor)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        #: memoized per-attempt jitter factors: attempt k's delay must not
        #: depend on HOW MANY times it was asked for (pure function of k)
        self._factors: list = []

    def _jitter_for(self, attempt: int) -> float:
        while len(self._factors) <= attempt:
            self._factors.append(
                1.0 + self.jitter * (2.0 * self._rng.random() - 1.0))
        return self._factors[attempt]

    def delay(self, attempt: int) -> float:
        """Jittered delay before retry ``attempt`` (0-based)."""
        raw = min(self.base * (self.factor ** max(0, int(attempt))), self.cap)
        return min(raw * self._jitter_for(max(0, int(attempt))), self.cap)

    def sleep(self, attempt: int) -> None:
        time.sleep(self.delay(attempt))

    def attempts(
        self,
        deadline: Optional[float] = None,
        clock=time.monotonic,
    ) -> Iterator[int]:
        """Yield attempt indices, sleeping the policy's delay BETWEEN
        attempts, until ``deadline`` (a ``clock()`` timestamp) passes.

        The first attempt fires immediately; the sleep before attempt
        ``k+1`` is truncated to the time remaining, so the loop wakes once
        more right at the deadline instead of overshooting it — callers
        write ``for attempt in policy.attempts(deadline): try: ...`` with
        no literal sleep constant of their own.
        """
        attempt = 0
        while True:
            yield attempt
            if deadline is not None:
                remaining = deadline - clock()
                if remaining <= 0:
                    return
                time.sleep(min(self.delay(attempt), max(0.0, remaining)))
            else:
                self.sleep(attempt)
            attempt += 1
