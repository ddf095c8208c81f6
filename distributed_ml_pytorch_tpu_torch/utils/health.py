"""The parameter server's gradient admission gate (counterpart of the JAX
``utils/health.py``; numpy only, so both packages reach the same verdicts).

Every ``GradientUpdate`` passes :class:`GradientAdmission` before the server
counts it or logs it:

- **finiteness**: a payload whose norm is NaN or Inf is rejected;
- **norm outlier**: each sender's admitted pushes train an EWMA mean and
  variance of its own ``log1p(norm)`` (``utils/metrics.EwmaMeanVar``);
  after ``warmup`` pushes, one whose z-score exceeds ``z_max`` is rejected.
  The log makes the test scale-free, a floor of :data:`SIGMA_FLOOR` under
  the deviation keeps a quiet sender's tiny variance from flagging ordinary
  drift, and a rejected sample never moves the statistics.

A norm-preserving corruption (a sign flip of the whole update) passes both
checks: the gate is a first line, not the whole of numerical health.

A verdict is ``(reason, norm, z)``; the server sends it to the worker in an
``UpdateNack`` frame, so a reject is never a silent drop.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from distributed_ml_pytorch_tpu_torch.utils.metrics import EwmaMeanVar

#: UpdateNack reason codes (wire values: small integers exact in float32)
NACK_NONFINITE = 1
NACK_NORM_OUTLIER = 2

NACK_REASONS = {
    NACK_NONFINITE: "nonfinite",
    NACK_NORM_OUTLIER: "norm-outlier",
}

#: the least deviation of ``log1p(norm)`` a z-score divides by (the JAX
#: gate's default)
SIGMA_FLOOR = 0.5


def clamp_finite32(x: float) -> float:
    """A value made safe for a float32 wire frame: NaN to 0, an infinity or
    an overflow to float32's extreme (receivers drop frames with nonfinite
    fields, and a norm being rejected is often the infinite one)."""
    return float(np.nan_to_num(np.float32(min(x, 3e38))))


class GradientAdmission:
    """Per-sender finiteness and norm-outlier gate (see the module's text).

    :meth:`evaluate` admits (``None``, the sender's statistics updated) or
    rejects (``(reason, norm, z)``, the statistics untouched). One instance
    per server, called from its serve thread only, so it holds no lock.
    """

    def __init__(self, *, z_max: float = 6.0, warmup: int = 8):
        if z_max <= 0 or warmup < 1:
            raise ValueError(f"need z_max > 0 and warmup >= 1; got z_max={z_max}, "
                             f"warmup={warmup}")
        self.z_max = float(z_max)
        self.warmup = int(warmup)
        self._stats: Dict[int, EwmaMeanVar] = {}
        self.admitted = 0
        self.rejected = 0

    def evaluate(self, sender: int, payload: np.ndarray) -> Optional[Tuple[int, float, float]]:
        """Admit (``None``) or reject (``(reason, norm, z)``) one update."""
        # float64 accumulation: a large but finite update must not overflow
        # its own norm into a reject
        norm = float(np.linalg.norm(payload.astype(np.float64, copy=False)))
        if not math.isfinite(norm):
            self.rejected += 1
            return (NACK_NONFINITE, norm, 0.0)
        x = math.log1p(norm)
        st = self._stats.get(sender)
        if st is None:
            st = self._stats[sender] = EwmaMeanVar()
        z = 0.0
        clamp = None
        if st.count >= self.warmup:
            sigma = st.sigma(SIGMA_FLOOR)
            z = (x - st.mean) / sigma
            if z > self.z_max:
                self.rejected += 1
                return (NACK_NORM_OUTLIER, norm, z)
            # an admitted borderline sample folds in clamped at 2 sigma: a
            # sender whose norms grow by just under z_max a push must not
            # walk the gate up an exponential
            clamp = 2.0 * sigma
        st.update(x, winsor=clamp)
        self.admitted += 1
        return None

    def snapshot(self) -> Dict[int, Tuple[float, float, int]]:
        """``sender -> (mean, var, count)``."""
        return {s: (st.mean, st.var, st.count) for s, st in self._stats.items()}


def admission_from_args(args) -> Optional[GradientAdmission]:
    """``--admission`` (with ``--admission-z`` and ``--admission-warmup``) as
    a gate, or ``None`` when the flag is off. One gate per server: the
    statistics are per (server, sender)."""
    if not getattr(args, "admission", False):
        return None
    return GradientAdmission(z_max=getattr(args, "admission_z", 6.0),
                             warmup=getattr(args, "admission_warmup", 8))
