"""Per-iteration training records and per-rank CSV dumps, the serving SLO
percentiles, the verbose per-class report, and the process's one metrics
registry (counterpart of the JAX ``utils/metrics.py``: ``MetricsLogger``,
``print_eval_line``, ``print_classification_report``, ``percentile``,
``latency_summary``, :class:`Counter`, :class:`Gauge`, :class:`Ewma`,
:class:`EwmaMeanVar` and :class:`Registry` with :func:`get_registry`).

The registry holds owned metrics by name (a counter, a gauge or an EWMA;
a name holds one kind) and *attached providers*: callables returning the
flat ``stats`` dicts the planes already keep, sampled when a snapshot is
taken under their ``prefix.``. ``--metrics-dump`` on the training,
serving and coordinator CLIs writes its snapshot.

The CSV schema is the reference's (``example/main.py:76-105``):
``index, timestamp, iteration, training_loss`` on every row, plus
``test_loss, test_accuracy`` (empty on rows without an eval). Written with
the standard ``csv`` module, in the column order and cell format that
pandas' ``DataFrame.to_csv(index_label="index")`` gives the JAX package.
"""

from __future__ import annotations

import csv
import json
import math
import os
import threading
from datetime import datetime
from typing import Callable, Dict, List, Optional

import numpy as np


def percentile(values, q: float) -> float:
    """Linear-interpolation percentile of a 1-D sample (``q`` in [0, 100]);
    an empty sample or an out-of-range ``q`` raises instead of giving NaN."""
    arr = np.asarray(list(values), np.float64)
    if arr.size == 0:
        raise ValueError("percentile() of an empty sample")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    return float(np.percentile(arr, q))


def latency_summary(values, percentiles=(50, 90, 99)) -> Optional[Dict]:
    """``count``/``mean``/``max`` and the given percentiles (``p50`` …) of a
    latency sample; ``None`` for an empty sample."""
    arr = np.asarray(list(values), np.float64)
    if arr.size == 0:
        return None
    out = {"count": int(arr.size), "mean": float(arr.mean()), "max": float(arr.max())}
    for q in percentiles:
        out[f"p{q:g}"] = percentile(arr, q)
    return out


class MetricsLogger:
    """Accumulates per-iteration log records and dumps one CSV per rank."""

    def __init__(self, log_dir: str = "log"):
        self.log_dir = log_dir
        self.records: List[Dict] = []

    def log_step(self, iteration: int, training_loss: float, **extra) -> Dict:
        rec = {
            "timestamp": datetime.now(),
            "iteration": iteration,
            "training_loss": float(training_loss),
        }
        rec.update(extra)
        self.records.append(rec)
        return rec

    def to_csv(self, filename: str) -> str:
        """Write the records to ``log_dir/filename``; returns the path."""
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, filename)
        columns: List[str] = []
        for rec in self.records:
            columns += [k for k in rec if k not in columns]
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["index", *columns])
            for i, rec in enumerate(self.records):
                w.writerow([i, *("" if rec.get(k) is None else rec[k] for k in columns)])
        return path


def print_eval_line(rec: Dict) -> None:
    """Per-interval telemetry line (reference ``example/main.py:85-89``)."""
    print(
        "Timestamp: {timestamp} | "
        "Iteration: {iteration:6} | "
        "Loss: {training_loss:6.4f} | "
        "Test Loss: {test_loss:6.4f} | "
        "Test Accuracy: {test_accuracy:6.4f}".format(**rec)
    )


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """``num / den`` with 0 where ``den`` is 0 (``zero_division=0``)."""
    out = np.zeros(num.shape, np.float64)
    np.divide(num, den, out=out, where=den != 0)
    return out


def classification_report(y_true, y_pred, target_names, digits: int = 2) -> str:
    """The per-class precision, recall, f1 and support table over labels
    ``0 .. len(target_names) - 1``, with the accuracy, macro and weighted
    average rows, as text equal to scikit-learn's ``classification_report``
    (``zero_division=0``), computed with numpy alone."""
    names = list(target_names)
    n = len(names)
    y_true = np.asarray(y_true).ravel().astype(np.int64)
    y_pred = np.asarray(y_pred).ravel().astype(np.int64)
    labels = np.arange(n)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels], np.float64)
    pred = np.array([np.sum(y_pred == c) for c in labels], np.float64)
    true = np.array([np.sum(y_true == c) for c in labels], np.float64)
    precision, recall = _divide(tp, pred), _divide(tp, true)
    f1 = _divide(2.0 * tp, true + pred)
    headers = ["precision", "recall", "f1-score", "support"]
    width = max(max(len(cn) for cn in names), len("weighted avg"), digits)
    report = ("{:>{width}s} " + " {:>9}" * len(headers)).format("", *headers, width=width)
    report += "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    # scikit-learn's supports are floats when no sample is right at all
    support = (lambda v: float(v)) if tp.sum() == 0 else (lambda v: int(v))
    for i, name in enumerate(names):
        report += row_fmt.format(name, precision[i], recall[i], f1[i], support(true[i]),
                                 width=width, digits=digits)
    report += "\n"
    total = support(true.sum())
    accuracy = float(np.sum(y_true == y_pred)) / y_true.size if y_true.size else 0.0
    report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}" + " {:>9}\n"
               ).format("accuracy", "", "", accuracy, total, width=width, digits=digits)
    weights = true if true.sum() else None
    for heading, w in (("macro avg", None), ("weighted avg", weights)):
        avg = [float(np.average(m, weights=w)) if (w is None or w.sum()) else 0.0
               for m in (precision, recall, f1)]
        report += row_fmt.format(heading, *avg, total, width=width, digits=digits)
    return report


def print_classification_report(y_true: np.ndarray, y_pred: np.ndarray, class_names,
                                test_loss: float, accuracy: float) -> None:
    """Verbose eval report (reference ``example/main.py:128-131``) over the
    full test set, ``y_true`` first (the reference scored only its last
    batch, with the arguments swapped)."""
    print("Loss: {:.3f}".format(test_loss))
    print("Accuracy: {:.3f}".format(accuracy))
    print(classification_report(y_true, y_pred, class_names))


#: the smoothing of the telemetry EWMAs (the JAX package's)
TELEMETRY_ALPHA = 0.3


class Counter:
    """A monotonic event counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> int:
        self.value += int(n)
        return self.value


class Gauge:
    """The last value written."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> float:
        self.value = float(v)
        return self.value


class Ewma:
    """An exponentially weighted mean, as the JAX package's: the first
    sample seeds it (a value of exactly 0.0 reads as unset), then ``value =
    (1 - alpha) * value + alpha * x``, in double precision, so the floats a
    lease renewal carries are the JAX ones."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = TELEMETRY_ALPHA):
        if not 0 < alpha <= 1:
            raise ValueError(f"need 0 < alpha <= 1, got {alpha}")
        self.alpha = float(alpha)
        self.value = 0.0

    def update(self, x: float) -> float:
        x = float(x)
        self.value = (x if self.value == 0.0
                      else (1.0 - self.alpha) * self.value + self.alpha * x)
        return self.value

    def reset(self) -> None:
        self.value = 0.0


class EwmaMeanVar:
    """EWMA mean and variance, an admitted sample optionally winsorized at
    ``winsor`` before it moves the mean (the admission gate's statistics,
    ``utils/health.py``): a ramp of samples each just under the gate's
    threshold must not walk the mean up with it. The caller folds in only
    the samples it admits."""

    __slots__ = ("mean", "var", "count")

    #: the weight of a new sample (the JAX gate's default)
    alpha = 0.2

    def __init__(self):
        self.mean = 0.0
        self.var = 0.0
        self.count = 0

    def sigma(self, floor: float = 0.0) -> float:
        return max(math.sqrt(max(self.var, 0.0)), float(floor))

    def update(self, x: float, winsor: Optional[float] = None) -> None:
        x = float(x)
        if self.count == 0:
            self.mean = x
            self.var = 0.0
        else:
            d = x - self.mean
            if winsor is not None:
                d = max(-winsor, min(winsor, d))
            self.mean += self.alpha * d
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.count += 1


class Registry:
    """One named home for a process's metrics.

    Owned metrics (:meth:`counter`, :meth:`gauge`, :meth:`ewma`) are got or
    made by name; a name holds one kind, and asking it for another (or an
    EWMA with another ``alpha``) raises. :meth:`attach` registers a
    provider, a callable returning a flat dict, sampled at
    :meth:`snapshot` under ``prefix.`` (one that raises is reported as
    ``prefix.error`` instead of failing the dump)."""

    def __init__(self, name: str = ""):
        self.name = str(name)
        self._mu = threading.Lock()
        self._metrics: Dict[str, object] = {}
        self._providers: Dict[str, Callable[[], dict]] = {}

    def _get(self, name: str, cls, factory=None):
        with self._mu:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = (factory or cls)()
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{type(m).__name__}, wanted {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def ewma(self, name: str, alpha: float = TELEMETRY_ALPHA) -> Ewma:
        m = self._get(name, Ewma, factory=lambda: Ewma(alpha))
        if m.alpha != float(alpha):
            raise ValueError(f"ewma {name!r} already registered with alpha={m.alpha}, "
                             f"requested {alpha}")
        return m

    def attach(self, prefix: str, provider: Callable[[], dict]) -> None:
        """Register a provider under ``prefix.``, replacing any earlier one
        of that prefix (a restarted component attaches its new self)."""
        with self._mu:
            self._providers[str(prefix)] = provider

    def detach(self, prefix: str) -> None:
        with self._mu:
            self._providers.pop(str(prefix), None)

    def snapshot(self) -> Dict[str, object]:
        """A flat ``name -> value`` dict over the owned metrics and every
        attached provider, ready for JSON."""
        with self._mu:
            metrics = dict(self._metrics)
            providers = dict(self._providers)
        out: Dict[str, object] = {}
        for name, m in sorted(metrics.items()):
            if isinstance(m, EwmaMeanVar):
                out[name] = {"mean": m.mean, "var": m.var, "count": m.count}
            else:
                out[name] = m.value
        for prefix, provider in sorted(providers.items()):
            try:
                stats = provider()
            except Exception as e:  # noqa: BLE001 — a dump must not die
                out[f"{prefix}.error"] = repr(e)
                continue
            for k, v in sorted(dict(stats).items()):
                out[f"{prefix}.{k}"] = v
        return out

    def dump_json(self, path: Optional[str] = None) -> str:
        """:meth:`snapshot` as JSON text, also written to ``path`` when
        given (the ``--metrics-dump`` file)."""
        text = json.dumps(self.snapshot(), indent=2, sort_keys=True, default=str)
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as fh:
                fh.write(text + "\n")
        return text


_DEFAULT_REGISTRY = Registry("default")


def get_registry() -> Registry:
    """The process's default registry (the one the CLIs dump)."""
    return _DEFAULT_REGISTRY
