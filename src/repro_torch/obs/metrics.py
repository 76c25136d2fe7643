"""Process-global metrics registry — counters, gauges, exact histograms.

Handles are cheap and idempotent::

    from repro_torch import obs

    obs.counter("plandb.hit").inc()
    obs.gauge("serve.tok_per_s").set(123.4)
    obs.histogram("serve.request_latency_s").observe(0.017)

``metrics_json()`` serializes the whole registry (histograms as
count/sum/min/max/p50/p99); ``metrics_dump(path)`` writes it
(``launch.serve --metrics-out FILE`` writes one per run).

Histograms store exact values (these are offline/serving-smoke scale, not
per-packet scale), so ``percentile`` matches ``numpy.percentile``'s default
linear interpolation bit-for-bit — asserted in ``tests/test_obs.py``.

With ``REPRO_OBS=0`` the module helpers return one shared do-nothing
handle and never touch the registry, so it stays empty — the no-op
contract ``tests/test_obs.py`` pins.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, Dict, List, Optional


class Counter:
    """Monotone integer count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written float value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Exact-value distribution with numpy-compatible percentiles."""

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return float(sum(self.values))

    def percentile(self, p: float) -> Optional[float]:
        """p-th percentile, numpy default (linear) interpolation; None if
        empty."""
        if not self.values:
            return None
        xs = sorted(self.values)
        if len(xs) == 1:
            return xs[0]
        rank = (p / 100.0) * (len(xs) - 1)
        lo = math.floor(rank)
        hi = min(lo + 1, len(xs) - 1)
        frac = rank - lo
        return xs[lo] + frac * (xs[hi] - xs[lo])

    def summary(self) -> Dict[str, Any]:
        if not self.values:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": min(self.values),
            "max": max(self.values),
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class _Noop:
    """Shared do-nothing handle for every metric kind when obs is off."""

    __slots__ = ()
    name = "noop"
    value = 0
    values: List[float] = []
    count = 0
    sum = 0.0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, p: float) -> Optional[float]:
        return None

    def summary(self) -> Dict[str, Any]:
        return {"count": 0, "sum": 0.0}


_NOOP = _Noop()


class Registry:
    """Name -> metric map; one per process (module-level ``_REGISTRY``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def to_json(self) -> Dict[str, Any]:
        """``{"counters": {...}, "gauges": {...}, "histograms": {...}}``."""
        out: Dict[str, Dict[str, Any]] = {
            "counters": {},
            "gauges": {},
            "histograms": {},
        }
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][name] = m.summary()
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_REGISTRY = Registry()


def registry() -> Registry:
    """The process-global registry (mostly for tests / reports)."""
    return _REGISTRY


def counter(name: str):
    """Counter handle, or the shared no-op when ``REPRO_OBS=0``."""
    from . import enabled

    if not enabled():
        return _NOOP
    return _REGISTRY.counter(name)


def gauge(name: str):
    """Gauge handle, or the shared no-op when ``REPRO_OBS=0``."""
    from . import enabled

    if not enabled():
        return _NOOP
    return _REGISTRY.gauge(name)


def histogram(name: str):
    """Histogram handle, or the shared no-op when ``REPRO_OBS=0``."""
    from . import enabled

    if not enabled():
        return _NOOP
    return _REGISTRY.histogram(name)


def metrics_json() -> Dict[str, Any]:
    return _REGISTRY.to_json()


def metrics_dump(path: str) -> str:
    """Write the registry snapshot as JSON to ``path``; returns the path."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(metrics_json(), f, indent=1, sort_keys=True)
    return path


def metrics_reset() -> None:
    _REGISTRY.reset()
