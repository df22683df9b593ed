"""Named Counters, Gauges and fixed-bucket Histograms (counterpart of
``jama16_retina_tpu/obs/registry.py``, the part the quality monitor and
the micro-batcher record into, under the same metric names).

Every op is O(1) under a per-metric lock, and a registry with
``enabled=False`` turns every op into one branch: handles stay valid,
values freeze. Histograms estimate quantiles at snapshot time by linear
interpolation inside the bucket that holds the rank (Prometheus's
``histogram_quantile``); an observation above the last bound clamps to
it. The reference's exemplars ride its tracer, which is not ported.
"""

from __future__ import annotations

import bisect
import threading
from typing import Iterable

# Default histogram buckets, in seconds: 100 us to 60 s.
DEFAULT_BUCKETS: "tuple[float, ...]" = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "help", "_registry", "_lock", "_value")

    def __init__(self, name: str, registry: "Registry", help: str = ""):
        self.name = name
        self.help = help
        self._registry = registry
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time level."""

    __slots__ = ("name", "help", "_registry", "_lock", "_value")

    def __init__(self, name: str, registry: "Registry", help: str = ""):
        self.name = name
        self.help = help
        self._registry = registry
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value = float(v)

    def add(self, delta: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += delta

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket distribution: ``bounds`` are the finite upper bounds,
    ascending, and an implicit overflow bucket takes the rest."""

    __slots__ = ("name", "help", "_registry", "_lock", "bounds", "_counts",
                 "_sum", "_count")

    def __init__(self, name: str, registry: "Registry",
                 buckets: Iterable[float] = DEFAULT_BUCKETS, help: str = ""):
        self.name = name
        self.help = help
        self._registry = registry
        self._lock = threading.Lock()
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError(f"histogram {name!r} needs >= 1 bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        if not self._registry.enabled:
            return
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def _quantile_locked(self, q: float) -> "float | None":
        if self._count == 0:
            return None
        target = q * self._count
        cum, lo = 0.0, 0.0
        for bound, c in zip(self.bounds, self._counts):
            if c and cum + c >= target:
                return lo + (bound - lo) * (target - cum) / c
            cum += c
            lo = bound
        return self.bounds[-1]

    def snapshot(self) -> dict:
        """{'count', 'sum', 'mean', 'p50', 'p95', 'p99', 'buckets'}, the
        buckets as (upper bound, cumulative count) pairs."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
            quantiles = {f"p{int(q * 100)}": self._quantile_locked(q)
                         for q in (0.5, 0.95, 0.99)}
        cum, cum_counts = 0, []
        for c in counts[:-1]:
            cum += c
            cum_counts.append(cum)
        return {"count": total, "sum": s,
                "mean": (s / total) if total else None, **quantiles,
                "buckets": list(zip(self.bounds, cum_counts))}


class Registry:
    """Named get-or-create metric store. One process-wide default exists
    (``default_registry``); tests and embedded uses pass their own."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: "dict[str, object]" = {}

    def _get_or_create(self, name: str, kind: type, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(name, self, **kwargs)
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name: str, buckets: Iterable[float] = DEFAULT_BUCKETS,
                  help: str = "") -> Histogram:
        return self._get_or_create(name, Histogram, buckets=buckets,
                                   help=help)

    def remove(self, name: str) -> None:
        """Stop exporting ``name`` (a no-op when absent); a handle a caller
        still holds keeps counting, unexported."""
        with self._lock:
            self._metrics.pop(name, None)

    def snapshot(self) -> dict:
        """{'counters': {name: v}, 'gauges': {name: v}, 'histograms':
        {name: Histogram.snapshot()}}."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in metrics:
            if isinstance(m, Counter):
                out["counters"][m.name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.name] = m.value
            else:
                out["histograms"][m.name] = m.snapshot()
        return out


_default = Registry()


def default_registry() -> Registry:
    """The process-wide registry the engine and batcher record into by
    default."""
    return _default
