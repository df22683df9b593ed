"""Named Counters, Gauges and fixed-bucket Histograms (counterpart of
``jama16_retina_tpu/obs/registry.py``, the part the quality monitor and
the micro-batcher record into, under the same metric names).

Every op is O(1) under a per-metric lock, and a registry with
``enabled=False`` turns every op into one branch: handles stay valid,
values freeze. Histograms estimate quantiles at snapshot time by linear
interpolation inside the bucket that holds the rank (Prometheus's
``histogram_quantile``); an observation above the last bound clamps to
it. Each histogram also keeps an exemplar: the slowest observation
tagged with an id (a request's trace id) since the last snapshot that
resets it, which only the telemetry flush does.
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
                 "_sum", "_count", "_ex_value", "_ex_id")

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
        # The slowest exemplar-tagged observation since the last
        # resetting snapshot, and its id.
        self._ex_value: "float | None" = None
        self._ex_id = None

    def observe(self, v: float, exemplar=None) -> None:
        if not self._registry.enabled:
            return
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None and (
                    self._ex_value is None or v > self._ex_value):
                self._ex_value = v
                self._ex_id = exemplar

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

    def snapshot(self, reset_exemplar: bool = False) -> dict:
        """{'count', 'sum', 'mean', 'p50', 'p95', 'p99', 'buckets',
        'exemplar'}, the buckets as (upper bound, cumulative count) pairs,
        the exemplar {'value', 'trace_id'} or None. Only the telemetry
        flush passes ``reset_exemplar=True``: its cadence is the
        exemplar's window, and every other reader leaves it in place."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
            quantiles = {f"p{int(q * 100)}": self._quantile_locked(q)
                         for q in (0.5, 0.95, 0.99)}
            exemplar = ({"value": self._ex_value, "trace_id": self._ex_id}
                        if self._ex_value is not None else None)
            if reset_exemplar:
                self._ex_value = None
                self._ex_id = None
        cum, cum_counts = 0, []
        for c in counts[:-1]:
            cum += c
            cum_counts.append(cum)
        return {"count": total, "sum": s,
                "mean": (s / total) if total else None, **quantiles,
                "buckets": list(zip(self.bounds, cum_counts)),
                "exemplar": exemplar}

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


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

    def peek(self, name: str):
        """The registered metric, or None: a read that never creates, so
        looking at another plane's metric cannot register a zero-valued
        one when that plane is not wired."""
        with self._lock:
            return self._metrics.get(name)

    def remove(self, name: str) -> None:
        """Stop exporting ``name`` (a no-op when absent); a handle a caller
        still holds keeps counting, unexported."""
        with self._lock:
            self._metrics.pop(name, None)

    def reset(self) -> None:
        """Zero every metric in place; handles stay valid. A train loop
        resets at its start, so members fit one after another in one
        process do not carry each other's counts."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                if isinstance(m, Histogram):
                    m._counts = [0] * (len(m.bounds) + 1)
                    m._sum = 0.0
                    m._count = 0
                    m._ex_value = None
                    m._ex_id = None
                else:
                    m._value = 0.0

    def snapshot(self, reset_exemplars: bool = False) -> dict:
        """{'counters': {name: v}, 'gauges': {name: v}, 'histograms':
        {name: Histogram.snapshot()}, 'help': {name: text}}, the help map
        holding the non-empty strings only. ``reset_exemplars=True`` is
        the telemetry flush's: it closes every histogram's exemplar
        window."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {},
                     "help": {}}
        for m in metrics:
            if isinstance(m, Counter):
                out["counters"][m.name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.name] = m.value
            else:
                out["histograms"][m.name] = m.snapshot(
                    reset_exemplar=reset_exemplars)
            if m.help:
                out["help"][m.name] = m.help
        return out


_default = Registry()


def default_registry() -> Registry:
    """The process-wide registry every layer records into by default."""
    return _default


def set_default_registry(reg: Registry) -> Registry:
    """Swap the process-wide registry (tests); returns the previous one."""
    global _default
    prev, _default = _default, reg
    return prev
