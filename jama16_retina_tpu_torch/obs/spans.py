"""Timing spans and the train loops' stall attribution (counterpart of
``jama16_retina_tpu/obs/spans.py``).

``span(name)`` times a block into histogram ``name`` (seconds) and, when
the tracer is on, into the timeline as a complete event of the same
name. With the registry and the tracer both off it is a shared no-op.
A span reads the host clock only: it never synchronizes the device, so
on the card it times the enqueue, as the reference's spans time an
asynchronous dispatch.

``StallClock`` splits a log window's wall time into ``input`` (waiting
for the next batch), ``dispatch`` (issuing the step), ``pause`` (eval),
``save`` (checkpoint writes) and ``other``; the five ``*_sec`` fields
the ``train`` records carry sum to ``window_sec``. With a registry each
segment also feeds a ``trainer.<kind>_s`` histogram, and with the tracer
on it lands in the timeline as ``trainer.<kind>``.
"""

from __future__ import annotations

import time

from jama16_retina_tpu_torch.obs import registry as registry_lib
from jama16_retina_tpu_torch.obs import trace as trace_lib


class _Span:
    __slots__ = ("_hist", "_tracer", "_name", "_t0")

    def __init__(self, hist, tracer, name):
        self._hist = hist
        self._tracer = tracer
        self._name = name

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        if self._hist is not None:
            self._hist.observe(t1 - self._t0)
        if self._tracer is not None:
            self._tracer.complete(self._name, self._t0, t1)


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP = _NoopSpan()


def span(name: str, registry: "registry_lib.Registry | None" = None,
         buckets=registry_lib.DEFAULT_BUCKETS,
         tracer: "trace_lib.Tracer | None" = None):
    """Context manager timing its block into histogram ``name`` and, when
    the tracer is on, the timeline."""
    reg = registry if registry is not None else registry_lib.default_registry()
    tr = tracer if tracer is not None else trace_lib.default_tracer()
    reg_on, tr_on = reg.enabled, tr.enabled
    if not reg_on and not tr_on:
        return _NOOP
    return _Span(reg.histogram(name, buckets=buckets) if reg_on else None,
                 tr if tr_on else None, name)


class StallClock:
    """Per-log-window stall attribution shared by the train loops.
    ``add(kind, dt)`` accumulates a segment, ``measure(kind)`` times one,
    ``fields()`` returns the window's fields and starts the next."""

    KINDS = ("input", "dispatch", "pause", "save")

    def __init__(self, registry: "registry_lib.Registry | None" = None,
                 tracer: "trace_lib.Tracer | None" = None):
        self._hists = {}
        if registry is not None:
            self._hists = {
                k: registry.histogram(
                    f"trainer.{k}_s",
                    help="per-segment stall attribution of the train "
                         "loop (input/dispatch/pause/save), cross-"
                         "window quantiles",
                ) for k in self.KINDS
            }
        self._tracer = (tracer if tracer is not None
                        else trace_lib.default_tracer())
        self._trace_names = {k: f"trainer.{k}" for k in self.KINDS}
        self._window_start = time.perf_counter()
        self._acc = dict.fromkeys(self.KINDS, 0.0)

    def add(self, kind: str, dt: float, t0: "float | None" = None) -> None:
        """One measured segment. ``t0`` (its perf_counter start) places
        its trace event exactly; without it the segment ends now."""
        self._acc[kind] += dt
        h = self._hists.get(kind)
        if h is not None:
            h.observe(dt)
        tr = self._tracer
        if tr.enabled:
            t1 = (t0 + dt) if t0 is not None else time.perf_counter()
            tr.complete(self._trace_names[kind], t1 - dt, t1)

    def measure(self, kind: str):
        """``with stalls.measure('input'): batch = next(stream)``"""
        return _StallSegment(self, kind)

    def fields(self) -> dict:
        """The window's attribution, summing to ``window_sec`` (``other``
        is the remainder, rounded after it is taken); resets the
        window."""
        now = time.perf_counter()
        wall = now - self._window_start
        other = max(0.0, wall - sum(self._acc.values()))
        out = {
            "window_sec": round(wall, 4),
            "input_wait_sec": round(self._acc["input"], 4),
            "dispatch_sec": round(self._acc["dispatch"], 4),
            "pause_sec": round(self._acc["pause"], 4),
            "save_sec": round(self._acc["save"], 4),
            "other_sec": round(other, 4),
        }
        self._window_start = now
        self._acc = dict.fromkeys(self.KINDS, 0.0)
        return out


class _StallSegment:
    __slots__ = ("_clock", "_kind", "_t0")

    def __init__(self, clock: StallClock, kind: str):
        self._clock = clock
        self._kind = kind

    def __enter__(self) -> "_StallSegment":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._clock.add(self._kind, time.perf_counter() - self._t0, self._t0)
