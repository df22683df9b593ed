"""Event tracing: bounded per-thread ring buffers and Chrome-trace export
(counterpart of ``jama16_retina_tpu/obs/trace.py``).

The registry counts how much and how often; the tracer keeps what the
process did, in order: the timeline the flight recorder dumps and the
critical-path analysis reads.

  * Recording an event is one enabled check, one ``time.perf_counter()``
    and one slot assignment in a ring owned by the recording thread: no
    lock, no I/O, and no device synchronization (a span times the host).
  * ``enabled=False`` makes every record op one branch.
  * Each thread's ring holds at most ``buffer_events`` events, the
    oldest overwritten; readers tolerate a concurrent writer.

Timestamps are ``time.perf_counter()`` seconds (CLOCK_MONOTONIC on
Linux, the clock ``time.monotonic()`` reads, which stamps the serving
request segments). Export gives Chrome trace-event JSON (Perfetto,
chrome://tracing): ``{"traceEvents": [{"name", "ph", "ts" (us), "pid",
"tid", ...}]}``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

# Process-wide id source: unique across engines, batchers and routers, so
# one timeline never aliases two requests.
_ids = itertools.count(1)


class TraceContext:
    """A trace's identity, ``"<origin_pid>-<n>"``, unique across
    processes, serializable to a small dict (``wire``/``from_wire``).
    Events that carry the same ``trace_id`` arg belong to one request."""

    __slots__ = ("trace_id", "parent", "origin_pid")

    def __init__(self, trace_id: "str | None" = None,
                 parent: "str | None" = None,
                 origin_pid: "int | None" = None):
        self.origin_pid = (int(origin_pid) if origin_pid is not None
                           else os.getpid())
        self.trace_id = (str(trace_id) if trace_id is not None
                         else f"{self.origin_pid}-{next(_ids)}")
        self.parent = parent

    def child(self, parent: str) -> "TraceContext":
        """The same trace one level deeper (``parent`` names the span the
        callee's events hang under)."""
        return TraceContext(self.trace_id, parent=parent,
                            origin_pid=self.origin_pid)

    def wire(self) -> dict:
        out = {"trace_id": self.trace_id, "origin_pid": self.origin_pid}
        if self.parent:
            out["parent"] = self.parent
        return out

    @classmethod
    def from_wire(cls, d: "dict | None") -> "TraceContext | None":
        """Inverse of ``wire()``; None for anything without a trace id."""
        if not isinstance(d, dict) or "trace_id" not in d:
            return None
        return cls(trace_id=d["trace_id"], parent=d.get("parent"),
                   origin_pid=d.get("origin_pid"))


def new_context() -> TraceContext:
    return TraceContext()


# The thread's ambient context: a callee several layers down (the
# EscalationPool behind a cascade behind a router replica) stamps the
# request's trace id without a parameter through every layer.
_ctx_local = threading.local()


def current_context() -> "TraceContext | None":
    return getattr(_ctx_local, "ctx", None)


def set_context(ctx: "TraceContext | None") -> "TraceContext | None":
    """Install ``ctx`` as this thread's ambient context; returns the one
    it replaces."""
    prev = getattr(_ctx_local, "ctx", None)
    _ctx_local.ctx = ctx
    return prev


class use_context:
    """``with use_context(ctx): ...``; None installs and restores nothing
    (a bin that carries several requests' rows has no one context)."""

    __slots__ = ("_ctx", "_prev", "_installed")

    def __init__(self, ctx: "TraceContext | None"):
        self._ctx = ctx
        self._installed = False

    def __enter__(self) -> "use_context":
        if self._ctx is not None:
            self._prev = set_context(self._ctx)
            self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            set_context(self._prev)


class _Ring:
    """Fixed-capacity, overwrite-oldest buffer with one writer (its
    thread); any thread may snapshot it. A slot assignment is atomic
    under the interpreter lock, so a reader sees the old event or the
    new one, never a torn one."""

    __slots__ = ("cap", "buf", "n", "tid", "gen")

    def __init__(self, cap: int, tid: int, gen: int):
        self.cap = cap
        self.buf = [None] * cap
        self.n = 0  # events ever appended
        self.tid = tid
        self.gen = gen

    def append(self, ev) -> None:
        self.buf[self.n % self.cap] = ev
        self.n += 1

    def snapshot(self) -> "tuple[list, int]":
        """(events oldest first, events overwritten)."""
        n = self.n
        buf = list(self.buf)
        if n <= self.cap:
            events = [e for e in buf[:n] if e is not None]
        else:
            i = n % self.cap
            events = [e for e in buf[i:] + buf[:i] if e is not None]
        return events, max(0, n - self.cap)


class _NoopTrace:
    __slots__ = ()

    def __enter__(self) -> "_NoopTrace":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP = _NoopTrace()


class _TraceSpan:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_TraceSpan":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.complete(self._name, self._t0, time.perf_counter(),
                              self._args)


class Tracer:
    """Per-thread rings of (ph, name, t0, dur, args) events.

    One process-wide default exists (``default_tracer``); ``configure()``
    re-arms it for a run (the trainer's twin of ``Registry.reset``).
    Rings are keyed by a ring id, not the thread ident (idents are reused
    once a thread exits, and a new thread must not clobber a finished
    one's history); ``MAX_RINGS`` bounds them under thread churn.
    """

    MAX_RINGS = 256

    def __init__(self, enabled: bool = False, buffer_events: int = 4096):
        self.enabled = enabled
        self.buffer_events = max(1, int(buffer_events))
        self._lock = threading.Lock()  # ring registration only
        self._rings: "dict[int, _Ring]" = {}
        self._ring_ids = itertools.count()
        self._local = threading.local()
        # Exported ts are relative to this epoch; epoch_unix is the wall
        # clock at the same moment, for aligning processes' timelines.
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()
        self._gen = 0

    def _ring(self) -> _Ring:
        r = getattr(self._local, "ring", None)
        if r is None or r.gen != self._gen:
            r = _Ring(self.buffer_events, threading.get_ident(), self._gen)
            with self._lock:
                self._rings[next(self._ring_ids)] = r
                while len(self._rings) > self.MAX_RINGS:
                    self._rings.pop(next(iter(self._rings)))
            self._local.ring = r
        return r

    # -- recording --------------------------------------------------------

    def instant(self, name: str, args: "dict | None" = None) -> None:
        if not self.enabled:
            return
        self._ring().append(("i", name, time.perf_counter(), None, args))

    def complete(self, name: str, t0: float, t1: float,
                 args: "dict | None" = None) -> None:
        """One Chrome 'X' event from ``t0`` to ``t1``, perf_counter (or
        monotonic) seconds the caller stamped: so the serving request
        segments sum exactly to the latency the histogram observed."""
        if not self.enabled:
            return
        self._ring().append(("X", name, t0, max(0.0, t1 - t0), args))

    def begin(self, name: str, args: "dict | None" = None) -> None:
        if not self.enabled:
            return
        self._ring().append(("B", name, time.perf_counter(), None, args))

    def end(self, name: str) -> None:
        if not self.enabled:
            return
        self._ring().append(("E", name, time.perf_counter(), None, None))

    def trace(self, name: str, args: "dict | None" = None):
        """Context manager emitting one complete event (disabled: a
        shared no-op)."""
        if not self.enabled:
            return _NOOP
        return _TraceSpan(self, name, args)

    # -- control and export -----------------------------------------------

    def configure(self, enabled: "bool | None" = None,
                  buffer_events: "int | None" = None) -> None:
        """Apply the knobs and clear every ring (its events belong to the
        previous run); threads pick up fresh rings lazily."""
        if enabled is not None:
            self.enabled = bool(enabled)
        if buffer_events is not None:
            self.buffer_events = max(1, int(buffer_events))
        with self._lock:
            self._gen += 1
            self._rings = {}
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()

    def clear(self) -> None:
        self.configure()

    def events(self, last_n: "int | None" = None) -> "list[dict]":
        """Every ring as Chrome event dicts, merged by timestamp, oldest
        first; ``last_n`` keeps the newest N (a blackbox's window)."""
        with self._lock:
            rings = list(self._rings.values())
        pid = os.getpid()
        out = []
        for r in rings:
            events, _ = r.snapshot()
            for ph, name, t0, dur, args in events:
                ev = {"name": name, "ph": ph,
                      "ts": round((t0 - self.epoch) * 1e6, 3),
                      "pid": pid, "tid": r.tid}
                if ph == "X":
                    ev["dur"] = round(dur * 1e6, 3)
                if args:
                    ev["args"] = dict(args)
                out.append(ev)
        out.sort(key=lambda e: e["ts"])
        if last_n is not None and len(out) > last_n:
            out = out[-last_n:]
        return out

    def dropped(self) -> int:
        """Events overwritten since ``configure()``, over all rings."""
        with self._lock:
            rings = list(self._rings.values())
        return sum(r.snapshot()[1] for r in rings)


def chrome_trace(events: list) -> dict:
    """Event dicts in the Chrome trace-event JSON object format."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms"}


def write_chrome_json(path: str, events: list) -> None:
    from jama16_retina_tpu_torch.integrity import artifact as artifact_lib

    artifact_lib.write_json(path, chrome_trace(events), indent=None)


_default = Tracer()


def default_tracer() -> Tracer:
    """The process-wide tracer every layer records into by default."""
    return _default


def set_default_tracer(tr: Tracer) -> Tracer:
    """Swap the process-wide tracer (tests); returns the previous one."""
    global _default
    prev, _default = _default, tr
    return prev
