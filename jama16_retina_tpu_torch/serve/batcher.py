"""Dynamic micro-batcher (counterpart of ``jama16_retina_tpu/serve/batcher.py``):
concurrent requests coalesced into engine batches.

  * ``submit(rows)`` is thread-safe and returns a ``Future`` at once;
  * one worker thread drains the queue, closing each window at
    ``max_batch`` rows or ``max_wait_ms`` after the window's first
    request, whichever comes first;
  * the window's rows go to ``infer_fn`` (normally ``ServingEngine.probs``,
    which buckets, pads and chunks) and the result rows are handed back
    to their requests in submission order.

Admission control: with ``shed_queue_depth`` or ``shed_in_flight`` set,
``submit`` raises :class:`Overloaded` before enqueueing once that many
requests wait (or are admitted and unresolved). A request whose
deadline has passed when its window closes fails with
:class:`DeadlineExceeded` before any device work. ``close()`` stops
admission, serves what was queued and resolves every future.

A row's result depends only on the row and the bucket shape it runs at,
never on its co-riders (eval-mode forwards are row-independent); with
one bucket every row runs at one shape, so results do not depend on
arrival order. Pure Python on numpy.

Each request gets a trace id at submit (the submitter's ambient trace
context's, when a router installed one, else a fresh one); its latency
observation carries it as the histogram's exemplar, and with the tracer
on its latency splits into four complete events on one monotonic clock,
``serve.request.{queue_wait,window_fill,device,resolve}``, that sum to
the ``serve.request_latency_s`` observation exactly.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.obs import trace as obs_trace


class Overloaded(RuntimeError):
    """Typed submit-time rejection: the batcher is over its queue-depth
    or in-flight threshold. Raised before the request enqueues."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline had passed when its window closed, so no
    device work was spent on it. Set on the future, never raised on the
    submitting thread."""


def _submit_trace_id() -> str:
    """The request's trace id, taken on the submitting thread: the ambient
    context's (a router's dispatch installs one), else a fresh one."""
    ctx = obs_trace.current_context() or obs_trace.new_context()
    return ctx.trace_id


@dataclass
class _Request:
    rows: np.ndarray
    # Monotonic submit time: the start of the request's latency.
    t_submit: float
    future: Future = field(default_factory=Future)
    trace_id: str = field(default_factory=_submit_trace_id)
    # Monotonic time the worker took it off the queue: the end of its
    # queue wait, the start of its window fill.
    t_pop: float = 0.0
    # Absolute monotonic deadline, or None.
    t_deadline: "float | None" = None


_STOP = object()


def _fail(requests, exc: BaseException) -> None:
    """Set ``exc`` on every unresolved future (a caller may cancel its
    future concurrently)."""
    for w in requests:
        try:
            if not w.future.done():
                w.future.set_exception(exc)
        except InvalidStateError:
            pass


class MicroBatcher:
    """Thread-safe coalescing queue over a row-wise ``infer_fn``.

    ``infer_fn(rows[n, ...]) -> results[n, ...]`` maps row i of its input
    to row i of its output. ``autostart=False`` leaves the worker
    unstarted until ``start()``, so a test can stage a queue first.
    ``row_shape`` / ``row_dtype`` are checked at submit, so a malformed
    request cannot fail its window's co-riders.

    Metrics (``registry=None``: the process registry; ``tracer=None``: the
    process tracer):
    ``serve.batcher.queue_depth`` and ``serve.batcher.in_flight`` gauges,
    ``serve.batcher.window_fill`` (rows / max_batch per window) and
    ``serve.request_latency_s`` (submit to resolved) histograms, and the
    counters ``serve.batcher.{batches,rows,rejected_at_close,
    close_flushed_windows,window_errors}`` and
    ``serve.shed.{queue_depth,in_flight,deadline}``.

    The quality monitor is fed by ``ServingEngine.probs``, not here.
    """

    def __init__(self, infer_fn: Callable[[np.ndarray], np.ndarray],
                 max_batch: int = 64, max_wait_ms: float = 5.0,
                 autostart: bool = True,
                 row_shape: "tuple[int, ...] | None" = None, row_dtype=None,
                 registry: "obs_registry.Registry | None" = None,
                 shed_queue_depth: int = 0,
                 shed_in_flight: int = 0, default_deadline_ms: float = 0.0,
                 tracer: "obs_trace.Tracer | None" = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._infer = infer_fn
        self._row_shape = tuple(row_shape) if row_shape is not None else None
        self._row_dtype = np.dtype(row_dtype) if row_dtype is not None else None
        self.max_batch = int(max_batch)
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        # Plain ints under self._lock, not gauge reads: shedding works
        # with a disabled registry.
        self.shed_queue_depth = int(shed_queue_depth)
        self.shed_in_flight = int(shed_in_flight)
        self.default_deadline_ms = float(default_deadline_ms)
        self._n_queued = 0     # submitted, not yet popped into a window
        self._n_in_flight = 0  # admitted, future not yet resolved
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        reg = (registry if registry is not None
               else obs_registry.default_registry())
        self._tracer = (tracer if tracer is not None
                        else obs_trace.default_tracer())
        self._g_depth = reg.gauge(
            "serve.batcher.queue_depth",
            help="requests waiting to coalesce into a window")
        self._h_fill = reg.histogram(
            "serve.batcher.window_fill",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
            help="rows/max_batch per flushed window")
        self._h_latency = reg.histogram(
            "serve.request_latency_s",
            help="request latency: submit -> future resolved")
        self._c_batches = reg.counter(
            "serve.batcher.batches", help="coalesced windows flushed")
        self._c_rows = reg.counter(
            "serve.batcher.rows", help="request rows flushed through windows")
        self._c_rejected_closed = reg.counter(
            "serve.batcher.rejected_at_close",
            help="submits refused because the batcher was closed")
        self._c_close_flushed = reg.counter(
            "serve.batcher.close_flushed_windows",
            help="windows served during close()")
        self._g_in_flight = reg.gauge(
            "serve.batcher.in_flight",
            help="requests admitted but not yet resolved")
        self._c_window_errors = reg.counter(
            "serve.batcher.window_errors",
            help="windows whose infer_fn raised; only their futures failed")
        self._c_shed_queue = reg.counter(
            "serve.shed.queue_depth",
            help="submits rejected Overloaded at serve.shed_queue_depth")
        self._c_shed_in_flight = reg.counter(
            "serve.shed.in_flight",
            help="submits rejected Overloaded at serve.shed_in_flight")
        self._c_shed_deadline = reg.counter(
            "serve.shed.deadline",
            help="requests failed DeadlineExceeded at window close")
        self._thread = threading.Thread(target=self._loop,
                                        name="retina-serve-batcher",
                                        daemon=True)
        self._started = False
        if autostart:
            self.start()

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    def submit(self, rows: np.ndarray,
               deadline_ms: "float | None" = None) -> Future:
        """Enqueue ``rows`` ([n, ...], n >= 1); the future resolves to the
        results of exactly those rows, in order. ``deadline_ms`` is
        relative (None: ``default_deadline_ms``; <= 0: none). Raises
        :class:`Overloaded`, without enqueueing, over a shedding
        threshold."""
        rows = np.asarray(rows)
        if rows.ndim < 1 or rows.shape[0] == 0:
            raise ValueError(f"submit() wants [n, ...] with n >= 1, got "
                             f"shape {rows.shape}")
        if self._row_shape is not None and rows.shape[1:] != self._row_shape:
            raise ValueError(
                f"submit() rows must be [n, {self._row_shape}], got "
                f"{rows.shape} — rejected at submit so a malformed request "
                "cannot fail its coalesced window's co-riders")
        if self._row_dtype is not None and rows.dtype != self._row_dtype:
            raise ValueError(f"submit() rows must be {self._row_dtype}, got "
                             f"{rows.dtype}")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        with self._lock:
            if self._closed:
                self._c_rejected_closed.inc()
                raise RuntimeError("MicroBatcher is closed")
            if (self.shed_queue_depth > 0
                    and self._n_queued >= self.shed_queue_depth):
                self._c_shed_queue.inc()
                raise Overloaded(
                    f"queue depth {self._n_queued} >= shed threshold "
                    f"{self.shed_queue_depth}; request shed at submit")
            if (self.shed_in_flight > 0
                    and self._n_in_flight >= self.shed_in_flight):
                self._c_shed_in_flight.inc()
                raise Overloaded(
                    f"{self._n_in_flight} requests in flight >= shed "
                    f"threshold {self.shed_in_flight}; request shed at "
                    "submit")
            req = _Request(rows, time.monotonic())
            if deadline_ms and deadline_ms > 0:
                req.t_deadline = req.t_submit + deadline_ms / 1e3
            self._n_queued += 1
            self._n_in_flight += 1
            self._queue.put(req)
            self._g_depth.add(1)
            self._g_in_flight.set(self._n_in_flight)
        return req.future

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            item.t_pop = time.monotonic()
            window = [item]
            rows = item.rows.shape[0]
            deadline = time.monotonic() + self.max_wait_s
            stop_after = False
            while rows < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop_after = True
                    break
                nxt.t_pop = time.monotonic()
                window.append(nxt)
                rows += nxt.rows.shape[0]
            if stop_after:
                # Queued before close(): served, not dropped.
                self._c_close_flushed.inc()
            try:
                self._flush(window)
            except BaseException as e:  # noqa: BLE001 - worker survival
                # _flush fails the window's futures on infer errors; this
                # catches a failure of that handler itself, so no future
                # is stranded and the worker serves the next window.
                self._c_window_errors.inc()
                _fail(window, e)
            if stop_after:
                return

    def _flush(self, window: "list[_Request]") -> None:
        self._g_depth.add(-len(window))
        admitted = window
        with self._lock:
            self._n_queued -= len(window)
        t_flush = time.monotonic()
        expired = [w for w in window
                   if w.t_deadline is not None and t_flush > w.t_deadline]
        if expired:
            window = [w for w in window
                      if w.t_deadline is None or t_flush <= w.t_deadline]
            for w in expired:
                self._c_shed_deadline.inc()
                _fail([w], DeadlineExceeded(
                    f"deadline passed {t_flush - w.t_deadline:.3f}s before "
                    "its window closed; no device work was spent"))
        if not window:
            with self._lock:
                self._n_in_flight -= len(admitted)
                self._g_in_flight.set(self._n_in_flight)
            return
        try:
            for w in window:
                if w.t_pop == 0.0:  # served by close() without a worker
                    w.t_pop = t_flush
            flat = (window[0].rows if len(window) == 1
                    else np.concatenate([w.rows for w in window]))
            out = np.asarray(self._infer(flat))
            if out.shape[0] != flat.shape[0]:
                raise RuntimeError(
                    f"infer_fn returned {out.shape[0]} rows for "
                    f"{flat.shape[0]} inputs — row contract broken")
            t_infer_done = time.monotonic()
            self._c_batches.inc()
            self._c_rows.inc(int(flat.shape[0]))
            self._h_fill.observe(flat.shape[0] / self.max_batch)
            now = time.monotonic()
            tr = self._tracer
            lo = 0
            for w in window:
                hi = lo + w.rows.shape[0]
                try:
                    w.future.set_result(out[lo:hi])
                    # The window's slowest request leaves by its trace id.
                    self._h_latency.observe(now - w.t_submit,
                                            exemplar=w.trace_id)
                    if tr.enabled:
                        # Four segments tiling [t_submit, now) on the
                        # latency's own clock.
                        args = {"trace_id": w.trace_id,
                                "rows": int(w.rows.shape[0])}
                        tr.complete("serve.request.queue_wait",
                                    w.t_submit, w.t_pop, args)
                        tr.complete("serve.request.window_fill",
                                    w.t_pop, t_flush, args)
                        tr.complete("serve.request.device",
                                    t_flush, t_infer_done, args)
                        tr.complete("serve.request.resolve",
                                    t_infer_done, now, args)
                except InvalidStateError:  # cancelled by its caller
                    pass
                lo = hi
        except BaseException as e:  # noqa: BLE001 - futures carry it
            self._c_window_errors.inc()
            _fail(window, e)
        finally:
            with self._lock:
                self._n_in_flight -= len(admitted)
                self._g_in_flight.set(self._n_in_flight)

    def close(self) -> None:
        """Stop accepting requests, serve everything already queued, and
        join the worker."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_STOP)
        if self._started:
            self._thread.join()
            return
        # Never started: serve the queue here so no future hangs.
        pending = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                pending.append(item)
        if pending:
            self._c_close_flushed.inc()
            self._flush(pending)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
