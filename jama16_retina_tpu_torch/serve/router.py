"""Front-door router (counterpart of ``jama16_retina_tpu/serve/router.py``):
replicas, priority classes and continuous batching over serving engines.

  * A :class:`Router` owns N in-process replicas, each an engine (a
    ``ServingEngine``, a ``CascadeEngine``, or anything with the engine's
    ``probs`` row contract and, optionally, ``probs_with_generation``)
    with its own queue and worker thread, and dispatches request bins to
    them by ``serve.router_policy``: ``least_in_flight`` or
    ``bucket_affinity`` (prefer a replica that already served the bin's
    bucket).
  * Continuous batching: submitted rows wait in a row queue that the
    dispatch tick re-bins across request boundaries. A bin closes as soon
    as a full largest bucket of rows exists; only a partial remainder
    waits out ``serve.max_wait_ms``. A request larger than a bin splits
    across bins, and maybe replicas; its rows come back in order.
  * Priority classes: a request is ``interactive`` or ``batch``.
    Interactive rows bin first, and a batch submit sheds (``Overloaded``)
    at ``router_batch_shed_frac`` of the row threshold interactive sheds
    at. A request whose deadline passes before any of its rows binned
    fails ``DeadlineExceeded`` with no device work spent.
  * Replica lifecycle: a replica whose dispatch raises is marked
    ``FAILED`` and its bins are retried on siblings, so no request fails
    while one live replica remains; every response's ``segments`` name
    the replica and generation that scored each row span. ``drain_replica``
    stops new bins, finishes what the replica holds, then releases it.
  * Autoscaling: the router samples its queue, rows in flight and
    latency into tumbling windows and runs ``scaler.decide`` each window,
    publishing the desired replica count, and acts on it (a new replica
    from ``replica_factory``, or a drain of the newest) when it owns a
    factory.

Cascade-aware routing composes: N student ``CascadeEngine`` replicas
share one :class:`EscalationPool` of full-ensemble engines, which sees
only the escalated (or speculated) rows.

The counters, gauges and histograms take the reference's names and help
strings, on the port's registry. Each request carries a trace context
from submit: a bin of one request's rows installs it as the replica
worker's ambient context (so an escalation below it is stamped with its
trace id), and a bin of several requests' rows names every part in one
``serve.router.bin.parts`` event. The latency histogram's exemplar is
the trace id, and with the tracer on a request's latency splits into
``serve.router.request.{queue_wait,device,resolve}``; each dispatch tick
is a ``serve.router.tick_s`` span. Each bin passes the
``serve.router.dispatch`` fault seam (``obs/faultinject.py``) before its
replica scores it: an injected failure marks the replica failed, and its
bins retry on siblings. Left out with its plane (ROADMAP item 11, part
5): the ``audit`` hook.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np

from jama16_retina_tpu_torch.obs import faultinject
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.obs import trace as obs_trace
from jama16_retina_tpu_torch.obs.spans import span
from jama16_retina_tpu_torch.serve import scaler as scaler_lib
from jama16_retina_tpu_torch.serve.batcher import DeadlineExceeded, Overloaded
from jama16_retina_tpu_torch.serve.engine import resolve_buckets

_log = logging.getLogger(__name__)

PRIORITIES = ("interactive", "batch")
DISPATCH_POLICIES = ("least_in_flight", "bucket_affinity")

# Replica states.
ACTIVE = "active"
DRAINING = "draining"
DRAINED = "drained"
FAILED = "failed"

_STOP = object()


class NoReplicasLeft(RuntimeError):
    """Every replica of a model is failed or drained: its requests fail
    with this, never hang."""


class EscalationPool:
    """A shared pool of full-ensemble engines behind many student
    cascades: it has the cascade's ``ensemble`` contract (``probs`` row by
    row) and sends each escalation batch to the member with the fewest
    rows in flight. Escalated rows count under
    ``serve.router.escalations``.

    A speculating cascade scores its whole batch here before the band is
    known, through ``probs_speculative``: those rows count under
    ``serve.router.speculations``, and the cascade credits the rows the
    band flips through ``note_escalated``, so the escalations counter
    means rows escalated with speculation on or off."""

    def __init__(self, engines,
                 registry: "obs_registry.Registry | None" = None,
                 tracer: "obs_trace.Tracer | None" = None):
        if not engines:
            raise ValueError("EscalationPool needs at least one engine")
        self._engines = list(engines)
        self._in_flight = [0] * len(self._engines)
        self._lock = threading.Lock()
        self._registry = (registry if registry is not None
                          else obs_registry.default_registry())
        self._tracer = (tracer if tracer is not None
                        else obs_trace.default_tracer())
        self._c_rows = self._registry.counter(
            "serve.router.escalations",
            help="rows escalated through the shared full-ensemble pool "
                 "(cascade-aware routing: student replicas everywhere, "
                 "expensive escalations pooled); under speculation "
                 "credited via note_escalated once the band resolves",
        )
        # Registered on the first speculative call, so a pool that never
        # speculates exports no always-zero series.
        self._c_spec_rows = None

    @property
    def generation(self) -> int:
        """The newest member generation (a cascade reports it through
        its ensemble half)."""
        return max(
            int(getattr(e, "generation", 0)) for e in self._engines
        )

    def probs(self, images: np.ndarray) -> np.ndarray:
        return self._probs(images, speculative=False)

    def probs_speculative(self, images: np.ndarray) -> np.ndarray:
        """``probs`` whose rows count as speculations, not escalations;
        credit the rows the band flips with :meth:`note_escalated`."""
        return self._probs(images, speculative=True)

    def note_escalated(self, n: int) -> None:
        """Credit ``n`` speculated rows as escalations."""
        if n > 0:
            self._c_rows.inc(int(n))

    def _probs(self, images: np.ndarray, *, speculative: bool) -> np.ndarray:
        n = int(np.asarray(images).shape[0])
        with self._lock:
            idx = min(
                range(len(self._engines)), key=lambda i: self._in_flight[i]
            )
            # The whole batch is charged either way: the member scores
            # every speculated row, and under-charging would steer other
            # escalations onto it.
            self._in_flight[idx] += n
        # The replica worker's ambient context names the request that pays
        # for the escalation, two layers below its submit.
        ctx = obs_trace.current_context()
        args = {"rows": n, "pool_member": idx}
        if speculative:
            args["speculative"] = True
        if ctx is not None:
            args["trace_id"] = ctx.trace_id
        try:
            with self._tracer.trace("serve.router.escalate", args=args):
                out = self._engines[idx].probs(images)
        finally:
            with self._lock:
                self._in_flight[idx] -= n
        if speculative:
            c = self._c_spec_rows
            if c is None:
                c = self._c_spec_rows = self._registry.counter(
                    "serve.router.speculations",
                    help="rows scored through the shared full-ensemble "
                         "pool speculatively (whole batches, before the "
                         "cascade band is known); the subset the band "
                         "flips is credited to serve.router.escalations "
                         "via note_escalated",
                )
            c.inc(n)
        else:
            self._c_rows.inc(n)
        return out


class _Replica:
    """One in-process replica: an engine, its dispatch queue and worker
    thread, and the accounting the dispatch policy reads. Its counters
    are guarded by the router's lock; it owns only its queue. Each
    replica exports a ``serve.replica{N}.*`` namespace; the newest
    ``Router.REPLICA_ROWS_KEEP`` stay exported."""

    NAMESPACE_METRICS = ("rows", "dispatches", "failures",
                         "in_flight_rows")

    __slots__ = ("rid", "engine", "model", "state", "queue",
                 "in_flight_rows", "rows", "window_rows",
                 "buckets_served", "thread", "c_rows", "c_dispatches",
                 "c_failures", "g_in_flight")

    def __init__(self, rid: int, engine, registry, model: str = "default"):
        self.rid = rid
        self.engine = engine
        self.model = model
        self.state = ACTIVE
        self.queue: "queue.Queue" = queue.Queue()
        self.in_flight_rows = 0   # bins queued or scoring (router lock)
        self.rows = 0             # rows completed, lifetime
        self.window_rows = 0      # rows completed this scaler window
        self.buckets_served: set = set()
        self.thread: "threading.Thread | None" = None
        self.c_rows = registry.counter(
            f"serve.replica{rid}.rows",
            help="rows served by this router replica (per-replica "
                 "ledger; response attribution pairs it with the "
                 "generation id)",
        )
        self.c_dispatches = registry.counter(
            f"serve.replica{rid}.dispatches",
            help="dispatch bins this replica scored",
        )
        self.c_failures = registry.counter(
            f"serve.replica{rid}.failures",
            help="dispatch failures on this replica (nonzero = the "
                 "replica was marked FAILED and its bins moved to "
                 "siblings)",
        )
        self.g_in_flight = registry.gauge(
            f"serve.replica{rid}.in_flight_rows",
            help="rows queued or scoring on this replica right now "
                 "(the least_in_flight policy's per-replica input)",
        )

    def score(self, rows: np.ndarray) -> "tuple[np.ndarray, int]":
        eng = self.engine
        if hasattr(eng, "probs_with_generation"):
            out, gen = eng.probs_with_generation(rows)
            return np.asarray(out), int(gen)
        out = np.asarray(eng.probs(rows))
        return out, int(getattr(eng, "generation", 0))


class _Request:
    """One routed request: its rows, class, deadline, and the state its
    bins complete into."""

    __slots__ = ("rows", "n", "priority", "model", "future", "t_submit",
                 "t_deadline", "ctx", "trace_id", "offset", "parts",
                 "parts_done", "results", "segments", "failed",
                 "t_first_score", "t_done_score")

    def __init__(self, rows: np.ndarray, priority: str,
                 t_deadline: "float | None", model: str = "default"):
        self.rows = rows
        self.n = int(rows.shape[0])
        self.priority = priority
        self.model = model
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.t_deadline = t_deadline
        # Minted at submit; the latency exemplar and every event of the
        # request carry its id.
        self.ctx = obs_trace.new_context()
        self.trace_id = self.ctx.trace_id
        self.offset = 0        # rows binned so far (router lock)
        self.parts = 0         # bins carrying this request's rows
        self.parts_done = 0
        self.results: dict = {}    # request-row offset -> scored rows
        self.segments: list = []   # attribution, in completion order
        self.failed = False
        # Monotonic start of its first bin's scoring, end of its last.
        self.t_first_score: "float | None" = None
        self.t_done_score: "float | None" = None


class _Bin:
    """One dispatch unit: FIFO rows re-binned from one or more requests,
    bound for one replica (``tried``: the replicas it was given, excluded
    from its retries)."""

    __slots__ = ("rows", "parts", "bucket", "tried")

    def __init__(self, rows: np.ndarray, parts: list, bucket: int):
        self.rows = rows
        self.parts = parts  # [(request, req_lo, req_hi), ...]
        self.bucket = bucket
        self.tried: set = set()


class Router:
    """The front door: ``submit()`` rows with a priority class and get a
    Future; replica engines score re-binned bins behind it.

    ``engines``: the initial replicas, a list (one model, named
    "default") or ``{model: engine or list}`` for several tenants, whose
    requests name their model at submit and bin onto that model's
    replicas only; with ``serve.router_fusion`` a bin may mix models
    (``serve/fusion.py``). ``replica_factory(rid) -> engine`` builds more
    replicas: with one, the scaler's decisions are acted on, and with
    ``engines`` None it builds ``serve.router_replicas`` up front. A
    factory serves the single model "default".

    ``serve.policy_from`` is applied by the caller
    (``policy.maybe_apply_policy``) before construction; the router takes
    the resolved config and the provenance for its report.
    """

    # How many per-replica namespaces stay exported while the scaler
    # churns replicas.
    REPLICA_ROWS_KEEP = 8
    # Scaler decisions kept for the report.
    SCALER_LEDGER_KEEP = 256

    def __init__(self, cfg, engines=None, *, replica_factory=None,
                 registry: "obs_registry.Registry | None" = None,
                 policy_provenance: "dict | None" = None):
        sc = cfg.serve
        if sc.router_policy not in DISPATCH_POLICIES:
            raise ValueError(
                f"serve.router_policy must be one of {DISPATCH_POLICIES}, "
                f"got {sc.router_policy!r}"
            )
        if engines is None and replica_factory is None:
            raise ValueError(
                "Router needs engines=[...] and/or a replica_factory"
            )
        if isinstance(engines, dict):
            engines_by_model = {
                str(m): (list(e) if isinstance(e, (list, tuple)) else [e])
                for m, e in engines.items()
            }
            if not engines_by_model or not all(
                    v for v in engines_by_model.values()):
                raise ValueError(
                    "engines dict needs >= 1 engine per model"
                )
            if replica_factory is not None and (
                    len(engines_by_model) > 1
                    or "default" not in engines_by_model):
                raise ValueError(
                    "replica_factory is single-model: use "
                    "engines={'default': [...]} or a plain list with it"
                )
        elif engines is not None:
            engines_by_model = {"default": list(engines)}
        else:
            engines_by_model = None  # the factory builds "default" below
        self.cfg = cfg
        self.dispatch_policy = sc.router_policy
        self._buckets = resolve_buckets(sc)
        self.models = (
            tuple(engines_by_model) if engines_by_model is not None
            else ("default",)
        )
        self.fusion = bool(sc.router_fusion)
        self._fusion_cache = None
        self._c_fused_bins = None
        self._c_fused_rows = None
        self.max_wait_s = max(0.0, float(sc.max_wait_ms)) / 1e3
        self._tick_s = max(5e-4, float(sc.router_tick_ms) / 1e3)
        self.shed_rows = int(sc.router_shed_rows)
        self.batch_shed_frac = float(sc.router_batch_shed_frac)
        if not (0.0 < self.batch_shed_frac <= 1.0):
            raise ValueError(
                "serve.router_batch_shed_frac must be in (0, 1], got "
                f"{self.batch_shed_frac}"
            )
        self.registry = (
            registry if registry is not None
            else obs_registry.default_registry()
        )
        self._policy_provenance = dict(policy_provenance or {})
        self._factory = replica_factory
        self._limits = scaler_lib.ScalerLimits(
            min_replicas=int(sc.scaler_min_replicas),
            max_replicas=int(sc.scaler_max_replicas),
            slo_p99_s=max(0.0, float(sc.scaler_slo_p99_ms)) / 1e3,
        )
        self._scaler_window_s = max(0.05, float(sc.scaler_window_s))

        reg = self.registry
        self._c_req_interactive = reg.counter(
            "serve.router.requests.interactive",
            help="interactive-class requests admitted by the router",
        )
        self._c_req_batch = reg.counter(
            "serve.router.requests.batch",
            help="batch-class requests admitted by the router",
        )
        self._c_rows = reg.counter(
            "serve.router.rows",
            help="request rows admitted by the router (both classes)",
        )
        self._g_queue_rows = reg.gauge(
            "serve.router.queue_rows",
            help="rows admitted but not yet binned to a replica",
        )
        self._g_in_flight_rows = reg.gauge(
            "serve.router.in_flight_rows",
            help="rows binned to replicas but not yet resolved (queued "
                 "+ in-flight is the class-aware shed backlog)",
        )
        self._c_dispatches = reg.counter(
            "serve.router.dispatches",
            help="bins dispatched to replicas (continuous batching: "
                 "re-binned across request boundaries each tick)",
        )
        self._c_rebins = reg.counter(
            "serve.router.rebins",
            help="requests split across more than one dispatch bin "
                 "(continuous batching across bucket boundaries)",
        )
        if self.fusion:
            # Registered only with fusion on, so a router without it
            # exports no always-zero series.
            from jama16_retina_tpu_torch.serve import fusion as fusion_lib

            self._fusion_cache = fusion_lib.FusionCache()
            self._c_fused_bins = reg.counter(
                "serve.router.fused_bins",
                help="dispatch bins that mixed rows from more than one "
                     "model (cross-tenant batch fusion; "
                     "serve.router_fusion)",
            )
            self._c_fused_rows = reg.counter(
                "serve.router.fused_rows",
                help="rows dispatched inside mixed-model bins (each "
                     "demuxed back to its own (model, replica, "
                     "generation) attribution)",
            )
        self._c_retried = reg.counter(
            "serve.router.retried_bins",
            help="bins retried on a sibling after a replica dispatch "
                 "failure (zero-drop contract: typed accounting, the "
                 "request completes elsewhere)",
        )
        self._c_replica_failures = reg.counter(
            "serve.router.replica_failures",
            help="replicas marked failed after a dispatch error; their "
                 "queued bins moved to siblings",
        )
        self._c_request_failures = reg.counter(
            "serve.router.request_failures",
            help="requests failed after every live replica was tried "
                 "(or none remained) — the loud end of the retry path",
        )
        self._c_shed_interactive = reg.counter(
            "serve.router.shed.interactive",
            help="interactive submits rejected Overloaded at the full "
                 "serve.router_shed_rows threshold",
        )
        self._c_shed_batch = reg.counter(
            "serve.router.shed.batch",
            help="batch submits rejected Overloaded at "
                 "router_batch_shed_frac of the row threshold — batch "
                 "sheds first, interactive keeps the headroom",
        )
        self._c_shed_deadline = reg.counter(
            "serve.router.shed.deadline",
            help="requests whose deadline passed before any of their "
                 "rows were binned; failed DeadlineExceeded with no "
                 "device work spent",
        )
        self._c_rejected_closed = reg.counter(
            "serve.router.rejected_at_close",
            help="submits refused because the router was already closed",
        )
        self._g_active = reg.gauge(
            "serve.router.active_replicas",
            help="replicas currently accepting dispatches",
        )
        self._g_draining = reg.gauge(
            "serve.router.draining_replicas",
            help="replicas finishing in-flight work before release",
        )
        self._g_imbalance = reg.gauge(
            "serve.router.imbalance",
            help="per-window max/mean completed-row ratio across active "
                 "replicas (1.0 = perfectly balanced; the "
                 "router_imbalance alert reads this) [fleet:max]",
        )
        self._h_latency = reg.histogram(
            "serve.router.request_latency_s",
            help="routed end-to-end request latency: submit -> future "
                 "resolved (all bins reassembled)",
        )
        # Registered here with its help; the tick loop's span reuses it.
        reg.histogram(
            "serve.router.tick_s",
            help="dispatch-tick duration: deadline sweep + re-binning "
                 "+ replica selection for one tick",
        )
        self._g_desired = reg.gauge(
            "serve.scaler.desired_replicas",
            help="replica count the autoscaling policy wants "
                 "(serve/scaler.py decide(); external autoscalers may "
                 "read this gauge directly)",
        )
        self._g_saturated = reg.gauge(
            "serve.scaler.saturated",
            help="1 while the scaler wants MORE than "
                 "serve.scaler_max_replicas allows (the "
                 "scaler_saturated alert reads this) [fleet:max]",
        )
        self._c_decisions = reg.counter(
            "serve.scaler.decisions",
            help="scaler windows evaluated (every decide() call, "
                 "including holds)",
        )
        self._c_scale_ups = reg.counter(
            "serve.scaler.scale_ups",
            help="scale-up decisions issued by the policy (acted on "
                 "in-process when the router owns a replica factory)",
        )
        self._c_scale_downs = reg.counter(
            "serve.scaler.scale_downs",
            help="scale-down decisions issued by the policy (acted on "
                 "as a graceful replica drain)",
        )

        # One condition guards all of the router's mutable state: the
        # request queues, the row accounting, the replica table and the
        # scaler's window. Workers take it briefly per bin.
        self._work = threading.Condition()
        self._q_interactive: deque = deque()
        self._q_batch: deque = deque()
        self._queued_rows = 0
        self._queued_by_model = {m: 0 for m in self.models}
        self._in_flight_rows = 0
        self._closed = False
        self._replicas: "list[_Replica]" = []
        self._next_rid = 0
        self._scaler_state = scaler_lib.ScalerState()
        self._scaler_t0 = time.monotonic()
        self._scaler_samples: list = []   # (queued_rows, in_flight_rows)
        self._window_lat: list = []       # completed latencies (s)
        self._ledger: deque = deque(maxlen=self.SCALER_LEDGER_KEEP)
        # The row shape and dtype are pinned by the first submit: rows of
        # different requests concatenate into one bin, so a mismatched
        # submit is refused at submit, not inside the tick.
        self._row_shape: "tuple | None" = None
        self._row_dtype = None

        if engines_by_model is None:
            n = max(1, int(sc.router_replicas))
            engines_by_model = {
                "default": [replica_factory(r) for r in range(n)]
            }
        n_engines = 0
        with self._work:
            for model, engs in engines_by_model.items():
                for eng in engs:
                    self._add_replica_locked(eng, model=model)
                    n_engines += 1
        self._g_desired.set(n_engines)

        self._tick_thread = threading.Thread(
            target=self._tick_loop, name="jama16-serve-router", daemon=True
        )
        self._tick_thread.start()

    # -- the replica table (*_locked: the caller holds self._work) ---------

    def _add_replica_locked(self, engine,
                            model: str = "default") -> "_Replica":
        retire = self._next_rid - self.REPLICA_ROWS_KEEP
        if retire >= 0 and not any(
                r.rid == retire and r.state in (ACTIVE, DRAINING)
                for r in self._replicas):
            for metric in _Replica.NAMESPACE_METRICS:
                self.registry.remove(f"serve.replica{retire}.{metric}")
        rep = _Replica(self._next_rid, engine, self.registry, model=model)
        self._next_rid += 1
        self._replicas.append(rep)
        rep.thread = threading.Thread(
            target=self._worker, args=(rep,),
            name=f"jama16-router-replica-{rep.rid}", daemon=True,
        )
        rep.thread.start()
        self._update_replica_gauges_locked()
        return rep

    def _update_replica_gauges_locked(self) -> None:
        self._g_active.set(
            sum(1 for r in self._replicas if r.state == ACTIVE)
        )
        self._g_draining.set(
            sum(1 for r in self._replicas if r.state == DRAINING)
        )

    def _active_locked(self) -> "list[_Replica]":
        return [r for r in self._replicas if r.state == ACTIVE]

    def _maybe_finish_drain_locked(self, rep: "_Replica") -> None:
        """A draining replica with nothing queued or in flight is done:
        its engine (and with it its generations) is released and its
        worker stopped."""
        if (rep.state == DRAINING and rep.in_flight_rows == 0
                and rep.queue.empty()):
            rep.state = DRAINED
            rep.engine = None
            rep.queue.put(_STOP)
            self._update_replica_gauges_locked()
            _log.info("router replica %d drained; engine released", rep.rid)

    # -- admission ---------------------------------------------------------

    def submit(self, rows: np.ndarray, priority: str = "interactive",
               deadline_ms: "float | None" = None,
               model: str = "default") -> Future:
        """Queue ``rows`` ([n, ...], n >= 1) under a priority class. The
        Future resolves to the rows' scores in row order and carries
        ``.segments``, ``[{lo, hi, model, replica, generation}, ...]``,
        naming what scored each row span.

        ``model`` names the tenant whose replicas score the rows (a plain
        engines list is the tenant "default"). Raises ``Overloaded`` at
        the class's row threshold: batch at ``router_batch_shed_frac`` of
        ``serve.router_shed_rows``, interactive at the whole of it.
        ``deadline_ms`` falls back to ``serve.default_deadline_ms``; a
        request expired before any row binned fails
        ``DeadlineExceeded``."""
        rows = np.asarray(rows)
        if rows.ndim < 1 or rows.shape[0] == 0:
            raise ValueError(
                f"submit() wants [n, ...] with n >= 1, got {rows.shape}"
            )
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {priority!r}"
            )
        if model not in self._queued_by_model:
            raise ValueError(
                f"unknown model {model!r}: this router serves "
                f"{self.models} — rejected at submit so a mistargeted "
                "request cannot sit unbinnable in the queue"
            )
        if deadline_ms is None:
            deadline_ms = self.cfg.serve.default_deadline_ms
        n = int(rows.shape[0])
        with self._work:
            if self._closed:
                self._c_rejected_closed.inc()
                raise RuntimeError("Router is closed")
            if self._row_shape is None:
                self._row_shape = rows.shape[1:]
                self._row_dtype = rows.dtype
            elif (rows.shape[1:] != self._row_shape
                  or rows.dtype != self._row_dtype):
                raise ValueError(
                    f"submit() rows must be [n, {self._row_shape}] "
                    f"{self._row_dtype} (pinned by this router's first "
                    f"request), got {rows.shape} {rows.dtype} — "
                    "rejected at submit so a malformed request cannot "
                    "poison the bins it would coalesce into"
                )
            if self.shed_rows > 0:
                threshold = (
                    self.shed_rows if priority == "interactive"
                    else max(1, int(self.shed_rows * self.batch_shed_frac))
                )
                # The backlog is queued plus in flight: the tick moves
                # rows onto replica queues at once, so the queue alone
                # never shows a sustained overload.
                backlog = self._queued_rows + self._in_flight_rows
                if backlog + n > threshold:
                    if priority == "interactive":
                        self._c_shed_interactive.inc()
                    else:
                        self._c_shed_batch.inc()
                    raise Overloaded(
                        f"{backlog} rows queued/in-flight + {n} new > "
                        f"{priority} shed threshold {threshold} "
                        f"(serve.router_shed_rows={self.shed_rows}, "
                        f"batch frac {self.batch_shed_frac:g}); request "
                        "shed at submit"
                    )
            req = _Request(
                rows, priority,
                t_deadline=(time.monotonic() + deadline_ms / 1e3
                            if deadline_ms and deadline_ms > 0 else None),
                model=model,
            )
            (self._q_interactive if priority == "interactive"
             else self._q_batch).append(req)
            self._queued_rows += n
            self._queued_by_model[model] += n
            self._g_queue_rows.set(self._queued_rows)
            (self._c_req_interactive if priority == "interactive"
             else self._c_req_batch).inc()
            self._c_rows.inc(n)
            self._work.notify_all()
        return req.future

    def probs(self, images: np.ndarray,
              priority: str = "interactive") -> np.ndarray:
        """Blocking ``submit(...).result()``."""
        return self.submit(images, priority=priority).result()

    # -- the dispatch tick -------------------------------------------------

    def _tick_loop(self) -> None:
        while True:
            with self._work:
                if self._closed and not self._queued_rows:
                    return
                if not self._queued_rows:
                    self._work.wait(timeout=self._tick_s)
                if self._closed and not self._queued_rows:
                    return
            with span("serve.router.tick_s", self.registry):
                assignments = []
                with self._work:
                    try:
                        self._expire_deadlines_locked(time.monotonic())
                        assignments = self._pack_locked(time.monotonic())
                    except Exception as e:  # noqa: BLE001 - tick survives
                        # A pack failure fails the queued requests and the
                        # loop lives on: a dead tick would hang every
                        # future.
                        _log.exception("router pack failed; failing "
                                       "queued requests")
                        self._fail_all_queued_locked(e)
                    self._scaler_sample_locked()
                    # Enqueued under the lock, so a replica chosen above
                    # cannot fail and drain its queue before its bin lands
                    # there.
                    for rep, b in assignments:
                        rep.queue.put(b)
            try:
                self._maybe_scale()
            except Exception:  # noqa: BLE001 - the tick survives
                _log.exception("router scaler actuation failed (tick loop "
                               "continues)")
            if not assignments:
                # Nothing dispatchable: a partial bin is waiting out its
                # window. Sleep until the oldest waiter's window ends
                # (at most a tick); a submit's notify wakes it sooner.
                with self._work:
                    oldest = None
                    for q in (self._q_interactive, self._q_batch):
                        for req in q:
                            if req.offset < req.n and (
                                    oldest is None
                                    or req.t_submit < oldest):
                                oldest = req.t_submit
                    if oldest is not None:
                        delay = (oldest + self.max_wait_s
                                 - time.monotonic())
                        if delay > 0:
                            self._work.wait(
                                timeout=min(delay, self._tick_s)
                            )

    def _expire_deadlines_locked(self, now: float) -> None:
        """Fail expired requests none of whose rows binned, before any
        device work; a partly binned request completes, late but whole."""
        for q in (self._q_interactive, self._q_batch):
            kept = deque()
            while q:
                req = q.popleft()
                if (req.offset == 0 and req.t_deadline is not None
                        and now > req.t_deadline):
                    self._queued_rows -= req.n
                    self._queued_by_model[req.model] -= req.n
                    self._c_shed_deadline.inc()
                    try:
                        req.future.set_exception(DeadlineExceeded(
                            f"deadline passed {now - req.t_deadline:.3f}s "
                            "before any row was binned; no device work "
                            "was spent"
                        ))
                    except InvalidStateError:
                        pass
                else:
                    kept.append(req)
            q.extend(kept)
        self._g_queue_rows.set(self._queued_rows)

    def _pack_locked(self, now: float) -> list:
        """Re-bin queued rows across request boundaries (interactive
        first), choose each bin's replica and account it in flight;
        returns [(replica, bin), ...]. Without fusion each model packs
        alone; with it all models share one group."""
        if self.fusion or len(self.models) == 1:
            groups = [set(self.models)]
        else:
            groups = [{m} for m in self.models]
        out = []
        for models in groups:
            out.extend(self._pack_group_locked(now, models))
        self._g_queue_rows.set(self._queued_rows)
        self._g_in_flight_rows.set(self._in_flight_rows)
        return out

    def _pack_group_locked(self, now: float, models: set) -> list:
        out = []
        while True:
            # A model whose replicas are all gone fails its requests now;
            # the group's other models pack on.
            live = {r.model for r in self._active_locked()}
            dead = {
                m for m in models
                if self._queued_by_model[m] > 0 and m not in live
            }
            if dead:
                self._fail_all_queued_locked(NoReplicasLeft(
                    "no active replicas to dispatch to "
                    f"(model(s) {sorted(dead)})"
                ), models=dead)
            total = sum(self._queued_by_model[m] for m in models)
            if total <= 0:
                break
            if total >= self._buckets[-1]:
                take = self._buckets[-1]
            else:
                # A partial remainder goes once the oldest unbinned
                # request has waited out max_wait_ms (or at close).
                oldest = None
                for q in (self._q_interactive, self._q_batch):
                    for req in q:
                        if (req.model in models and req.offset < req.n
                                and (oldest is None
                                     or req.t_submit < oldest)):
                            oldest = req.t_submit
                if oldest is None:
                    break
                if not self._closed and now - oldest < self.max_wait_s:
                    break
                take = total
            b = self._make_bin_locked(take, models)
            # The bin is charged to one replica of its first part's model
            # (FIFO: the oldest waiter's); a mixed bin borrows the other
            # models' engines when it is scored.
            primary = b.parts[0][0].model
            reps = [
                r for r in self._active_locked() if r.model == primary
            ]
            rep = self._choose_replica_locked(reps, b)
            b.tried.add(rep.rid)
            rep.in_flight_rows += b.rows.shape[0]
            rep.g_in_flight.set(rep.in_flight_rows)
            self._in_flight_rows += b.rows.shape[0]
            self._c_dispatches.inc()
            if self._c_fused_bins is not None and len(
                    {req.model for req, _lo, _hi in b.parts}) > 1:
                self._c_fused_bins.inc()
                self._c_fused_rows.inc(int(b.rows.shape[0]))
            out.append((rep, b))
        return out

    def _make_bin_locked(self, take: int, models: set) -> "_Bin":
        """Cut ``take`` rows FIFO (the interactive queue first, ``models``
        only) into one bin, splitting a request at its boundary; requests
        binned whole leave their queue."""
        parts = []
        chunks = []
        remaining = take
        for q in (self._q_interactive, self._q_batch):
            if remaining == 0:
                break
            finished = []
            for req in q:
                if remaining == 0:
                    break
                if req.model not in models or req.offset >= req.n:
                    continue
                lo = req.offset
                hi = min(req.n, lo + remaining)
                chunks.append(req.rows[lo:hi])
                parts.append((req, lo, hi))
                req.offset = hi
                req.parts += 1
                if req.parts == 2:  # counted once, at the first split
                    self._c_rebins.inc()
                remaining -= hi - lo
                self._queued_by_model[req.model] -= hi - lo
                if req.offset >= req.n:
                    finished.append(req)
            for r in finished:
                q.remove(r)
        self._queued_rows -= take
        rows = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        bucket = next(
            (bk for bk in self._buckets if bk >= rows.shape[0]),
            self._buckets[-1],
        )
        return _Bin(rows, parts, bucket)

    def _choose_replica_locked(self, reps: "list[_Replica]",
                               b: "_Bin") -> "_Replica":
        if self.dispatch_policy == "bucket_affinity":
            warm = [r for r in reps if b.bucket in r.buckets_served]
            if warm:
                reps = warm
        return min(reps, key=lambda r: (r.in_flight_rows, r.rid))

    def _purge_request_locked(self, req: "_Request") -> None:
        """Drop a failed request's unbinned remainder from the queues (its
        bins still in flight resolve to nothing: ``req.failed``)."""
        for q in (self._q_interactive, self._q_batch):
            if req in q:
                q.remove(req)
                self._queued_rows -= req.n - req.offset
                self._queued_by_model[req.model] -= req.n - req.offset
        self._g_queue_rows.set(self._queued_rows)

    def _fail_all_queued_locked(self, exc: BaseException,
                                models: "set | None" = None) -> None:
        """Fail the queued requests, all of them or only those of
        ``models``."""
        for q in (self._q_interactive, self._q_batch):
            kept = deque()
            while q:
                req = q.popleft()
                if models is not None and req.model not in models:
                    kept.append(req)
                    continue
                self._queued_rows -= req.n - req.offset
                self._queued_by_model[req.model] -= req.n - req.offset
                req.failed = True
                self._c_request_failures.inc()
                try:
                    req.future.set_exception(exc)
                except InvalidStateError:
                    pass
            q.extend(kept)
        self._g_queue_rows.set(self._queued_rows)

    # -- replica workers ---------------------------------------------------

    def _worker(self, rep: "_Replica") -> None:
        while True:
            item = rep.queue.get()
            if item is _STOP:
                return
            b: _Bin = item
            t0 = time.monotonic()
            # A bin of one request's rows makes its context the worker's
            # ambient one (an escalation below is stamped with it); a bin
            # of several has none to claim and names its parts instead.
            ctxs = {id(req): req.ctx for req, _lo, _hi in b.parts}
            bin_ctx = next(iter(ctxs.values())) if len(ctxs) == 1 else None
            try:
                faultinject.check("serve.router.dispatch")
                t_score0 = time.perf_counter()
                with obs_trace.use_context(bin_ctx):
                    out, gens = self._score_bin(rep, b)
                tr = obs_trace.default_tracer()
                if tr.enabled and len(ctxs) > 1:
                    tr.complete(
                        "serve.router.bin.parts", t_score0,
                        time.perf_counter(),
                        args={"replica": rep.rid,
                              "rows": int(b.rows.shape[0]),
                              "parts": [{"trace_id": req.trace_id,
                                         "model": req.model,
                                         "lo": req_lo, "hi": req_hi}
                                        for req, req_lo, req_hi in b.parts]})
                if out.shape[0] != b.rows.shape[0]:
                    raise RuntimeError(
                        f"replica {rep.rid} returned {out.shape[0]} rows "
                        f"for {b.rows.shape[0]} inputs — row contract "
                        "broken"
                    )
            except NoReplicasLeft as e:
                # A borrowed model's replicas are gone, not this one.
                self._fail_bin(rep, b, e)
                continue
            except Exception as e:  # noqa: BLE001 - retried on siblings
                self._on_dispatch_failure(rep, b, e)
                if rep.state == FAILED:
                    return
                continue
            self._complete_bin(rep, b, out, gens, t0)

    def _score_bin(self, rep: "_Replica",
                   b: "_Bin") -> "tuple[np.ndarray, dict]":
        """``(out, {model: generation})`` of one bin. A bin of the
        replica's own model goes through its engine; a mixed bin borrows
        the least-loaded active engine of each other model, under the
        lock, and is scored by ``fusion.score_mixed``. The rows stay
        charged to this replica either way."""
        models = []
        for req, _lo, _hi in b.parts:
            if req.model not in models:
                models.append(req.model)
        if len(models) == 1 and models[0] == rep.model:
            out, gen = rep.score(b.rows)
            return out, {rep.model: gen}
        from jama16_retina_tpu_torch.serve import fusion as fusion_lib

        with self._work:
            engines = {}
            for m in models:
                if m == rep.model and rep.engine is not None:
                    engines[m] = rep.engine
                    continue
                cands = [
                    r for r in self._active_locked()
                    if r.model == m and r.engine is not None
                ]
                if not cands:
                    raise NoReplicasLeft(
                        f"no active replica to borrow an engine for "
                        f"model {m!r}"
                    )
                engines[m] = min(
                    cands, key=lambda r: (r.in_flight_rows, r.rid)
                ).engine
        out, gens = fusion_lib.score_mixed(
            engines, b.rows, b.parts, b.bucket,
            cache=self._fusion_cache,
        )
        return np.asarray(out), gens

    def _fail_bin(self, rep: "_Replica", b: "_Bin",
                  exc: BaseException) -> None:
        """Fail a bin's requests without marking the replica failed (the
        bin could not be served; the carrier is healthy)."""
        n = int(b.rows.shape[0])
        failed = []
        with self._work:
            rep.in_flight_rows -= n
            rep.g_in_flight.set(max(0, rep.in_flight_rows))
            self._in_flight_rows -= n
            self._g_in_flight_rows.set(self._in_flight_rows)
            for req, _lo, _hi in b.parts:
                if req.failed:
                    continue
                req.failed = True
                self._c_request_failures.inc()
                self._purge_request_locked(req)
                failed.append(req)
            self._maybe_finish_drain_locked(rep)
            self._work.notify_all()
        for req in failed:
            try:
                req.future.set_exception(exc)
            except InvalidStateError:
                pass

    def _complete_bin(self, rep: "_Replica", b: "_Bin",
                      out: np.ndarray, gens: dict, t0: float) -> None:
        n = int(b.rows.shape[0])
        done = []
        t_done = time.monotonic()
        with self._work:
            rep.in_flight_rows -= n
            rep.g_in_flight.set(rep.in_flight_rows)
            rep.rows += n
            rep.window_rows += n
            rep.buckets_served.add(b.bucket)
            self._in_flight_rows -= n
            self._g_in_flight_rows.set(self._in_flight_rows)
            lo = 0
            for req, req_lo, req_hi in b.parts:
                seg = out[lo:lo + (req_hi - req_lo)]
                lo += req_hi - req_lo
                req.results[req_lo] = seg
                if req.t_first_score is None or t0 < req.t_first_score:
                    req.t_first_score = t0
                req.segments.append({
                    "lo": req_lo, "hi": req_hi, "model": req.model,
                    "replica": rep.rid,
                    "generation": int(gens[req.model]),
                })
                req.parts_done += 1
                if (req.offset >= req.n and req.parts_done == req.parts
                        and not req.failed):
                    req.t_done_score = t_done
                    done.append(req)
            self._maybe_finish_drain_locked(rep)
            self._work.notify_all()
        rep.c_rows.inc(n)
        rep.c_dispatches.inc()
        now = time.monotonic()
        tr = obs_trace.default_tracer()
        for req in done:
            pieces = [req.results[k] for k in sorted(req.results)]
            result = pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
            req.segments.sort(key=lambda s: s["lo"])
            req.future.segments = req.segments
            try:
                req.future.set_result(result)
                lat = now - req.t_submit
                self._h_latency.observe(lat, exemplar=req.trace_id)
                if tr.enabled:
                    # Three segments tiling [t_submit, now) on the
                    # latency's own clock.
                    args = {"trace_id": req.trace_id, "rows": req.n,
                            "priority": req.priority}
                    tr.complete("serve.router.request.queue_wait",
                                req.t_submit, req.t_first_score, args)
                    tr.complete("serve.router.request.device",
                                req.t_first_score, req.t_done_score, args)
                    tr.complete("serve.router.request.resolve",
                                req.t_done_score, now, args)
                with self._work:
                    self._window_lat.append(lat)
            except InvalidStateError:
                pass

    def _on_dispatch_failure(self, rep: "_Replica", b: "_Bin",
                             exc: BaseException) -> None:
        """A replica failed a dispatch: mark it failed and move its bins
        (this one and all queued behind it) to siblings, so no request
        fails while one live replica remains."""
        moved = [b]
        orphaned_reqs = []
        with self._work:
            if rep.state in (ACTIVE, DRAINING):
                rep.state = FAILED
                self._c_replica_failures.inc()
                rep.c_failures.inc()
                self._update_replica_gauges_locked()
                _log.error(
                    "router replica %d failed dispatching %d rows "
                    "(%s: %s); retrying on siblings",
                    rep.rid, b.rows.shape[0], type(exc).__name__, exc,
                )
            rep.engine = None
            while True:
                try:
                    item = rep.queue.get_nowait()
                except queue.Empty:
                    break
                if item is not _STOP:
                    moved.append(item)
            seen_failed = set()
            for mb in moved:
                n = int(mb.rows.shape[0])
                rep.in_flight_rows -= n
                # A sibling must carry the bin's first model (the other
                # models of a mixed bin are borrowed when it is scored).
                mb_primary = mb.parts[0][0].model
                reps = [
                    r for r in self._active_locked()
                    if r.rid not in mb.tried and r.model == mb_primary
                ]
                if not reps:
                    # Every replica was tried: fail each request it
                    # carries once and drop its unbinned rows.
                    self._in_flight_rows -= n
                    for req, _lo, _hi in mb.parts:
                        if id(req) in seen_failed or req.failed:
                            continue
                        seen_failed.add(id(req))
                        req.failed = True
                        self._c_request_failures.inc()
                        self._purge_request_locked(req)
                        orphaned_reqs.append(req)
                    continue
                target = self._choose_replica_locked(reps, mb)
                mb.tried.add(target.rid)
                target.in_flight_rows += n
                target.g_in_flight.set(target.in_flight_rows)
                self._c_retried.inc()
                # Under the lock, as in the tick: the target must not
                # fail and drain between the choice and the put.
                target.queue.put(mb)
            rep.g_in_flight.set(max(0, rep.in_flight_rows))
            self._g_in_flight_rows.set(self._in_flight_rows)
            self._work.notify_all()
        for req in orphaned_reqs:
            try:
                req.future.set_exception(exc)
            except InvalidStateError:
                pass

    # -- autoscaling -------------------------------------------------------

    def _scaler_sample_locked(self) -> None:
        self._scaler_samples.append(
            (self._queued_rows, self._in_flight_rows)
        )

    def _maybe_scale(self) -> None:
        now = time.monotonic()
        build_engine_for = None
        drain_rid = None
        with self._work:
            window = now - self._scaler_t0
            if window < self._scaler_window_s:
                return
            samples = self._scaler_samples or [(0, 0)]
            lat = sorted(self._window_lat)
            # Nearest-rank p99: the max in a small window, so a breach at
            # low traffic registers.
            p99 = lat[
                min(len(lat) - 1,
                    max(0, int(np.ceil(0.99 * len(lat))) - 1))
            ] if lat else 0.0
            stats = scaler_lib.ScalerStats(
                window_sec=window,
                queue_rows=float(np.mean([s[0] for s in samples])),
                in_flight_rows=float(np.mean([s[1] for s in samples])),
                p99_latency_s=float(p99),
            )
            active = len(self._active_locked())
            decision = scaler_lib.decide(
                stats, active, self.cfg.serve.max_batch,
                self._scaler_state, self._limits,
            )
            self._scaler_state = decision.state
            self._scaler_t0 = now
            self._scaler_samples = []
            self._window_lat = []
            self._c_decisions.inc()
            self._g_desired.set(decision.desired)
            self._g_saturated.set(1.0 if decision.saturated else 0.0)
            window_rows = [
                r.window_rows for r in self._replicas if r.state == ACTIVE
            ]
            mean_rows = float(np.mean(window_rows)) if window_rows else 0.0
            self._g_imbalance.set(
                float(max(window_rows) / mean_rows)
                if mean_rows > 0 else 1.0
            )
            for r in self._replicas:
                r.window_rows = 0
            self._ledger.append({
                "t": time.time(),
                "active": active,
                "desired": decision.desired,
                "reason": decision.reason,
                "queue_rows": round(stats.queue_rows, 1),
                "in_flight_rows": round(stats.in_flight_rows, 1),
                "p99_latency_ms": round(stats.p99_latency_s * 1e3, 2),
            })
            if decision.desired > active:
                self._c_scale_ups.inc()
                if self._factory is not None and not self._closed:
                    build_engine_for = self._next_rid
            elif decision.desired < active:
                self._c_scale_downs.inc()
                if self._factory is not None:
                    # Drain the newest active replica: the oldest are the
                    # warmest.
                    act = self._active_locked()
                    if len(act) > 1:
                        drain_rid = act[-1].rid
        if build_engine_for is not None:
            try:
                engine = self._factory(build_engine_for)
            except Exception:  # noqa: BLE001 - scaling must not kill the tick
                _log.exception("replica factory failed for replica %d",
                               build_engine_for)
                return
            with self._work:
                if not self._closed:
                    self._add_replica_locked(engine)
        elif drain_rid is not None:
            try:
                self.drain_replica(drain_rid)
            except ValueError as e:
                # A replica failed between the decision and the drain and
                # left this one the last active: hold instead.
                _log.info("scale-down skipped: %s", e)

    def drain_replica(self, rid: int) -> None:
        """Graceful drain: the replica takes no new bins, finishes what it
        holds, then releases its engine. Refuses the last active
        replica."""
        with self._work:
            rep = next(
                (r for r in self._replicas if r.rid == rid), None
            )
            if rep is None or rep.state != ACTIVE:
                return
            if len(self._active_locked()) <= 1:
                raise ValueError(
                    "refusing to drain the last active replica — the "
                    "router would have no dispatch target"
                )
            rep.state = DRAINING
            self._update_replica_gauges_locked()
            self._maybe_finish_drain_locked(rep)
            _log.info("router replica %d draining", rid)

    # -- reports and lifecycle ---------------------------------------------

    def replica_states(self) -> list:
        """A snapshot of the replica table."""
        with self._work:
            return [
                {
                    "replica": r.rid, "state": r.state, "model": r.model,
                    "rows": r.rows, "in_flight_rows": r.in_flight_rows,
                    "buckets": sorted(r.buckets_served),
                    "generation": (
                        int(getattr(r.engine, "generation", 0))
                        if r.engine is not None else None
                    ),
                }
                for r in self._replicas
            ]

    def scaler_ledger(self) -> list:
        with self._work:
            return list(self._ledger)

    def report(self) -> dict:
        """The router's report: the replica table, the class and
        shed split, re-binning and retry counts, the scaler's decisions
        and the policy's provenance."""
        return {
            "dispatch_policy": self.dispatch_policy,
            "buckets": [int(b) for b in self._buckets],
            "models": list(self.models),
            "fusion": self.fusion,
            "fused_bins": (
                int(self._c_fused_bins.value)
                if self._c_fused_bins is not None else 0
            ),
            "policy": dict(self._policy_provenance) or None,
            "replicas": self.replica_states(),
            "requests": {
                "interactive": int(self._c_req_interactive.value),
                "batch": int(self._c_req_batch.value),
            },
            "shed": {
                "interactive": int(self._c_shed_interactive.value),
                "batch": int(self._c_shed_batch.value),
                "deadline": int(self._c_shed_deadline.value),
            },
            "rows": int(self._c_rows.value),
            "dispatches": int(self._c_dispatches.value),
            "rebins": int(self._c_rebins.value),
            "retried_bins": int(self._c_retried.value),
            "replica_failures": int(self._c_replica_failures.value),
            # A snapshot read, not counter(): a router without a pool must
            # not register the escalations series through its report.
            "escalations": int(self.registry.snapshot().get(
                "counters", {}
            ).get("serve.router.escalations", 0)),
            "scaler": self.scaler_ledger(),
        }

    def close(self) -> None:
        """Stop admitting, serve everything queued, join the workers."""
        with self._work:
            if self._closed:
                return
            self._closed = True
            self._work.notify_all()
        self._tick_thread.join()
        # The tick exits once the queues are empty. A failure's retry can
        # still move a bin to a sibling, so wait for the last bin to
        # resolve before any worker gets its stop.
        with self._work:
            while self._in_flight_rows > 0:
                self._work.wait(timeout=0.05)
            reps = list(self._replicas)
        for rep in reps:
            rep.queue.put(_STOP)
        for rep in reps:
            if rep.thread is not None:
                rep.thread.join()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
